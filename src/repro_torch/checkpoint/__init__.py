"""Fault-tolerant, sharded checkpoints in the reference's on-disk format."""

"""Batched serving engine over the port's decoder."""

"""Deterministic, resumable token pipelines of the trainer."""

"""Fault injection, retry policy and integrity errors."""

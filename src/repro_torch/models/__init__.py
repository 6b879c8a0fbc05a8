"""Decoder LM for serving: layers, compressed KV cache, model."""

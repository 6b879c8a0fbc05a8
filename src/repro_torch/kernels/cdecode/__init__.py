"""Fused ZFP-decode + flash-decode attention over the compressed KV
cache: plain version (``ref``), CUDA kernel (``kernel``) and the public
wrapper (``ops``)."""

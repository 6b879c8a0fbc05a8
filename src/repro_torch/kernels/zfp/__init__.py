"""Fixed-rate ZFP-style block codec: plain version (``ref``), CUDA
kernels (``kernel``) and the public wrappers (``ops``)."""

"""Mamba-1 selective scan: plain version (``ref``), CUDA kernel
(``kernel``) and the public wrapper (``ops``)."""

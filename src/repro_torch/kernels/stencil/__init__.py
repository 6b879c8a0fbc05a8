"""25-point acoustic stencil: plain version (``ref``), CUDA kernels
(``kernel``) and the public wrappers (``ops``)."""

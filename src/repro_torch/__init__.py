"""PyTorch/CUDA port of the out-of-core stencil system.

Mirrors the subpackages of the JAX package ``repro``: ``kernels/zfp``
(fixed-rate codec), ``kernels/stencil`` (25-point acoustic stencil),
``core`` (block plan, host unit store, synchronous out-of-core engine)
and ``distributed`` (fault injection and integrity errors). The CUDA
kernels live in ``csrc/`` and are built with ``nvcc`` at first use
(``_build.py``). Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

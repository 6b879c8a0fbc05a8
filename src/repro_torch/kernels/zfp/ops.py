"""Public wrappers around the ZFP-style codec.

``backend="ref"`` runs the plain PyTorch version (on whatever device
the tensor lies). ``backend="cuda"`` runs the CUDA kernels (float32 or
float64) and needs CUDA tensors: on a CPU tensor it raises, and it never
falls back to the plain version. Both give bit-identical results.
"""

from __future__ import annotations

from typing import List, Literal, Optional, Sequence, Union

import torch

from repro_torch.device import check_backend
from repro_torch.kernels.zfp import kernel, ref
from repro_torch.kernels.zfp.ref import Compressed

Backend = Literal["ref", "cuda"]

# tile size the TPU kernels padded a block batch to; kept for
# ``bucket_tile`` parity only (the CUDA kernels mask the ragged edge)
DEFAULT_TILE_BLOCKS = 256


def bucket_tile(nb: int) -> int:
    """The TPU kernels' tile size for an ``nb``-block batch: the next
    power of two, capped at ``DEFAULT_TILE_BLOCKS``. Pure function kept
    for parity; no CUDA path pads to it."""
    tile = 1
    while tile < nb and tile < DEFAULT_TILE_BLOCKS:
        tile <<= 1
    return tile


def compress(x: torch.Tensor, *, planes: int, ndim: int = 3,
             backend: Backend = "ref") -> Compressed:
    """Fixed-rate compress the trailing ``ndim`` axes of ``x``."""
    check_backend(backend, x)
    if backend == "cuda":
        payload, emax = kernel.encode(x.contiguous(), planes, ndim)
    else:
        payload, emax = ref.encode_blocks(ref.blockify(x, ndim), planes, ndim)
    return Compressed(payload, emax, tuple(x.shape), planes, ndim,
                      ref.dtype_name(x.dtype))


def decompress(c: Compressed, *, backend: Backend = "ref") -> torch.Tensor:
    check_backend(backend, c.payload, c.emax)
    if backend == "cuda":
        return kernel.decode(c.payload.contiguous(), c.emax.contiguous(),
                             c.shape, c.planes, c.ndim_spatial, c.dtype)
    xb = ref.decode_blocks(c.payload, c.emax, c.planes, c.ndim_spatial,
                           c.dtype)
    return ref.unblockify(xb, c.shape, c.ndim_spatial)


def compress_units(
    xs: Sequence[torch.Tensor],
    *,
    planes: Union[int, Sequence[Optional[int]]],
    ndim: int = 3,
    backend: Backend = "ref",
) -> List[Union[Compressed, torch.Tensor]]:
    """Encode a list of units. ``planes`` is one rate for all, or one
    per unit, where ``None`` passes that unit through raw."""
    if isinstance(planes, int):
        per_unit: List[Optional[int]] = [planes] * len(xs)
    else:
        per_unit = list(planes)
        if len(per_unit) != len(xs):
            raise ValueError(
                f"planes sequence length {len(per_unit)} != {len(xs)} units"
            )
    return [
        x if p is None else compress(x, planes=p, ndim=ndim, backend=backend)
        for x, p in zip(xs, per_unit)
    ]


def decompress_units(cs: Sequence[Compressed], *,
                     backend: Backend = "ref") -> List[torch.Tensor]:
    """Decode a list of units (the counterpart of ``compress_units``)."""
    return [decompress(c, backend=backend) for c in cs]


def quantize(x: torch.Tensor, *, planes: int, ndim: int = 3,
             backend: Backend = "ref") -> torch.Tensor:
    """Numerics of compress->decompress: ``decode(encode(x))`` bit for
    bit. ``"ref"`` runs the plain codec's fused form (no bit packing);
    ``"cuda"`` launches the encode kernel, then the decode kernel on its
    payload."""
    check_backend(backend, x)
    if backend == "cuda":
        x = x.contiguous()
        payload, emax = kernel.encode(x, planes, ndim)
        return kernel.decode(payload, emax, x.shape, planes, ndim,
                             ref.dtype_name(x.dtype))
    return ref.quantize(x, planes, ndim)


def compressed_nbytes(c: Compressed) -> int:
    return c.nbytes()

"""Wrappers of the CUDA codec kernels in ``csrc/zfp.cu``.

``encode`` replaces ``repro.kernels.zfp.kernel.encode_pallas`` and
``decode`` replaces ``decode_pallas``. Unlike the TPU kernels they take
the unit itself, ``(..., s1..s_ndim)``: blockify, its edge padding and
unblockify's crop are folded into the kernels' indexing, so there is no
tile padding (``ops.bucket_tile`` stays only for parity). Both kernels
are compiled for the two stream orders that ``ref.level_order`` yields;
``stream_order`` picks one per launch, and each C entry refuses a launch
whose tables are not in that order.

On a CPU tensor each wrapper runs the plain version (``ref``); on a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches, one per call that reaches the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels.zfp import ref

launches = {"encode": 0, "decode": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# both entries take the stream order (``stream_order``) before the stream
_ARGS = {
    sym: [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P, _I, _I,
          _I, _P]
    for sym in ("zfp_encode", "zfp_decode")
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def stream_order(planes: int, ndim: int) -> int:
    """The stream order the codec kernels are compiled for at ``planes``
    and ``ndim``: 1 for the subband order (coefficients by level, then by
    index), where ``ref.subband_planes`` gives the levels different plane
    counts (4 <= planes <= 27 at ndim 2 and 3); 0 for the identity
    elsewhere, and always at ndim 1, where the two orders are one."""
    return int(ndim > 1 and 4 <= planes <= ref._WIDTH - 5)


def order_perm(order: int, ndim: int) -> Tuple[int, ...]:
    """Stream position -> coefficient of ``order`` (``stream_order``), as
    ``csrc/zfp_common.cuh``'s ``stream_pos`` lays it out."""
    n = ref.block_size(ndim)
    if not order:
        return tuple(range(n))
    return tuple(sorted(range(n), key=lambda i: (ref.coeff_levels(ndim)[i], i)))


@functools.lru_cache(maxsize=None)
def _tables(planes: int, ndim: int):
    """Host-side static tables of one (planes, ndim): keep-masks,
    stream order, plane prefix counts, and the payload word count."""
    perm, _, counts = ref.level_order(planes, ndim, 32)
    masks = np.asarray(ref.plane_masks(planes, ndim, 32), np.uint32)
    return (masks, np.asarray(perm, np.int32), np.asarray(counts, np.int32),
            len(counts), ref.payload_words(ndim, planes))


def _geometry(shape: Tuple[int, ...], ndim: int):
    if ndim not in (1, 2, 3) or len(shape) < ndim:
        raise ValueError(f"ndim={ndim} does not fit a tensor of shape {shape}")
    spatial = (1,) * (3 - ndim) + tuple(shape[-ndim:])
    batch = math.prod(shape[: len(shape) - ndim])
    nb = batch * math.prod(-(-s // 4) for s in shape[-ndim:])
    return batch, spatial, nb


def _launch(symbol: str, a, b, c, shape, ndim: int, planes: int) -> None:
    masks, perm, counts, nplanes, nwords = _tables(int(planes), ndim)
    batch, (d0, d1, d2), _ = _geometry(shape, ndim)
    fn = _build.bind("zfp", symbol, _ARGS[symbol])
    err = fn(a, b, c, batch, d0, d1, d2, ndim,
             masks.ctypes.data, perm.ctypes.data, counts.ctypes.data,
             nplanes, nwords, stream_order(int(planes), ndim),
             torch.cuda.current_stream().cuda_stream)
    _build.check("zfp", err, symbol)


def _require(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def encode(x: torch.Tensor, planes: int, ndim: int = 3):
    """Fixed-rate encode of the trailing ``ndim`` axes of ``x``:
    ``(payload (nb, W) uint32, emax (nb,) int32)``, bit for bit
    ``ref.encode_blocks(ref.blockify(x, ndim), planes, ndim)``."""
    if x.device.type == "cpu":
        return ref.encode_blocks(ref.blockify(x, ndim), planes, ndim)
    if x.dtype == torch.float64:
        raise NotImplementedError(ref.FLOAT64_TODO)
    _require(x, torch.float32, "encode input")
    _, _, nb = _geometry(tuple(x.shape), ndim)
    nwords = ref.payload_words(ndim, int(planes))
    payload = torch.empty((nb, nwords), dtype=torch.int32, device=x.device)
    emax = torch.empty((nb,), dtype=torch.int32, device=x.device)
    if nb:
        _launch("zfp_encode", x.data_ptr(), payload.data_ptr(),
                emax.data_ptr(), tuple(x.shape), ndim, planes)
        launches["encode"] += 1
    return payload.view(torch.uint32), emax


def decode(payload: torch.Tensor, emax: torch.Tensor, shape, planes: int,
           ndim: int = 3) -> torch.Tensor:
    """Inverse of ``encode``: the float32 tensor of ``shape``, bit for
    bit ``ref.unblockify(ref.decode_blocks(...), shape, ndim)``."""
    shape = tuple(shape)
    if payload.device.type == "cpu":
        xb = ref.decode_blocks(payload, emax, planes, ndim)
        return ref.unblockify(xb, shape, ndim)
    if emax.device != payload.device:
        raise ValueError("payload and emax must be on the same device")
    _, _, nb = _geometry(shape, ndim)
    nwords = ref.payload_words(ndim, int(planes))
    if tuple(payload.shape) != (nb, nwords) or tuple(emax.shape) != (nb,):
        raise ValueError(
            f"payload {tuple(payload.shape)} / emax {tuple(emax.shape)} do "
            f"not match shape {shape} at {planes} planes ({nb} blocks of "
            f"{nwords} words)"
        )
    _require(payload, torch.uint32, "payload")
    _require(emax, torch.int32, "emax")
    out = torch.empty(shape, dtype=torch.float32, device=payload.device)
    if nb:
        _launch("zfp_decode", payload.data_ptr(), emax.data_ptr(),
                out.data_ptr(), shape, ndim, planes)
        launches["decode"] += 1
    return out

"""Wrappers of the CUDA codec kernels in ``csrc/zfp.cu`` (float32) and
``csrc/zfp64.cu`` (float64).

``encode`` replaces ``repro.kernels.zfp.kernel.encode_pallas`` and
``decode`` replaces ``decode_pallas``; for float64, which the JAX
package sends to its plain version, they launch the float64 kernels.
Unlike the TPU kernels they take the unit itself, ``(..., s1..s_ndim)``:
blockify, its edge padding and unblockify's crop are folded into the
kernels' indexing, so there is no tile padding (``ops.bucket_tile``
stays only for parity). Every kernel is compiled for the two stream
orders that ``ref.level_order`` yields; ``stream_order`` picks one per
launch, and each C entry refuses a launch whose tables are not in that
order. The float64 kernels are also compiled for the routes of
``f64_route`` (which 32-bit halves of the 64-bit words keep bits) and
launched with ``f64_threads`` threads a CTA; their C entries refuse a
launch whose tables are not of the route they are passed.

On a CPU tensor each wrapper runs the plain version (``ref``); on a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches, one per call that reaches the card: ``encode``/``decode`` for
float32, ``encode_f64``/``decode_f64`` for float64; ``f64_shapes`` splits
the float64 launches by counter, unit shape and planes, ``f32_ndims`` the
float32 ones by counter and ndim (the engines' units at 3, lossy
checkpoint leaves at 1, the KV cache's chunks at 2).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels.zfp import ref

launches = {"encode": 0, "decode": 0, "encode_f64": 0, "decode_f64": 0}
# "<counter> [shape] <planes>" -> float64 launches
f64_shapes: collections.Counter = collections.Counter()
# "<counter> ndim<k>" -> float32 launches
f32_ndims: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# every entry takes the stream order (``stream_order``) before the stream;
# the float64 entries also the route (``f64_route``) and the threads a CTA
# (``f64_threads``)
_ARGS = [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P, _I, _I,
         _I, _P]
_ARGS64 = _ARGS[:-1] + [_I, _I, _P]
# per source type: the library, its entries, their arguments, the launch
# counts' suffix
_ROUTE = {
    "float32": ("zfp", "zfp_encode", "zfp_decode", _ARGS, ""),
    "float64": ("zfp64", "zfp_encode_f64", "zfp_decode_f64", _ARGS64, "_f64"),
}
# threads a CTA the float64 kernels take, largest first (csrc/zfp64.cu)
F64_THREADS = (128, 64, 32)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    f64_shapes.clear()
    f32_ndims.clear()


def stream_order(planes: int, ndim: int, width: int = 32) -> int:
    """The stream order the codec kernels are compiled for at ``planes``
    and ``ndim`` on ``width``-bit words: 1 for the subband order
    (coefficients by level, then by index), where ``ref.subband_planes``
    gives the levels different plane counts (4 <= planes <= width - 5 at
    ndim 2 and 3: 27 for float32, 59 for float64); 0 for the identity
    elsewhere, and always at ndim 1, where the two orders are one."""
    return int(ndim > 1 and 4 <= planes <= width - 5)


def order_perm(order: int, ndim: int) -> Tuple[int, ...]:
    """Stream position -> coefficient of ``order`` (``stream_order``), as
    ``csrc/zfp_common.cuh``'s ``stream_pos`` lays it out."""
    n = ref.block_size(ndim)
    if not order:
        return tuple(range(n))
    return tuple(sorted(range(n), key=lambda i: (ref.coeff_levels(ndim)[i], i)))


@functools.lru_cache(maxsize=None)
def f64_route(planes: int, ndim: int) -> int:
    """The route the float64 kernels take at ``planes`` and ``ndim``,
    from ``ref.level_order``'s plane counts at width 64. Plane j is bit
    63 - j of a 64-bit word, so planes 0-31 lie in its high half: 0 when
    no plane past 31 has contributors (every kept bit in a high half;
    24/64 at every ndim), 1 when no plane past 31 has more than 32 (the
    low halves of stream positions 0-31 only; 32/64 at every ndim), 2
    otherwise (ndim 3 at 33-64 planes)."""
    counts = ref.level_order(int(planes), ndim, 64)[2]
    if len(counts) <= 32:
        return 0
    return 1 if max(counts[32:]) <= 32 else 2


def f64_threads(nb: int, sms: int) -> int:
    """Threads a CTA for a float64 launch of ``nb`` blocks on a card of
    ``sms`` SMs: the most of ``F64_THREADS`` whose grid still gives every
    SM a CTA, else the fewest. Each warp codes its 32 blocks alone, so a
    small unit (the precision tier's 6912 or 13824 blocks) takes small
    CTAs and spreads over the card; a large one takes 128."""
    for threads in F64_THREADS:
        if -(-nb // threads) >= sms:
            return threads
    return F64_THREADS[-1]


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _tables(planes: int, ndim: int, width: int = 32):
    """Host-side static tables of one (planes, ndim, word width):
    keep-masks (uint32 or uint64), stream order, plane prefix counts,
    and the payload word count."""
    perm, _, counts = ref.level_order(planes, ndim, width)
    masks = np.asarray(ref.plane_masks(planes, ndim, width),
                       np.uint32 if width == 32 else np.uint64)
    return (masks, np.asarray(perm, np.int32), np.asarray(counts, np.int32),
            len(counts), ref.payload_words(ndim, planes, width))


def _geometry(shape: Tuple[int, ...], ndim: int):
    if ndim not in (1, 2, 3) or len(shape) < ndim:
        raise ValueError(f"ndim={ndim} does not fit a tensor of shape {shape}")
    spatial = (1,) * (3 - ndim) + tuple(shape[-ndim:])
    batch = math.prod(shape[: len(shape) - ndim])
    nb = batch * math.prod(-(-s // 4) for s in shape[-ndim:])
    return batch, spatial, nb


def _launch(key: str, encode: bool, a, b, c, shape, ndim: int,
            planes: int, device: torch.device) -> None:
    lib, enc, dec, argtypes, suffix = _ROUTE[key]
    width = ref._WIDTH[key]
    masks, perm, counts, nplanes, nwords = _tables(int(planes), ndim, width)
    batch, (d0, d1, d2), nb = _geometry(shape, ndim)
    symbol = enc if encode else dec
    launch = (stream_order(int(planes), ndim, width),)
    if suffix:
        launch += (f64_route(int(planes), ndim),
                   f64_threads(nb, _sms(device)))
    fn = _build.bind(lib, symbol, argtypes)
    err = fn(a, b, c, batch, d0, d1, d2, ndim,
             masks.ctypes.data, perm.ctypes.data, counts.ctypes.data,
             nplanes, nwords, *launch,
             torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, symbol)
    kind = ("encode" if encode else "decode") + suffix
    launches[kind] += 1
    if suffix:
        f64_shapes[f"{kind} {list(shape)} {int(planes)}"] += 1
    else:
        f32_ndims[f"{kind} ndim{ndim}"] += 1


def _require(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def encode(x: torch.Tensor, planes: int, ndim: int = 3):
    """Fixed-rate encode of the trailing ``ndim`` axes of float32 or
    float64 ``x``: ``(payload (nb, W) uint32, emax (nb,) int32)``, bit for
    bit ``ref.encode_blocks(ref.blockify(x, ndim), planes, ndim)``."""
    if x.device.type == "cpu":
        return ref.encode_blocks(ref.blockify(x, ndim), planes, ndim)
    key = ref.dtype_key(x.dtype)
    width = ref._WIDTH[key]
    _require(x, ref._FLOAT[key], "encode input")
    _, _, nb = _geometry(tuple(x.shape), ndim)
    nwords = ref.payload_words(ndim, int(planes), width)
    payload = torch.empty((nb, nwords), dtype=torch.int32, device=x.device)
    emax = torch.empty((nb,), dtype=torch.int32, device=x.device)
    if nb:
        _launch(key, True, x.data_ptr(), payload.data_ptr(),
                emax.data_ptr(), tuple(x.shape), ndim, planes, x.device)
    return payload.view(torch.uint32), emax


def decode(payload: torch.Tensor, emax: torch.Tensor, shape, planes: int,
           ndim: int = 3, dtype="float32") -> torch.Tensor:
    """Inverse of ``encode``: the ``dtype`` (float32 or float64) tensor of
    ``shape``, bit for bit ``ref.unblockify(ref.decode_blocks(...), shape,
    ndim)``."""
    shape = tuple(shape)
    key = ref.dtype_key(dtype)
    if payload.device.type == "cpu":
        xb = ref.decode_blocks(payload, emax, planes, ndim, key)
        return ref.unblockify(xb, shape, ndim)
    if emax.device != payload.device:
        raise ValueError("payload and emax must be on the same device")
    width = ref._WIDTH[key]
    _, _, nb = _geometry(shape, ndim)
    nwords = ref.payload_words(ndim, int(planes), width)
    if tuple(payload.shape) != (nb, nwords) or tuple(emax.shape) != (nb,):
        raise ValueError(
            f"payload {tuple(payload.shape)} / emax {tuple(emax.shape)} do "
            f"not match shape {shape} at {planes} planes ({nb} blocks of "
            f"{nwords} words)"
        )
    _require(payload, torch.uint32, "payload")
    _require(emax, torch.int32, "emax")
    out = torch.empty(shape, dtype=ref._FLOAT[key], device=payload.device)
    if nb:
        _launch(key, False, payload.data_ptr(), emax.data_ptr(),
                out.data_ptr(), shape, ndim, planes, payload.device)
    return out

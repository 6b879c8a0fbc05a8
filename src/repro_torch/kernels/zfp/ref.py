"""Plain PyTorch version of the fixed-rate ZFP-style block codec.

Port of ``repro.kernels.zfp.ref``, float32 and float64. It is the
numerics ground truth of the port: the CUDA kernels in ``kernel.py`` are
held to it bit for bit, and it is held bit for bit to the JAX reference
on the same inputs (``payload``, ``emax`` and the decoded values; the
float64 path against the reference under ``jax_enable_x64``).

Algorithm per 4^d block (d in {1, 2, 3}):

  1. block floating point: ``emax`` is the block's largest frexp
     exponent (floored at -90 for float32, -900 for float64), and every
     value becomes the integer ``q = rint(x * 2^(FRAC - emax))``, with
     FRAC 26 in int32 (float32) or 55 in int64 (float64);
  2. a two-level Haar S-lift along each of the d axes (exactly
     invertible in integer arithmetic);
  3. negabinary, so magnitude decays with bit position across signs;
  4. fixed-rate truncation with a static subband allocation (low
     frequencies keep more planes), packed plane-major over the static
     ``level_order`` into uint32 words.

Rate: ``planes`` bits per value plus a 16-bit ``emax`` header per block.
The paper's float64 rates 32/64 and 24/64 are ``planes=32, 24`` with
float64 input; the float32 rates 16 and 12 give the same ratios.

PyTorch on the CPU has no ``+ - << >>`` on ``torch.uint32`` or
``torch.uint64``, so unsigned words live in ``int64`` tensors. 32-bit
words hold values in ``[0, 2^32)``; 64-bit words hold the unsigned bits
as the signed int64 of the same bits: negabinary ``(c + m) ^ m`` and its
inverse rely on two's-complement wrap-around, the mask ``0xAAAA...AA``
is its signed value, and a plane is taken by masking after the
(arithmetic) shift. ``torch.uint32`` is only the payload's storage type.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# Per source type, keyed by its numpy-style name. Fixed-point fraction
# bits: x * 2^shift is exact, and the transform's worst-case growth of
# 2^d still fits the integer type (int32 or int64) with a guard bit.
_FRAC = {"float32": 26, "float64": 55}
# Most negative exponent honoured before a block flushes to zero; keeps
# every 2^shift a normal number of the source type.
_EMAX_FLOOR = {"float32": -90, "float64": -900}
_EXP_BIAS = {"float32": 127, "float64": 1023}
_MANT_BITS = {"float32": 23, "float64": 52}
_WIDTH = {"float32": 32, "float64": 64}
_FLOAT = {"float32": torch.float32, "float64": torch.float64}
_INT = {"float32": torch.int32, "float64": torch.int64}
_U32 = 0xFFFFFFFF
_NB_MASK = int(sum(1 << b for b in range(1, 32, 2)))  # 0xAAAAAAAA
# 0xAAAAAAAAAAAAAAAA as the int64 of the same bits
_NB_MASK64 = int(sum(1 << b for b in range(1, 64, 2))) - (1 << 64)

WORD_BITS = 32  # payload word size (uint32)
HEADER_BITS = 16  # per-block emax header, counted in reported ratios


def dtype_key(dtype) -> str:
    """``"float32"`` or ``"float64"`` for a torch or numpy dtype or its
    name; any other type raises ``TypeError``."""
    name = dtype_name(dtype)
    if name not in _WIDTH:
        raise TypeError(f"the codec takes float32 or float64, got {dtype}")
    return name


def _signed64(v: int) -> int:
    """An unsigned 64-bit value as the int64 of the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def block_size(ndim: int) -> int:
    return 4**ndim


# --- static subband rate allocation ------------------------------------
#
# Low-frequency subbands get more planes, high-frequency fewer, with
# per-level offsets chosen so the total is exactly ``block_size * planes``
# bits. Per-axis Haar level of coefficient [ss, ds, d0, d1] = [0,1,2,2];
# block level L = sum over axes.

_SUBBAND_DELTA = {
    1: (2, 0, -1),
    2: (3, 2, 1, -1, -2),
    3: (5, 4, 2, 1, 0, -2, -3),
}
_AXIS_LEVEL = (0, 1, 2, 2)


@functools.lru_cache(maxsize=None)
def coeff_levels(ndim: int) -> Tuple[int, ...]:
    """Subband level of each coefficient in the (nb, 4^ndim) layout."""
    levels = []
    for i in range(block_size(ndim)):
        lv, rem = 0, i
        for _ in range(ndim):
            lv += _AXIS_LEVEL[rem % 4]
            rem //= 4
        levels.append(lv)
    return tuple(levels)


@functools.lru_cache(maxsize=None)
def subband_planes(planes: int, ndim: int, width: int) -> Tuple[int, ...]:
    """Per-coefficient plane counts; sums to exactly block_size*planes.
    Offsets apply only where no clipping at [0, width] can occur
    (4 <= planes <= width-5); elsewhere allocation is uniform."""
    levels = coeff_levels(ndim)
    if 4 <= planes <= width - 5:
        delta = _SUBBAND_DELTA[ndim]
        return tuple(planes + delta[lv] for lv in levels)
    return tuple(min(width, planes) for _ in levels)


@functools.lru_cache(maxsize=None)
def level_order(planes: int, ndim: int, width: int):
    """Static stream order: coefficients sorted by descending plane
    count (stable). Returns (perm, inv_perm, prefix_counts) where
    prefix_counts[j] = #coefficients contributing a bit to plane j; the
    contributors of every plane are a prefix of ``perm``."""
    pv = subband_planes(planes, ndim, width)
    n = block_size(ndim)
    perm = tuple(sorted(range(n), key=lambda i: (-pv[i], i)))
    inv = [0] * n
    for pos, i in enumerate(perm):
        inv[i] = pos
    nplanes = max(pv) if pv else 0
    counts = tuple(sum(1 for i in range(n) if pv[i] > j) for j in range(nplanes))
    return perm, tuple(inv), counts


def payload_bits(ndim: int, planes: int, width: int = 32) -> int:
    return sum(subband_planes(planes, ndim, width))


def payload_words(ndim: int, planes: int, width: int = 32) -> int:
    """uint32 words per block of packed payload."""
    return -(-payload_bits(ndim, planes, width) // WORD_BITS)


def bits_per_value(ndim: int, planes: int, width: int = 32) -> float:
    """Achieved rate including the emax header."""
    n = block_size(ndim)
    return payload_bits(ndim, planes, width) / n + HEADER_BITS / n


def plane_masks(planes: int, ndim: int, width: int) -> Tuple[int, ...]:
    """Keep-masks implementing the subband allocation."""
    pv = subband_planes(int(planes), ndim, width)
    return tuple((((1 << p) - 1) << (width - p)) if p > 0 else 0 for p in pv)


@functools.lru_cache(maxsize=None)
def stream_tables(planes: int, ndim: int, width: int = 32):
    """Where each payload bit comes from: for word ``w`` and lane ``l``
    (stream bit ``32*w + l``), the coefficient index ``coef[w, l]``, the
    bit position ``shift[w, l]`` inside its ``width``-bit word and
    ``valid[w, l]`` (0 on the zero padding after the last stream bit).
    int64 arrays of shape (payload_words, 32)."""
    perm, _, counts = level_order(int(planes), ndim, width)
    nwords = payload_words(ndim, planes, width)
    coef = np.zeros((nwords * WORD_BITS,), np.int64)
    shift = np.zeros_like(coef)
    valid = np.zeros_like(coef)
    t = 0
    for j, k in enumerate(counts):
        for p in range(k):
            coef[t], shift[t], valid[t] = perm[p], width - 1 - j, 1
            t += 1
    shape = (nwords, WORD_BITS)
    return coef.reshape(shape), shift.reshape(shape), valid.reshape(shape)


# ---------------------------------------------------------------------------
# Fixed point <-> float
# ---------------------------------------------------------------------------


def exp2i(shift: torch.Tensor, dtype="float32") -> torch.Tensor:
    """Exact 2^shift of the float type ``dtype`` for integer shift,
    built from IEEE bits."""
    key = dtype_key(dtype)
    bits = (shift.to(_INT[key]) + _EXP_BIAS[key]) << _MANT_BITS[key]
    return bits.view(_FLOAT[key])


def _exponent(x: torch.Tensor) -> torch.Tensor:
    """frexp-style exponent: |x| < 2^e for x != 0. Zeros get a sentinel."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.full_like(e, -(2**14)), e.to(torch.int32))


def block_emax(xb: torch.Tensor) -> torch.Tensor:
    """Max exponent per block. xb: (nb, N) float -> (nb,) int32."""
    floor = _EMAX_FLOOR[dtype_key(xb.dtype)]
    return _exponent(xb).amax(dim=-1).clamp_min(floor)


def to_fixedpoint(xb: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """int32 (float32 input) or int64 (float64) fixed-point values."""
    key = dtype_key(xb.dtype)
    scaled = xb * exp2i(_FRAC[key] - emax, key)[..., None]
    return torch.round(scaled).to(_INT[key])


def from_fixedpoint(q: torch.Tensor, emax: torch.Tensor,
                    dtype="float32") -> torch.Tensor:
    key = dtype_key(dtype)
    return q.to(_FLOAT[key]) * exp2i(emax - _FRAC[key], key)[..., None]


# ---------------------------------------------------------------------------
# Integer lifting transform (exactly invertible)
# ---------------------------------------------------------------------------


def _s_fwd(u, v):
    """S-transform butterfly: lossless integer average/difference."""
    return (u + v) >> 1, u - v


def _s_inv(s, d):
    u = s + ((d + 1) >> 1)
    return u, u - d


def _lift4_fwd(q: torch.Tensor) -> torch.Tensor:
    """Two-level Haar lift along the last axis (size 4)."""
    q0, q1, q2, q3 = q.unbind(-1)
    s0, d0 = _s_fwd(q0, q1)
    s1, d1 = _s_fwd(q2, q3)
    ss, ds = _s_fwd(s0, s1)
    return torch.stack([ss, ds, d0, d1], dim=-1)


def _lift4_inv(c: torch.Tensor) -> torch.Tensor:
    ss, ds, d0, d1 = c.unbind(-1)
    s0, s1 = _s_inv(ss, ds)
    q0, q1 = _s_inv(s0, d0)
    q2, q3 = _s_inv(s1, d1)
    return torch.stack([q0, q1, q2, q3], dim=-1)


def _apply_per_axis(q: torch.Tensor, ndim: int, fn, reverse: bool):
    """Apply a size-4 last-axis transform along each of the trailing
    ``ndim`` axes of q reshaped to (nb, 4, ..., 4). The inverse visits
    the axes in the opposite order to undo the forward exactly."""
    nb = q.shape[0]
    q = q.reshape((nb,) + (4,) * ndim)
    axes = range(1, ndim + 1)
    for ax in reversed(axes) if reverse else axes:
        q = fn(q.movedim(ax, -1)).movedim(-1, ax)
    return q.reshape(nb, block_size(ndim))


def fwd_transform(q: torch.Tensor, ndim: int) -> torch.Tensor:
    return _apply_per_axis(q, ndim, _lift4_fwd, reverse=False)


def inv_transform(c: torch.Tensor, ndim: int) -> torch.Tensor:
    return _apply_per_axis(c, ndim, _lift4_inv, reverse=True)


# ---------------------------------------------------------------------------
# Negabinary + fixed-rate plane truncation (unsigned words held in int64)
# ---------------------------------------------------------------------------


def to_negabinary(c: torch.Tensor) -> torch.Tensor:
    """Coefficients -> negabinary words in int64: int32 coefficients give
    32-bit words in [0, 2^32); int64 coefficients give 64-bit words as
    the int64 of the same bits (two's-complement wrap-around)."""
    if c.dtype == torch.int64:
        return (c + _NB_MASK64) ^ _NB_MASK64
    cu = c.to(torch.int64) & _U32
    return ((cu + _NB_MASK) & _U32) ^ _NB_MASK


def from_negabinary(u: torch.Tensor, width: int = 32) -> torch.Tensor:
    """Negabinary words (int64) -> coefficients: int32 at width 32, with
    the two's-complement wrap-around of the 32-bit original; int64 at
    width 64."""
    if width == 64:
        return (u ^ _NB_MASK64) - _NB_MASK64
    v = ((u ^ _NB_MASK) - _NB_MASK) & _U32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def truncate_planes(u: torch.Tensor, planes: int, ndim: int,
                    width: int = 32) -> torch.Tensor:
    """Keep the subband-allocated top planes of each ``width``-bit word."""
    pv = subband_planes(int(planes), ndim, width)
    if all(p >= width for p in pv):
        return u
    masks = torch.tensor([_signed64(m) for m in plane_masks(planes, ndim,
                                                             width)],
                         dtype=torch.int64, device=u.device)
    return u & masks[None, :]


# ---------------------------------------------------------------------------
# Bit-plane packing (plane-major, the ZFP stream layout)
# ---------------------------------------------------------------------------


def _as_u32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> torch.uint32 with the same bits."""
    signed = torch.where(words >= 2**31, words - 2**32, words)
    return signed.to(torch.int32).view(torch.uint32)


def _tables(planes: int, ndim: int, width: int, device):
    return tuple(torch.from_numpy(t).to(device)
                 for t in stream_tables(int(planes), ndim, width))


def pack_planes(u: torch.Tensor, planes: int, ndim: int,
                width: int = 32) -> torch.Tensor:
    """u: (nb, N) int64 subband-truncated negabinary ``width``-bit words.
    Returns (nb, W) torch.uint32 payload words, plane-major over the
    level order. Built one lane at a time, so no (nb, W*32) bit tensor
    exists. A bit is taken by masking after the shift (``>>`` on int64 is
    arithmetic)."""
    coef, shift, valid = _tables(planes, ndim, width, u.device)
    out = torch.zeros((u.shape[0], coef.shape[0]), dtype=torch.int64,
                      device=u.device)
    for lane in range(WORD_BITS):
        col = u[:, coef[:, lane]]
        bit = (col >> shift[:, lane]) & valid[:, lane]
        out |= bit << lane
    return _as_u32(out)


def unpack_planes(words: torch.Tensor, planes: int, ndim: int,
                  width: int = 32) -> torch.Tensor:
    """Inverse of pack_planes: (nb, W) uint32 -> (nb, N) int64 words
    (low planes zero)."""
    coef, shift, valid = _tables(planes, ndim, width, words.device)
    w64 = words.view(torch.int32).to(torch.int64) & _U32
    up = torch.zeros((words.shape[0], block_size(ndim)), dtype=torch.int64,
                     device=words.device)
    for lane in range(WORD_BITS):
        bit = ((w64 >> lane) & 1) & valid[:, lane]
        # every (plane, coefficient) pair occurs once in the stream, so
        # the added bits are disjoint and the sum is their OR (bit 63
        # adds as the int64 minimum, without overflow)
        up.index_add_(1, coef[:, lane], bit << shift[:, lane])
    return up


# ---------------------------------------------------------------------------
# Whole-codec entry points on blockified data
# ---------------------------------------------------------------------------


def encode_blocks(xb: torch.Tensor, planes: int, ndim: int):
    """xb: (nb, 4^ndim) float32/float64 -> (payload (nb, W) uint32,
    emax (nb,) int32)."""
    width = _WIDTH[dtype_key(xb.dtype)]
    emax = block_emax(xb)
    c = fwd_transform(to_fixedpoint(xb, emax), ndim)
    u = truncate_planes(to_negabinary(c), planes, ndim, width)
    return pack_planes(u, planes, ndim, width), emax


def decode_blocks(payload: torch.Tensor, emax: torch.Tensor, planes: int,
                  ndim: int, dtype="float32") -> torch.Tensor:
    width = _WIDTH[dtype_key(dtype)]
    c = from_negabinary(unpack_planes(payload, planes, ndim, width), width)
    return from_fixedpoint(inv_transform(c, ndim), emax, dtype)


def quantize_blocks(xb: torch.Tensor, planes: int, ndim: int) -> torch.Tensor:
    """decode(encode(x)) fused, skipping bit packing (numerics only).
    Equal to decode_blocks(*encode_blocks(...)) bit for bit."""
    width = _WIDTH[dtype_key(xb.dtype)]
    emax = block_emax(xb)
    c = fwd_transform(to_fixedpoint(xb, emax), ndim)
    u = truncate_planes(to_negabinary(c), planes, ndim, width)
    q = inv_transform(from_negabinary(u, width), ndim)
    return from_fixedpoint(q, emax, xb.dtype)


# ---------------------------------------------------------------------------
# N-d array <-> blocks
# ---------------------------------------------------------------------------


def _padded_shape(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(-(-s // 4) * 4 for s in shape)


def blockify(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """x: (..., s1..s_ndim) -> (nb, 4^ndim) with edge padding to x4.
    Leading axes are batch; the trailing ``ndim`` axes are tiled by
    4^ndim blocks, row-major over (batch..., block indices)."""
    spatial = tuple(x.shape[-ndim:])
    padded = _padded_shape(spatial)
    lead = x.dim() - ndim
    for i, (s, p) in enumerate(zip(spatial, padded)):
        if p != s:  # edge padding = clamped indices
            idx = torch.arange(p, device=x.device).clamp_(max=s - 1)
            x = x.index_select(lead + i, idx)
    batch = tuple(x.shape[:lead])
    x = x.reshape(batch + sum(((p // 4, 4) for p in padded), ()))
    order = (
        tuple(range(lead))
        + tuple(lead + 2 * i for i in range(ndim))
        + tuple(lead + 2 * i + 1 for i in range(ndim))
    )
    return x.permute(order).reshape(-1, block_size(ndim))


def unblockify(xb: torch.Tensor, shape: Tuple[int, ...], ndim: int):
    """Inverse of blockify back to ``shape`` (crops the x4 padding)."""
    spatial = tuple(shape[-ndim:])
    padded = _padded_shape(spatial)
    batch = tuple(shape[: len(shape) - ndim])
    lead = len(batch)
    x = xb.reshape(batch + tuple(p // 4 for p in padded) + (4,) * ndim)
    order = list(range(lead))
    for i in range(ndim):
        order += [lead + i, lead + ndim + i]
    x = x.permute(order).reshape(batch + padded)
    crop = (slice(None),) * lead + tuple(slice(0, s) for s in spatial)
    return x[crop].contiguous()


# ---------------------------------------------------------------------------
# High-level array API
# ---------------------------------------------------------------------------


def dtype_name(dtype) -> str:
    """numpy-style dtype name (``"float32"``) of a torch or numpy dtype,
    as ``Compressed.dtype`` and the checkpoint metadata carry it."""
    return str(dtype).removeprefix("torch.")


def _numel(a) -> int:
    return int(a.numel()) if isinstance(a, torch.Tensor) else int(a.size)


@dataclass(frozen=True)
class Compressed:
    """A fixed-rate compressed array (payload + per-block exponents).
    ``payload`` and ``emax`` are torch tensors on a device, or numpy
    arrays while a unit sits in the host store."""

    payload: object  # (nb, W) uint32
    emax: object  # (nb,) int32
    shape: Tuple[int, ...]
    planes: int
    ndim_spatial: int
    dtype: str  # numpy-style name, "float32" or "float64"

    @property
    def compression_ratio(self) -> float:
        raw_bits = 8 * np.dtype(self.dtype).itemsize
        return raw_bits / bits_per_value(self.ndim_spatial, self.planes)

    def nbytes(self) -> int:
        return _numel(self.payload) * 4 + _numel(self.emax) * 2


def compress(x: torch.Tensor, planes: int, ndim: int = 3) -> Compressed:
    payload, emax = encode_blocks(blockify(x, ndim), planes, ndim)
    return Compressed(payload, emax, tuple(x.shape), planes, ndim,
                      dtype_name(x.dtype))


def decompress(c: Compressed) -> torch.Tensor:
    xb = decode_blocks(c.payload, c.emax, c.planes, c.ndim_spatial, c.dtype)
    return unblockify(xb, c.shape, c.ndim_spatial)


def quantize(x: torch.Tensor, planes: int, ndim: int = 3) -> torch.Tensor:
    """Numerics of a compress->decompress round trip, without packing."""
    return unblockify(quantize_blocks(blockify(x, ndim), planes, ndim),
                      tuple(x.shape), ndim)


def max_abs_error_bound(emax: torch.Tensor, planes: int, ndim: int,
                        dtype="float32") -> torch.Tensor:
    """Per-block worst-case absolute error, in ``dtype``:
    2^(emax - FRAC) 2^ndim for the fixed-point rounding, plus the
    truncation term below."""
    key = dtype_key(dtype)
    frac, w, ft = _FRAC[key], _WIDTH[key], _FLOAT[key]
    quant = torch.exp2((emax - frac).to(ft))
    # negabinary truncation: the worst-allocated subband keeps
    # min(subband_planes) planes; dropped bits sum to < 2^(w-pmin+1)
    # fixed-point units, amplified by the inverse transform by < 2^ndim
    pmin = min(subband_planes(int(planes), ndim, w))
    trunc = torch.exp2(
        (emax + (w - pmin) + 1 + ndim - frac).to(ft)
    ) * (1 if pmin < w else 0)
    return quant * (2**ndim) + trunc

"""Plain reference of the fixed-rate codec's numerics: what a unit reads
after a compress and decompress round trip, in plain PyTorch.

A frozen copy of the codec's arithmetic as the paper's method uses it
(ZFP's fixed-rate mode on 4x4x4 blocks, with a static allocation of bit
planes to subbands): per block the largest exponent, the values to
fixed point (26 fraction bits for float32, 55 for float64, round half to
even), a two-level integer Haar lift along each axis, negabinary words,
each coefficient's word cut to its subband's planes, and back. The bit
packing of the payload is left out: it moves bits, it changes none.
A unit's ragged edge is padded by repeating its last plane, row or
column, as the codec does. Imports nothing of the program.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

FRAC = {"float32": 26, "float64": 55}
EMAX_FLOOR = {"float32": -90, "float64": -900}
EXP_BIAS = {"float32": 127, "float64": 1023}
MANT_BITS = {"float32": 23, "float64": 52}
WIDTH = {"float32": 32, "float64": 64}
FLOAT = {"float32": torch.float32, "float64": torch.float64}
INT = {"float32": torch.int32, "float64": torch.int64}
U32 = 0xFFFFFFFF
NB32 = 0xAAAAAAAA
NB64 = 0xAAAAAAAAAAAAAAAA - (1 << 64)  # as the int64 of the same bits
# plane offsets by subband level (a 3-D block's levels 0..6) and the
# level each lifted position adds along an axis
DELTA = (5, 4, 2, 1, 0, -2, -3)
AXIS_LEVEL = (0, 1, 2, 2)
CHUNK = 16  # planes of a unit quantized at once (a multiple of 4)


def _key(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=None)
def subband_planes(planes: int, width: int) -> Tuple[int, ...]:
    """Planes kept of each of a block's 64 coefficients."""
    levels = [sum(AXIS_LEVEL[(i >> (2 * a)) & 3] for a in range(3))
              for i in range(64)]
    if 4 <= planes <= width - 5:
        return tuple(planes + DELTA[lv] for lv in levels)
    return tuple(min(width, planes) for _ in levels)


def _masks(planes: int, width: int, device) -> torch.Tensor:
    out = []
    for p in subband_planes(planes, width):
        m = (((1 << p) - 1) << (width - p)) if p > 0 else 0
        out.append(m - (1 << 64) if m >= 1 << 63 else m)
    return torch.tensor(out, dtype=torch.int64, device=device)


def _exp2i(shift: torch.Tensor, key: str) -> torch.Tensor:
    bits = (shift.to(INT[key]) + EXP_BIAS[key]) << MANT_BITS[key]
    return bits.view(FLOAT[key])


def _lift(q: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The two-level integer Haar lift along the last axis (size 4)."""
    if not inverse:
        q0, q1, q2, q3 = q.unbind(-1)
        s0, d0 = (q0 + q1) >> 1, q0 - q1
        s1, d1 = (q2 + q3) >> 1, q2 - q3
        ss, ds = (s0 + s1) >> 1, s0 - s1
        return torch.stack([ss, ds, d0, d1], dim=-1)
    ss, ds, d0, d1 = q.unbind(-1)
    s0 = ss + ((ds + 1) >> 1)
    s1 = s0 - ds
    q0 = s0 + ((d0 + 1) >> 1)
    q2 = s1 + ((d1 + 1) >> 1)
    return torch.stack([q0, q0 - d0, q2, q2 - d1], dim=-1)


def _transform(q: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The lift along each axis of (nb, 4, 4, 4) blocks: z, y, x
    forward, x, y, z back."""
    axes = (3, 2, 1) if inverse else (1, 2, 3)
    for ax in axes:
        q = _lift(q.movedim(ax, -1), inverse).movedim(-1, ax)
    return q


def quantize_blocks(xb: torch.Tensor, planes: int) -> torch.Tensor:
    """(nb, 4, 4, 4) float blocks after the round trip."""
    key = _key(xb.dtype)
    width = WIDTH[key]
    _, e = torch.frexp(xb)
    e = torch.where(xb == 0, torch.full_like(e, -(2 ** 14)), e.to(torch.int32))
    emax = e.flatten(1).amax(dim=1).clamp_min(EMAX_FLOOR[key])
    scale = _exp2i(FRAC[key] - emax, key)[:, None, None, None]
    c = _transform(torch.round(xb * scale).to(INT[key]), inverse=False)
    c = c.reshape(-1, 64)
    if width == 64:
        u = (c + NB64) ^ NB64
    else:
        u = (((c.to(torch.int64) & U32) + NB32) & U32) ^ NB32
    if any(p < width for p in subband_planes(planes, width)):
        u = u & _masks(planes, width, u.device)[None, :]
    if width == 64:
        c = (u ^ NB64) - NB64
    else:
        v = ((u ^ NB32) - NB32) & U32
        c = torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)
    q = _transform(c.reshape(-1, 4, 4, 4), inverse=True)
    return q.to(FLOAT[key]) * _exp2i(emax - FRAC[key], key)[:, None, None,
                                                            None]


def _quantize_part(x: torch.Tensor, planes: int) -> torch.Tensor:
    shape = tuple(x.shape)
    padded = tuple(-(-s // 4) * 4 for s in shape)
    for ax, (s, p) in enumerate(zip(shape, padded)):
        if p != s:
            idx = torch.arange(p, device=x.device).clamp_(max=s - 1)
            x = x.index_select(ax, idx)
    bz, by, bx = (p // 4 for p in padded)
    xb = (x.reshape(bz, 4, by, 4, bx, 4).permute(0, 2, 4, 1, 3, 5)
          .reshape(-1, 4, 4, 4))
    q = quantize_blocks(xb, planes)
    q = (q.reshape(bz, by, bx, 4, 4, 4).permute(0, 3, 1, 4, 2, 5)
         .reshape(padded))
    return q[:shape[0], :shape[1], :shape[2]]


def quantize_(unit: torch.Tensor, planes: int, dtype=None,
              chunk: int = CHUNK) -> None:
    """Replace a unit (z, y, x) by its round trip at ``planes`` of
    ``dtype`` (float32 or float64; the unit's own type by default), in
    place, ``chunk`` planes at a time (blocks never straddle a chunk)."""
    dtype = unit.dtype if dtype is None else dtype
    for z0 in range(0, unit.shape[0], chunk):
        part = unit[z0:z0 + chunk]
        part.copy_(_quantize_part(part.to(dtype), planes))

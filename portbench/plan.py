"""The yardstick's arithmetic: the block plan, the bytes a sweep moves
over the link, the bytes each kernel needs, and the card's peaks.

A copy, kept here so that no change to the program moves it, of the
paper's decomposition (§V-A) as ``repro_torch.core.blocks.BlockPlan``
lays it out, and of ``chip_smoke.py``'s ``expected_summary``. A volume
of Z planes is cut into ``ndiv`` blocks; a visit advances ``bt`` steps
and needs H = 4 bt planes of halo a side. Storage units, disjoint and
covering [0, Z): remainders R_i and the 2H-plane common regions C_i
between blocks. A sweep fetches every unit of every field once and
writes every unit of every read-write field back once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

RADIUS = 4  # the 25-point stencil's reach along each axis
# NVIDIA H100 SXM data sheet (dense, at its 700 W limit)
PEAK_HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8}
WIDTH = {"float32": 32, "float64": 64}


def halo(bt: int) -> int:
    return RADIUS * bt


def units(z: int, ndiv: int, bt: int) -> List[Tuple[str, int, int, int]]:
    """Every storage unit as ``(kind, index, lo, hi)``."""
    if z % ndiv:
        raise ValueError(f"Z={z} does not divide into {ndiv} blocks")
    b, h = z // ndiv, halo(bt)
    if b < 2 * h:
        raise ValueError(f"block {b} is under 2H = {2 * h}")
    out = []
    for i in range(ndiv):
        lo = i * b + h if i > 0 else 0
        hi = (i + 1) * b - h if i < ndiv - 1 else z
        out.append(("R", i, lo, hi))
    out += [("C", i, (i + 1) * b - h, (i + 1) * b + h)
            for i in range(ndiv - 1)]
    return out


def visit_planes(z: int, ndiv: int, bt: int) -> int:
    """Planes of one block visit as the stencil sees it: B + 2H (the
    volume's edge blocks padded with H zero planes)."""
    return z // ndiv + 2 * halo(bt)


def blocks_of(shape) -> int:
    """ZFP blocks (4^3 values) of a unit of ``shape``."""
    z, y, x = shape
    return -(-z // 4) * -(-y // 4) * -(-x // 4)


def payload_words(planes: int, dtype: str) -> int:
    """32-bit payload words of one 4^3 block at ``planes`` bit planes.
    The codec's subband allocation gives the 64 coefficients
    ``planes + delta`` planes each with deltas that sum to 0 (or
    ``min(width, planes)`` each where the offsets would clip), so a
    block holds 64 min(planes, width) bits."""
    return -(-64 * min(int(planes), WIDTH[dtype]) // 32)


def field_planes(rate, dtype: str):
    """The bit planes of a field stored at ``rate`` (a share of the
    type's bits, None = raw)."""
    if rate is None:
        return None
    planes = rate * WIDTH[dtype]
    if planes != int(planes):
        raise ValueError(f"rate {rate} is not a whole number of planes "
                         f"of {dtype}")
    return int(planes)


def unit_wire(shape, planes, dtype: str) -> int:
    """Bytes of one unit on the link: raw values, or per block its
    payload words and a 2-byte emax header."""
    if planes is None:
        z, y, x = shape
        return z * y * x * ITEMSIZE[dtype]
    return blocks_of(shape) * (4 * payload_words(planes, dtype) + 2)


def expected_summary(shape, ndiv: int, bt: int, fields: Dict[str, dict],
                     dtype: str) -> Dict[str, int]:
    """The transfer summary of one sweep: every unit fetched once a
    field and written back once a read-write field. ``fields`` maps a
    field to ``{"role": "rw" | "ro", "planes": int | None}``."""
    z, y, x = shape
    plane = y * x * ITEMSIZE[dtype]
    us = units(z, ndiv, bt)
    tot = {"h2d_raw": 0, "h2d_wire": 0, "d2h_raw": 0, "d2h_wire": 0,
           "h2d_count": 0, "d2h_count": 0}
    for spec in fields.values():
        wire = sum(unit_wire((hi - lo, y, x), spec["planes"], dtype)
                   for _, _, lo, hi in us)
        dirs = ("h2d", "d2h") if spec["role"] == "rw" else ("h2d",)
        for d in dirs:
            tot[f"{d}_raw"] += z * plane
            tot[f"{d}_wire"] += wire
            tot[f"{d}_count"] += len(us)
    return tot


# ----------------------------------------------------------------------
# the bytes each kernel needs: each input read once, each output
# written once, from the plan's shapes
# ----------------------------------------------------------------------


def codec_bytes(shape, planes: int, dtype: str) -> int:
    """One encode or decode of a unit: the raw values on one side, the
    payload and a 4-byte emax a block (as the device holds it) on the
    other."""
    z, y, x = shape
    nb = blocks_of(shape)
    return (z * y * x * ITEMSIZE[dtype]
            + nb * 4 * payload_words(planes, dtype) + nb * 4)


def rung_bytes(shape, dtype: str) -> int:
    """One rung (a step) of the wave on a fetched block: p_prev, p_cur
    and vel2 read, p_next written."""
    z, y, x = shape
    return 4 * z * y * x * ITEMSIZE[dtype]


def sweep_codec(shape, ndiv: int, bt: int, fields: Dict[str, dict],
                dtype: str) -> Dict[str, Tuple[int, int]]:
    """``{"decode": (launch units, bytes), "encode": (...)}`` of one
    sweep: a decode for every fetched compressed unit, an encode for
    every compressed unit written back."""
    z, y, x = shape
    out = {"decode": (0, 0), "encode": (0, 0)}
    for spec in fields.values():
        if spec["planes"] is None:
            continue
        dirs = ("decode", "encode") if spec["role"] == "rw" else ("decode",)
        for _, _, lo, hi in units(z, ndiv, bt):
            b = codec_bytes((hi - lo, y, x), spec["planes"], dtype)
            for d in dirs:
                n, tot = out[d]
                out[d] = (n + 1, tot + b)
    return out


def sweep_rungs(shape, ndiv: int, bt: int, dtype: str) -> Tuple[int, int]:
    """``(launches, bytes)`` of one sweep's rungs: ``bt`` a block."""
    z, y, x = shape
    n = ndiv * bt
    return n, n * rung_bytes((visit_planes(z, ndiv, bt), y, x), dtype)

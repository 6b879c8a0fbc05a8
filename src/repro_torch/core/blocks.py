"""Block decomposition + separate-compression unit layout (paper §V-A).

A volume of Z planes is decomposed into ``ndiv`` equal blocks along Z.
With temporal blocking of ``bt`` steps and stencil radius ``r``, each
block visit needs ``H = r * bt`` halo planes per side, and contiguous
blocks share a ``2H``-plane *common region* around each internal cut.

Storage units (disjoint, covering [0, Z)):

  R_0 = [0,        e_0 - H)            first remainder
  R_i = [s_i + H,  e_i - H)            interior remainders
  R_n = [s_n + H,  Z)                  last remainder
  C_i = [e_i - H,  e_i + H)            common region between i and i+1

Fetch set for block i:  C_{i-1} | R_i | C_i  (C_{i-1} is already on
device — the sharing that saves 2H planes of H2D per internal block).
Writeback set for block i:  R_i  and the *completed* C_{i-1}
(lower half computed by block i-1 and held on device, upper half by
block i) — each unit is compressed exactly once per sweep (Fig. 3b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.kernels.stencil.ref import HALO


@dataclass(frozen=True)
class BlockPlan:
    z: int  # interior planes
    ndiv: int
    bt: int  # temporal blocking steps per visit
    radius: int = HALO

    def __post_init__(self):
        assert self.z % self.ndiv == 0, (self.z, self.ndiv)
        assert self.block >= 2 * self.halo, (
            f"block {self.block} must be >= 2H={2 * self.halo}"
            " (remainder would be empty)"
        )

    @property
    def block(self) -> int:
        return self.z // self.ndiv

    @property
    def halo(self) -> int:
        """H = radius * bt planes of halo per side."""
        return self.radius * self.bt

    def owned(self, i: int) -> Tuple[int, int]:
        return i * self.block, (i + 1) * self.block

    def fetch(self, i: int) -> Tuple[int, int]:
        """Unclamped fetch extent (fixed size block + 2H)."""
        s, e = self.owned(i)
        return s - self.halo, e + self.halo

    def remainder(self, i: int) -> Tuple[int, int]:
        s, e = self.owned(i)
        lo = s + self.halo if i > 0 else 0
        hi = e - self.halo if i < self.ndiv - 1 else self.z
        return lo, hi

    def common(self, i: int) -> Tuple[int, int]:
        """C_i between blocks i and i+1, i in [0, ndiv-2]."""
        assert 0 <= i < self.ndiv - 1
        _, e = self.owned(i)
        return e - self.halo, e + self.halo

    def units(self) -> List[Tuple[str, int, Tuple[int, int]]]:
        """All storage units as (kind, index, (lo, hi))."""
        out = [("R", i, self.remainder(i)) for i in range(self.ndiv)]
        out += [("C", i, self.common(i)) for i in range(self.ndiv - 1)]
        return out

    def fetch_units(self, i: int) -> List[Tuple[str, int]]:
        """Units fetched fresh for block i's visit: R_i and C_i.
        (C_{i-1} is the on-device carry from block i-1's visit.)"""
        out = [("R", i)]
        if i < self.ndiv - 1:
            out.append(("C", i))
        return out

    def writeback_units(self, i: int) -> List[Tuple[str, int]]:
        """Units written back after block i computes: R_i and the
        completed C_{i-1}."""
        out = [("R", i)]
        if i > 0:
            out.append(("C", i - 1))
        return out

    def check_cover(self) -> None:
        """Units are disjoint and cover [0, Z) exactly."""
        spans = sorted(span for _, _, span in self.units())
        pos = 0
        for lo, hi in spans:
            assert lo == pos, (lo, pos)
            assert hi > lo
            pos = hi
        assert pos == self.z

    # ---- transfer accounting (planes; multiply by Y*X*itemsize) ----

    def h2d_planes(self, i: int, shared: bool = True) -> int:
        """Planes fetched from host for block i. With sharing, C_{i-1}
        is on device already."""
        rl, rh = self.remainder(i)
        planes = rh - rl
        if i < self.ndiv - 1:
            cl, ch = self.common(i)
            planes += ch - cl
        if not shared and i > 0:
            cl, ch = self.common(i - 1)
            planes += ch - cl
        return planes

    def d2h_planes(self, i: int) -> int:
        """Planes written back after block i computes (R_i plus the
        completed C_{i-1})."""
        rl, rh = self.remainder(i)
        planes = rh - rl
        if i > 0:
            cl, ch = self.common(i - 1)
            planes += ch - cl
        return planes

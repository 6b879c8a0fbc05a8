"""Plain reference of the paper's 3-D acoustic wave (the wave1152
configurations): the in-core run, in plain PyTorch.

A frozen copy of the 25-point stencil's arithmetic: 8th-order central
second differences along each axis, zero (Dirichlet) boundary,
``p_next = 2 p_cur - p_prev + vel2 * lap8(p_cur)``. The order of
operations is the one the port's kernels are held to bit for bit:
``3.0 * C0`` folded in double, the six neighbour terms of each distance
summed left to right (z+k, z-k, y+k, y-k, x+k, x-k), every operation
rounding to the fields' type. Computed in slabs of planes, each with its
4 planes of halo, the new field written over ``p_prev``'s slab (a slab
of ``p_prev`` is read only by itself), so three fields and a slab's
temporaries are all it holds.

``run_ooc`` is what the out-of-core run computes: the in-core steps,
with every compressed field read as the codec gives it back
(``zfp_quantize``, unit by unit): a read-only field once, when it is
stored, a read-write one when it is stored and after every sweep of
``bt`` steps, when it is written back. A unit's values do not depend on
which block computed them: each visit's owned planes are the in-core
run's, and the volume's zero boundary holds, as the padding planes
carry vel2 = 0.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.references.zfp_quantize import quantize_

HALO = 4
C0 = -205.0 / 72.0
C = (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)
SLAB = 32  # output planes a slab


def laplacian8(up: torch.Tensor) -> torch.Tensor:
    """The 8th-order Laplacian of a padded (z+8, y+8, x+8) slab: its
    interior (z, y, x)."""
    h = HALO
    z, y, x = up.shape
    lap = 3.0 * C0 * up[h:-h, h:-h, h:-h]
    for k, ck in enumerate(C, start=1):
        lap = lap + ck * (
            up[h + k:z - h + k, h:-h, h:-h]
            + up[h - k:z - h - k, h:-h, h:-h]
            + up[h:-h, h + k:y - h + k, h:-h]
            + up[h:-h, h - k:y - h - k, h:-h]
            + up[h:-h, h:-h, h + k:x - h + k]
            + up[h:-h, h:-h, h - k:x - h - k]
        )
    return lap


def step_(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor,
          slab: int = SLAB) -> None:
    """One step: ``p_prev`` becomes p_next, slab by slab."""
    z = p_cur.shape[0]
    h = HALO
    for z0 in range(0, z, slab):
        z1 = min(z, z0 + slab)
        lo, hi = max(0, z0 - h), min(z, z1 + h)
        up = F.pad(p_cur[lo:hi], (h, h, h, h, h - (z0 - lo), h - (hi - z1)))
        lap = laplacian8(up)
        c = up[h:-h, h:-h, h:-h]
        p_prev[z0:z1] = 2.0 * c - p_prev[z0:z1] + vel2[z0:z1] * lap


def run(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor,
        steps: int, slab: int = SLAB) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` steps from (p_prev, p_cur), in place in the two buffers:
    (p_prev, p_cur) after them."""
    pp, pc = p_prev, p_cur
    for _ in range(steps):
        step_(pp, pc, vel2, slab)
        pp, pc = pc, pp
    return pp, pc


def store_(t: torch.Tensor, spans: Sequence[Tuple[int, int]],
           planes: Optional[int], codec_dtype=None) -> None:
    """A field stored unit by unit (``spans``: the plan's (lo, hi)) at
    ``planes`` (None: raw, left as it is), the codec run in
    ``codec_dtype`` (the field's own type by default)."""
    if planes is not None:
        for lo, hi in spans:
            quantize_(t[lo:hi], planes, codec_dtype)


def sweep(pp: torch.Tensor, pc: torch.Tensor, vel2: torch.Tensor, bt: int,
          spans: Sequence[Tuple[int, int]], planes: Dict[str, Optional[int]],
          codec_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sweep: ``bt`` steps, then both pressure fields written back
    as ``planes`` says: (p_prev, p_cur) after it."""
    pp, pc = run(pp, pc, vel2, bt)
    store_(pp, spans, planes.get("p_prev"), codec_dtype)
    store_(pc, spans, planes.get("p_cur"), codec_dtype)
    return pp, pc


def run_ooc(fields: Dict[str, torch.Tensor], sweeps: int, bt: int,
            spans: Sequence[Tuple[int, int]],
            planes: Dict[str, Optional[int]], codec_dtype=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sweeps`` sweeps from ``fields`` (``p_prev``, ``p_cur``,
    ``vel2``, modified in place), each stored first as ``planes``
    says: (p_prev, p_cur) after them."""
    for name, t in fields.items():
        store_(t, spans, planes.get(name), codec_dtype)
    pp, pc = fields["p_prev"], fields["p_cur"]
    for _ in range(sweeps):
        pp, pc = sweep(pp, pc, fields["vel2"], bt, spans, planes,
                       codec_dtype)
    return pp, pc

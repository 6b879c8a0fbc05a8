"""Plain PyTorch version of the paper's 25-point acoustic-wave stencil.

Port of ``repro.kernels.stencil.ref``: 8th-order central second
differences along each axis (4 neighbours per side per axis, 24 points
plus the centre). Datasets as in the paper's Table I: ``p_prev`` and
``p_cur`` (read-write), ``lap`` (write-only scratch) and ``vel2``
(read-only, v^2 dt^2 / dx^2).

Update: ``p_next = 2 p_cur - p_prev + vel2 * lap8(p_cur)``.

The order of operations is the reference's, so the result is bit for
bit equal to the JAX eager reference and to the CUDA kernels built with
``-fmad=false``: ``3.0 * C0`` is folded in double and cast to float32,
the six neighbour terms of each distance are summed left to right
(z+k, z-k, y+k, y-k, x+k, x-k), and every operation rounds to float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

HALO = 4  # spatial radius (8th order)

# 8th-order central-difference coefficients for d2/dx2.
C0 = -205.0 / 72.0
C = (8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0)


def pad_bc(u: torch.Tensor, halo: int = HALO) -> torch.Tensor:
    """Dirichlet (zero) ghost shell on every face of a 3-D field."""
    return F.pad(u, (halo,) * 6)


def laplacian8(up: torch.Tensor) -> torch.Tensor:
    """8th-order Laplacian of a padded field. up: (Z+8, Y+8, X+8) ->
    interior (Z, Y, X)."""
    h = HALO
    c = up[h:-h, h:-h, h:-h]
    lap = 3.0 * C0 * c
    for k, ck in enumerate(C, start=1):
        lap = lap + ck * (
            up[h + k : up.shape[0] - h + k, h:-h, h:-h]
            + up[h - k : up.shape[0] - h - k, h:-h, h:-h]
            + up[h:-h, h + k : up.shape[1] - h + k, h:-h]
            + up[h:-h, h - k : up.shape[1] - h - k, h:-h]
            + up[h:-h, h:-h, h + k : up.shape[2] - h + k]
            + up[h:-h, h:-h, h - k : up.shape[2] - h - k]
        )
    return lap


def wave_step(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One acoustic time step on padded fields.

    p_prev, p_cur: (Z+8, Y+8, X+8) padded; vel2: (Z, Y, X) interior.
    Returns (p_next interior, lap interior).
    """
    h = HALO
    lap = laplacian8(p_cur)
    p_next = (
        2.0 * p_cur[h:-h, h:-h, h:-h] - p_prev[h:-h, h:-h, h:-h] + vel2 * lap
    )
    return p_next, lap


def run_steps(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor,
              steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-core reference simulation on interior-shaped fields with zero
    BC; the ground truth of the out-of-core engine. Returns interior
    (p_prev, p_cur) after ``steps`` steps."""
    pp, pc = p_prev, p_cur
    for _ in range(steps):
        p_next, _ = wave_step(pad_bc(pp), pad_bc(pc), vel2)
        pp, pc = pc, p_next
    return pp, pc


def ladder_steps(p_prev: torch.Tensor, p_cur: torch.Tensor,
                 vel2: torch.Tensor, steps: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The temporal-blocking ladder: ``steps`` single steps on
    interior-shaped fields, zero BC re-applied every rung. The plain
    version of the multistep kernel (same expression tree per element).
    Same semantics as ``run_steps``."""
    return run_steps(p_prev, p_cur, vel2, steps)


def _host_exp(t: torch.Tensor) -> torch.Tensor:
    """``exp`` of a CPU tensor on the calling thread (numpy's); on a card
    ``torch.exp``.

    On the CPU ``torch.exp`` of 2,048 values or more is cut into chunks
    that the intra-op threads compute in parallel, and under load one
    chunk of a first call was seen to come out at up to 1.5e-4 relative
    error (1 process in ~60 with 8 or more running, a seventh of a
    (96, 12, 12) field, the same error curve each time): a run's initial
    field then differed from the next run's in the same process. numpy's
    ``exp`` gives the same bits on every call."""
    if t.device.type != "cpu":
        return torch.exp(t)
    return torch.from_numpy(np.exp(t.numpy()))


def ricker_source(shape: Tuple[int, int, int], dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Smooth initial condition: a Ricker-like wavelet in the volume
    centre (wave fields representative of the paper's workload). The
    same bits on every call on the CPU (``_host_exp``)."""
    z, y, x = [torch.arange(s, dtype=dtype, device=device) - (s - 1) / 2
               for s in shape]
    r2 = (
        z[:, None, None] ** 2 + y[None, :, None] ** 2 + x[None, None, :] ** 2
    ) / (max(shape) / 8) ** 2
    return (1.0 - 2.0 * r2) * _host_exp(-r2)

"""Public wrappers for the acoustic stencil.

``backend="ref"`` runs the plain PyTorch version (on whatever device
the tensors lie); ``backend="cuda"`` runs the CUDA kernels and needs
CUDA tensors: on CPU tensors it raises.
"""

from __future__ import annotations

from typing import Literal, Tuple

import torch

from repro_torch.device import check_backend
from repro_torch.kernels.stencil import kernel, ref

Backend = Literal["ref", "cuda"]


def wave_step(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor,
              *, backend: Backend = "ref"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step on padded fields -> (p_next interior, lap interior)."""
    check_backend(backend, p_prev, p_cur, vel2)
    if backend == "cuda":
        return kernel.wave_step(p_prev.contiguous(), p_cur.contiguous(),
                                vel2.contiguous())
    return ref.wave_step(p_prev, p_cur, vel2)


def temporal_steps(p_prev: torch.Tensor, p_cur: torch.Tensor,
                   vel2: torch.Tensor, *, steps: int,
                   backend: Backend = "ref"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` fixed-shape time steps on same-shape fields.

    Each step zero-pads by HALO and applies the stencil, so shapes never
    change. Zero padding is the true Dirichlet BC at the volume's
    boundary; at internal out-of-core block boundaries it injects
    garbage that creeps inward HALO planes a step, which is why the
    engine fetches ``steps*HALO`` halo planes. Returns (p_prev, p_cur).
    """
    pp, pc = p_prev, p_cur
    for _ in range(steps):
        pn, _ = wave_step(ref.pad_bc(pp), ref.pad_bc(pc), vel2,
                          backend=backend)
        pp, pc = pc, pn
    return pp, pc


def uses_multistep(backend: str, steps: int, y: int) -> bool:
    """The dispatch rule of ``fused_temporal_steps``: the multistep
    kernel on the CUDA backend for more than one step when the fused
    tile width ``steps * HALO`` divides Y (the reference's rule, whose
    interpret-mode clause has no counterpart here)."""
    return backend == "cuda" and steps > 1 and y % (steps * ref.HALO) == 0


def fused_temporal_steps(p_prev: torch.Tensor, p_cur: torch.Tensor,
                         vel2: torch.Tensor, *, steps: int,
                         backend: Backend = "ref"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal-k entry point: ``steps`` time steps, dispatched by
    ``uses_multistep`` to the multistep kernel or to ``steps``
    single-step calls. Both paths compute the identical per-element
    expression tree, so the dispatch never changes results."""
    check_backend(backend, p_prev, p_cur, vel2)
    if uses_multistep(backend, steps, p_cur.shape[1]):
        return kernel.wave_multistep(p_prev.contiguous(), p_cur.contiguous(),
                                     vel2.contiguous(), steps)
    return temporal_steps(p_prev, p_cur, vel2, steps=steps, backend=backend)

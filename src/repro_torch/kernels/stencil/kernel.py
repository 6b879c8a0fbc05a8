"""Wrappers of the CUDA stencil kernels in ``csrc/stencil.cu`` (float32)
and ``csrc/stencil64.cu`` (float64).

``wave_step`` replaces ``repro.kernels.stencil.kernel.wave_step_pallas``
and ``wave_multistep`` replaces ``wave_multistep_pallas``. The TPU
multistep kernel keeps all rungs of a ``(Z, 3K, X)`` y-tile on chip;
that tile (159 MB at the paper's block) cannot fit an SM, so the Hopper
version runs the ladder's rungs as one launch each over ping-pong
device buffers. Each launch is a 2.5-D z-streaming kernel: a CTA walks
its (y, x) tile along z with the z-neighbours below the centre in a
register queue and p_cur's planes in shared memory, the zero boundary
applied by index instead of ``pad_bc`` copies, any Y. A rung moves 4
arrays (p_prev, p_cur, vel2 in; p_next out); the call's bound is 5
arrays once (1.90 ms at the (240, 1152, 1152) block and 12 steps on an
H100), which only fused rungs could approach: two rungs a launch of
the same design were not faster on the H100, so none are fused. The
single step is the same streaming kernel on padded fields: it reads
their shell as data (no zero by index) and writes ``lap`` too. The TPU
kernels' outputs take ``p_cur``'s dtype; float64 fields launch the
float64 kernels, one thread a (y, x) column walking z (first form).

On a CPU tensor each wrapper runs the plain version (``ref``); on a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches: one per ``wave_step`` call, one per rung of ``wave_multistep``
(``wave_step_f64`` and ``wave_multistep_f64`` for float64).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.stencil import ref
from repro_torch.kernels.stencil.ref import HALO

launches = {"wave_step": 0, "wave_multistep": 0, "wave_step_f64": 0,
            "wave_multistep_f64": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# per field type: the library and the launch counts' suffix
_ROUTE = {torch.float32: ("stencil", ""), torch.float64: ("stencil64", "_f64")}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _require(shape, *tensors: torch.Tensor) -> Tuple[str, str]:
    """Check the fields; returns the route of their type (library,
    launch-count suffix)."""
    for t in tensors:
        if t.dtype not in _ROUTE or t.dtype != tensors[0].dtype:
            raise TypeError("stencil fields must all be float32 or all "
                            f"float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("stencil fields must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError("stencil fields must share one device")
    if tuple(tensors[-1].shape) != tuple(shape):
        raise ValueError(f"vel2 {tuple(tensors[-1].shape)} != {tuple(shape)}")
    return _ROUTE[tensors[0].dtype]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def wave_step(p_prev: torch.Tensor, p_cur: torch.Tensor, vel2: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step on padded (Z+8, Y+8, X+8) ``p_prev``/``p_cur`` and
    interior ``vel2``: (p_next, lap) interior, bit for bit
    ``ref.wave_step``."""
    if p_cur.device.type == "cpu":
        return ref.wave_step(p_prev, p_cur, vel2)
    z, y, x = (s - 2 * HALO for s in p_cur.shape)
    if tuple(p_prev.shape) != tuple(p_cur.shape):
        raise ValueError("p_prev and p_cur must have the same padded shape")
    lib, suffix = _require((z, y, x), p_prev, p_cur, vel2)
    p_next = torch.empty_like(vel2)
    lap = torch.empty_like(vel2)
    symbol = "stencil_wave_step" + suffix
    fn = _build.bind(lib, symbol, [_P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = fn(p_prev.data_ptr(), p_cur.data_ptr(), vel2.data_ptr(),
             p_next.data_ptr(), lap.data_ptr(), z, y, x, _stream())
    _build.check(lib, err, symbol)
    launches["wave_step" + suffix] += 1
    return p_next, lap


def wave_multistep(p_prev: torch.Tensor, p_cur: torch.Tensor,
                   vel2: torch.Tensor, steps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``steps`` steps on interior (Z, Y, X) fields with the zero BC
    re-applied every rung: (p_prev, p_cur) after ``steps`` steps, bit
    for bit ``ref.ladder_steps``. The inputs are not modified."""
    if p_cur.device.type == "cpu":
        return ref.ladder_steps(p_prev, p_cur, vel2, steps)
    shape = tuple(p_cur.shape)
    if len(shape) != 3 or tuple(p_prev.shape) != shape:
        raise ValueError("p_prev, p_cur and vel2 must share one 3-D shape")
    lib, suffix = _require(shape, p_prev, p_cur, vel2)
    symbol = "stencil_wave_rung" + suffix
    fn = _build.bind(lib, symbol, [_P, _P, _P, _P, _I, _I, _I, _P])
    z, y, x = shape
    pp, pc = p_prev, p_cur
    free = []  # buffers of this call no rung still reads
    for _ in range(steps):
        out = free.pop() if free else torch.empty_like(p_cur)
        err = fn(pp.data_ptr(), pc.data_ptr(), vel2.data_ptr(),
                 out.data_ptr(), z, y, x, _stream())
        _build.check(lib, err, symbol)
        launches["wave_multistep" + suffix] += 1
        if pp is not p_prev and pp is not p_cur:
            free.append(pp)
        pp, pc = pc, out
    return pp, pc

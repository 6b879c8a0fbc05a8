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
float64 kernels, the same streaming design in 8-byte values on
``TILE64`` tiles, with Z split into chunks of planes (``z_chunk``) so
that a small volume still fills the card.

On a CPU tensor each wrapper runs the plain version (``ref``); on a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches: one per ``wave_step`` call, one per rung of ``wave_multistep``
(``wave_step_f64`` and ``wave_multistep_f64`` for float64).
"""

from __future__ import annotations

import ctypes
import functools
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
# the float64 kernels' output tile, (y, x) (csrc/stencil64.cu kTY, kTX)
TILE64 = (16, 32)
# the z-split: no chunk shorter than this unless Z is (a chunk re-reads
# the 4 + 4 planes around it)
MIN_ZLEN = 8


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


def z_chunk(z: int, y: int, x: int, slots: int) -> int:
    """Output planes each CTA of the float64 kernels walks, given the
    ``slots`` CTAs the card holds at once (SMs x CTAs an SM). Z is cut
    into ``ceil(Z / z_chunk)`` chunks, the last possibly shorter, so
    that ``TILE64`` tiles x chunks fill the slots in one wave: a CTA
    left for a second wave would run its whole chunk alone. One chunk
    (all of Z) when the tiles alone fill the slots; no chunk length
    below ``MIN_ZLEN`` unless Z is shorter."""
    tiles = -(-y // TILE64[0]) * -(-x // TILE64[1])
    chunks = max(1, min(slots // tiles, z // MIN_ZLEN))
    return max(1, -(-z // chunks))


@functools.lru_cache(maxsize=None)
def slots64(device: torch.device, step: bool) -> int:
    """CTAs of the float64 single step (``step``) or rung that
    ``device`` holds at once: its SMs x the kernel's occupancy."""
    fn = _build.bind("stencil64", "stencil64_ctas_per_sm", [_I])
    with torch.cuda.device(device):
        n = fn(int(step))
    if n < 1:  # minus a CUDA error, or 0
        _build.check("stencil64", -n, "stencil64_ctas_per_sm")
        raise _build.KernelError("the float64 stencil kernels fit no SM")
    return n * torch.cuda.get_device_properties(device).multi_processor_count


def launch_zlen(device: torch.device, shape, step: bool) -> int:
    """The chunk length the float64 single step (``step``) or rung
    launches the interior ``shape`` with on ``device``."""
    return z_chunk(*shape, slots64(device, step))


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
    # float64: the chunk length too
    dims = (z, y, x) + ((launch_zlen(vel2.device, (z, y, x), True),)
                        if suffix else ())
    fn = _build.bind(lib, symbol, [_P] * 5 + [_I] * len(dims) + [_P])
    err = fn(p_prev.data_ptr(), p_cur.data_ptr(), vel2.data_ptr(),
             p_next.data_ptr(), lap.data_ptr(), *dims, _stream())
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
    # float64: the chunk length too
    dims = shape + ((launch_zlen(vel2.device, shape, False),)
                    if suffix else ())
    fn = _build.bind(lib, symbol, [_P] * 4 + [_I] * len(dims) + [_P])
    pp, pc = p_prev, p_cur
    free = []  # buffers of this call no rung still reads
    for _ in range(steps):
        out = free.pop() if free else torch.empty_like(p_cur)
        err = fn(pp.data_ptr(), pc.data_ptr(), vel2.data_ptr(),
                 out.data_ptr(), *dims, _stream())
        _build.check(lib, err, symbol)
        launches["wave_multistep" + suffix] += 1
        if pp is not p_prev and pp is not p_cur:
            free.append(pp)
        pp, pc = pc, out
    return pp, pc

"""Wrapper of the Mamba-1 selective-scan kernel in ``csrc/sscan.cu``.

``selective_scan`` replaces
``repro.kernels.sscan.kernel.selective_scan_pallas``. The TPU kernel
walks ``(B, D-tiles, S-chunks)`` grid steps, the chunk axis in order,
and scans each chunk associatively on a ``(d_tile, N)`` state held in
VMEM. On Hopper each ``(b, d)`` channel's ``N`` states sit in registers
(four lanes of four states at decode, one lane at prefill) and run the
recurrence step by step over a stream staged in shared memory, so there
is no chunk and no ``S % chunk`` or ``D % d_tile`` constraint.

``h_out`` (optional) receives ``h_last`` in place, as the serving cache
wants; it may be ``h0`` itself. On a CPU tensor the wrapper runs the
plain version (``ref``, at ``chunk`` steps a chunk); on a CUDA tensor it
launches the kernel or raises. ``launches["sscan"]`` counts launches,
one per call that reaches the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.sscan import ref

launches = {"sscan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
MAX_STATE = 16  # csrc/sscan.cu kMaxN: the states a channel keeps in registers


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _require(x: torch.Tensor, shape, what: str, dev: torch.device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != dev:
        raise ValueError(f"{what} lies on {x.device}, not {dev}")


def selective_scan(
    dt: torch.Tensor,  # (B, S, D) f32
    a: torch.Tensor,  # (D, N) f32
    b_in: torch.Tensor,  # (B, S, N) f32
    c_in: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, D) f32
    h0: torch.Tensor,  # (B, D, N) f32
    *,
    h_out: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, D), h_last (B, D, N)); ``h_last`` is ``h_out``
    when one is given."""
    if x.device.type == "cpu":
        y, h = ref.selective_scan_ref(dt, a, b_in, c_in, x, h0,
                                      max(1, min(chunk, x.shape[1])))
        if h_out is None:
            return y, h
        return y, h_out.copy_(h)
    bsz, s, d = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the kernel keeps at most {MAX_STATE} states a "
                         f"channel in registers, got N = {n}")
    dev = x.device
    for t, shape, what in ((dt, (bsz, s, d), "dt"), (x, (bsz, s, d), "x"),
                           (a, (d, n), "a"), (b_in, (bsz, s, n), "b_in"),
                           (c_in, (bsz, s, n), "c_in"),
                           (h0, (bsz, d, n), "h0")):
        _require(t, shape, what, dev)
    if h_out is None:
        h_out = torch.empty_like(h0)
    _require(h_out, (bsz, d, n), "h_out", dev)
    y = torch.empty_like(x)
    fn = _build.bind("sscan", "sscan_forward", _ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
             bsz, s, d, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("sscan", err, "sscan_forward")
    launches["sscan"] += 1
    return y, h_out

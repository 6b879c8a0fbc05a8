"""Dispatch and traffic model of the Mamba-1 selective scan.

``backend="ref"`` runs the plain version on whatever device the tensors
lie; ``backend="cuda"`` launches the CUDA kernel and needs CUDA tensors
(on a CPU tensor it raises; it never falls back). ``h_out`` receives
``h_last`` in place on either backend.

When a gradient is wanted (autograd on, an input that requires one),
``backend="cuda"`` goes through ``SelectiveScan``, a
``torch.autograd.Function`` whose forward launches the scan kernel with
its checkpoints and whose backward launches the backward kernel (a
failed build or launch raises); ``backend="ref"`` runs the plain
version under autograd. ``h_out``, the serving cache written in place,
takes no gradient: it raises there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import check_backend
from repro_torch.kernels.sscan import kernel, ref


class SelectiveScan(torch.autograd.Function):
    """``(y, h_last)`` of the scan kernel, differentiable through the
    backward kernel (``kernel.selective_scan_bwd``)."""

    @staticmethod
    def forward(ctx, dt, a, b_in, c_in, x, h0):
        states = torch.empty(kernel.states_shape(*x.shape, a.shape[1]),
                             dtype=torch.float32, device=x.device)
        y, h_last = kernel.selective_scan(dt, a, b_in, c_in, x, h0,
                                          states_out=states)
        ctx.save_for_backward(dt, a, b_in, c_in, x, h0, states)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, gy, gh):
        dt, a, b_in, c_in, x, h0, states = ctx.saved_tensors
        gy = torch.zeros_like(x) if gy is None else gy.contiguous()
        if gh is not None:
            gh = gh.contiguous()
        grads = kernel.selective_scan_bwd(dt, a, b_in, c_in, x, h0, states,
                                          gy, gh)
        return tuple(g if want else None
                     for g, want in zip(grads, ctx.needs_input_grad))


def selective_scan(
    dt: torch.Tensor,  # (B, S, D) f32
    a: torch.Tensor,  # (D, N) f32
    b_in: torch.Tensor,  # (B, S, N) f32
    c_in: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, D) f32
    h0: torch.Tensor,  # (B, D, N) f32
    *,
    chunk: int,
    backend: str = "ref",
    h_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, D), h_last (B, D, N))."""
    check_backend(backend, dt, a, b_in, c_in, x, h0)
    ins = (dt, a, b_in, c_in, x, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        if h_out is not None:
            raise ValueError(
                "h_out (the serving cache, written in place) takes no "
                "gradient: run a scan that needs one without h_out")
        if backend == "cuda":
            return SelectiveScan.apply(*ins)
        return ref.selective_scan_ref(*ins, chunk)
    if backend == "cuda":
        return kernel.selective_scan(dt, a, b_in, c_in, x, h0, h_out=h_out)
    y, h = ref.selective_scan_ref(dt, a, b_in, c_in, x, h0, chunk)
    return y, h if h_out is None else h_out.copy_(h)


def hbm_traffic_bytes(bsz: int, s: int, d: int, n: int,
                      fused: bool) -> int:
    """Per-layer HBM bytes of the selective scan (f32); a copy of
    ``repro.kernels.sscan.ops.hbm_traffic_bytes``."""
    io = bsz * s * (2 * d + 2 * n) * 4  # dt, x, B, C in; y out ~ d
    state_stream = bsz * s * d * n * 4 * 3  # decay+inp write, h read
    return io + (0 if fused else state_stream)

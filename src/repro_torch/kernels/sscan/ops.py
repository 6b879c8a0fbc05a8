"""Dispatch and traffic model of the Mamba-1 selective scan.

``backend="ref"`` runs the plain version on whatever device the tensors
lie; ``backend="cuda"`` launches the CUDA kernel and needs CUDA tensors
(on a CPU tensor it raises; it never falls back). ``h_out`` receives
``h_last`` in place on either backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import check_backend
from repro_torch.kernels.sscan import kernel, ref


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

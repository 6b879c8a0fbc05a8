"""Selective state-space mixer, Mamba-1 (falcon-mamba).

Port of the Mamba-1 half of ``repro.models.ssm``: ``causal_conv``,
``MambaState``, ``mamba1_seq`` and ``mamba1_init_state``. The scan goes
through ``kernels.sscan.ops.selective_scan``: on a CUDA device with
``backend="cuda"`` that launches the hand-written kernel on every call,
one token or a whole prompt (the reference's model runs the XLA form
``chunked_selective_scan`` instead, which stays here as the kernel's
plain version).

The layer parameters are read as attributes (``p.in_proj``,
``p.conv_w``, ...) with the reference's names and layouts, and
``A_log`` and ``D`` are float32 whatever the model's type.

Not ported yet (ROADMAP queue 1 item 18): the Mamba-2/SSD half
(``ssd_chunked``, ``mamba2_seq``, ``chunked_linear_scan``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.sscan import ops as sscan_ops


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B, S, D), w: (D, K)."""
    k = w.shape[1]
    s = x.shape[1]
    out = x * w[:, k - 1]
    for j in range(1, k):
        shifted = F.pad(x, (0, 0, j, 0))[:, :s]
        out = out + shifted * w[:, k - 1 - j]
    return out + b


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, K-1, D_in) trailing inputs
    h: torch.Tensor  # (B, D_in, N) f32


def mamba1_seq(p, x: torch.Tensor, *, chunk: int,
               state: Optional[MambaState] = None, backend: str = "ref",
               h_out: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (y (B, S, d), new MambaState). ``h_out``, when
    given, receives the new ``h`` in place (it may be ``state.h``)."""
    bsz, s, _ = x.shape
    di, n = p.A_log.shape
    k = p.conv_w.shape[1]
    xz = x @ p.in_proj
    xi, z = xz.chunk(2, dim=-1)
    if state is not None:
        hist = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
        conv_in = hist[:, -(s + k - 1):]
        xi_c = causal_conv(conv_in, p.conv_w, p.conv_b)[:, -s:]
        new_conv = hist[:, -(k - 1):]
    else:
        xi_c = causal_conv(xi, p.conv_w, p.conv_b)
        new_conv = xi[:, -(k - 1):]
    xi_c = F.silu(xi_c)
    proj = xi_c @ p.x_proj
    dtr = p.dt_w.shape[0]
    dt_in, bc = proj[..., :dtr], proj[..., dtr:]
    b_in, c_in = bc.chunk(2, dim=-1)  # (B, S, N)
    dt = F.softplus(dt_in @ p.dt_w + p.dt_b)  # (B, S, di)
    a = -torch.exp(p.A_log.float())  # (di, N)
    h0 = state.h if state is not None else torch.zeros(
        (bsz, di, n), dtype=torch.float32, device=x.device)
    xf = xi_c.float()
    y, h_last = sscan_ops.selective_scan(
        dt.float().contiguous(), a, b_in.float().contiguous(),
        c_in.float().contiguous(), xf.contiguous(), h0,
        chunk=min(chunk, s), backend=backend, h_out=h_out)
    y = y + p.D.float() * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ p.out_proj, MambaState(new_conv, h_last)


def mamba1_init_state(p, bsz: int, dtype: torch.dtype) -> MambaState:
    di, n = p.A_log.shape
    k = p.conv_w.shape[1]
    dev = p.A_log.device
    return MambaState(
        conv=torch.zeros((bsz, k - 1, di), dtype=dtype, device=dev),
        h=torch.zeros((bsz, di, n), dtype=torch.float32, device=dev),
    )

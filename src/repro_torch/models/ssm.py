"""Selective state-space mixers: Mamba-1 (falcon-mamba) and Mamba-2/SSD
(zamba2).

Port of ``repro.models.ssm``: ``causal_conv``, ``MambaState``,
``mamba1_seq`` / ``mamba1_init_state``, and the Mamba-2 half,
``chunked_linear_scan``, ``ssd_chunked``, ``mamba2_seq`` /
``mamba2_init_state``. The Mamba-1 scan goes through
``kernels.sscan.ops.selective_scan``: on a CUDA device with
``backend="cuda"`` that launches the hand-written kernel on every call,
one token or a whole prompt (the reference's model runs the XLA form
``chunked_selective_scan`` instead, which stays here as the kernel's
plain version). Mamba-2 is plain PyTorch, as the reference's is XLA:
``ssd_chunked`` is the chunked matmul form of SSD (Dao & Gu,
arXiv:2405.21060 §6), whose only intermediates are the (B, H, c, c)
Gram matrices and the (B, H, P, N) chunk-boundary states.

The layer parameters are read as attributes (``p.in_proj``,
``p.conv_w``, ...) with the reference's names and layouts, and
``A_log`` and ``D`` are float32 whatever the model's type.

Copied from the reference: the Mamba-2 short conv acts on ``x`` only
(not on ``[x, B, C]``), its documented simplification. One deliberate
difference: the reference's ``ssd_chunked`` takes
``where(mask, exp(ldiff), 0)`` of the within-chunk log-decay
differences, whose entries above the diagonal are positive sums of
``dt * |a|`` and overflow ``exp`` once a chunk decays by more than ~88
nats; the forward stays finite (they are masked out), but the gradient
through the ``where`` is 0 * inf = NaN. Here the exponent is taken of
the masked difference, ``exp(where(mask, ldiff, 0))``, and the masked
entries zeroed after: the kept entries are the same inputs to the same
``exp``, so the forward is the reference's, and the gradient stays
finite (``tests/test_torch_ssm.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.sscan import ops as sscan_ops
from repro_torch.kernels.sscan.ref import _scan_pairs


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
    h: torch.Tensor  # (B, D_in, N) f32  (Mamba-2: (B, H, P, N))


def _chunks(t: torch.Tensor, chunk: int, value: float = 0.0) -> torch.Tensor:
    """``t`` (B, S, ...) padded along S with ``value`` to whole chunks and
    split as (nc, B, chunk, ...)."""
    bsz, s = t.shape[0], t.shape[1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)
    return t.reshape((bsz, nc, chunk) + t.shape[2:]).movedim(1, 0)


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int):
    """h_t = a_t * h_{t-1} + b_t along axis 1. a, b: (B, S, ...);
    h0: (B, ...). Returns (h (B, S, ...), h_last). An outer loop over the
    chunks carries ``h``; inside a chunk an inclusive scan of the
    ``(a, b)`` pairs by doubling. ``a`` is padded with 1 and ``b`` with
    0, so ``h_last`` is the state after the last real step."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    bsz, s = shape[0], shape[1]
    h, hs = h0, []
    for a_k, b_k in zip(_chunks(a, chunk, 1.0), _chunks(b, chunk)):
        acum, bcum = _scan_pairs(a_k, b_k, 1)
        h_chunk = acum * h[:, None] + bcum
        hs.append(h_chunk)
        h = h_chunk[:, -1]
    return torch.cat(hs, dim=1)[:, :s], h


def ssd_chunked(
    dt: torch.Tensor,  # (B, S, H) f32
    a: torch.Tensor,  # (H,) f32 negative decay rates
    b_in: torch.Tensor,  # (B, S, G, N) f32
    c_in: torch.Tensor,  # (B, S, G, N) f32
    x: torch.Tensor,  # (B, S, H, P) f32
    h0: torch.Tensor,  # (B, H, P, N) f32
    chunk: int,
):
    """Mamba-2 / SSD in the chunked matmul form: within a chunk
    ``Y[i] = sum_{j<=i} C_i B_j^T decay(j..i) dt_j x_j`` plus the
    carried state's contribution, and the state handed on at the chunk's
    end. ``dt`` and ``x`` (and ``B``, ``C``) are padded with 0: a padded
    step neither decays nor adds. Returns (y (B, S, H, P), h_last)."""
    bsz, s, nh = dt.shape
    rep = nh // b_in.shape[2]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=dt.device).tril()[None, :, :, None]
    hst, ys = h0, []
    for dt_c, b_c, c_c, x_c in zip(*(_chunks(t, chunk)
                                     for t in (dt, b_in, c_in, x))):
        cum = torch.cumsum(dt_c * a, dim=1)  # (B, c, H), inclusive
        bh = b_c.repeat_interleave(rep, dim=2)  # (B, c, H, N)
        ch = c_c.repeat_interleave(rep, dim=2)
        gram = torch.einsum("bihn,bjhn->bhij", ch, bh)
        ldiff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, i, j, H)
        # exp of the masked difference (finite above the diagonal), then
        # the masked entries zeroed: the module docstring says why
        decay_ij = torch.where(
            mask, torch.exp(torch.where(mask, ldiff, 0.0)), 0.0)
        w = gram * decay_ij.permute(0, 3, 1, 2)  # (B, H, i, j)
        xdt = x_c * dt_c[..., None]  # (B, c, H, P)
        y_intra = torch.einsum("bhij,bjhp->bihp", w, xdt)
        dec_to = torch.exp(cum)  # chunk start to i, inclusive
        y_inter = torch.einsum("bihn,bhpn->bihp", ch * dec_to[..., None], hst)
        dec_from = torch.exp(cum[:, -1:, :] - cum)  # j to the chunk's end
        hst = (torch.exp(cum[:, -1])[..., None, None] * hst
               + torch.einsum("bjhp,bjhn->bhpn", xdt,
                              bh * dec_from[..., None]))
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :s], hst


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


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------


def mamba2_seq(p, x: torch.Tensor, *, chunk: int, ngroups: int,
               ssm_state: int, state: Optional[MambaState] = None,
               h_out: Optional[torch.Tensor] = None):
    """Scalar-decay-per-head SSD. x: (B, S, d) -> (y (B, S, d), new
    MambaState). ``h_out``, when given, receives the new ``h`` in place
    (it may be ``state.h``)."""
    bsz, s, _ = x.shape
    nheads = p.A_log.shape[0]
    di, k = p.conv_w.shape
    hp = di // nheads
    g, n = ngroups, ssm_state
    zxbcdt = x @ p.in_proj
    z, xi, bc, dt_in = torch.split(zxbcdt, [di, di, 2 * g * n, nheads],
                                   dim=-1)
    if state is not None:
        hist = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
        conv_in = hist[:, -(s + k - 1):]
        xi = causal_conv(conv_in, p.conv_w, p.conv_b)[:, -s:]
        new_conv = hist[:, -(k - 1):]
    else:
        new_conv = xi[:, -(k - 1):]
        xi = causal_conv(xi, p.conv_w, p.conv_b)
    xi = F.silu(xi)
    b_in, c_in = bc.chunk(2, dim=-1)  # (B, S, G * N)
    b_in = b_in.reshape(bsz, s, g, n)
    c_in = c_in.reshape(bsz, s, g, n)
    dt = F.softplus(dt_in + p.dt_b)  # (B, S, H)
    a = -torch.exp(p.A_log.float())  # (H,)
    xh = xi.reshape(bsz, s, nheads, hp).float()
    h0 = state.h if state is not None else torch.zeros(
        (bsz, nheads, hp, n), dtype=torch.float32, device=x.device)
    y, h_last = ssd_chunked(dt.float(), a, b_in.float(), c_in.float(), xh,
                            h0, min(chunk, s))
    if h_out is not None:
        h_out.copy_(h_last)
        h_last = h_out
    y = y + p.D.float()[:, None] * xh
    y = y.reshape(bsz, s, di).to(x.dtype) * F.silu(z)
    return y @ p.out_proj, MambaState(new_conv, h_last)


def mamba2_init_state(p, bsz: int, dtype: torch.dtype,
                      ssm_state: int) -> MambaState:
    nheads = p.A_log.shape[0]
    di, k = p.conv_w.shape
    dev = p.A_log.device
    return MambaState(
        conv=torch.zeros((bsz, k - 1, di), dtype=dtype, device=dev),
        h=torch.zeros((bsz, nheads, di // nheads, ssm_state),
                      dtype=torch.float32, device=dev),
    )

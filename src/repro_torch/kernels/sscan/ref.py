"""Plain PyTorch version of the Mamba-1 selective scan.

A port of ``repro.models.ssm.chunked_selective_scan`` (which
``repro.kernels.sscan.ref`` re-exports as the oracle of the TPU kernel
``selective_scan_pallas``): pad S to a whole number of chunks, run an
outer loop over the chunks carrying ``h``, and inside each chunk an
inclusive scan of the pairs ``(decay, inp)`` under
``(al, bl) . (ar, br) = (al * ar, bl * ar + br)``, written as a
log-depth doubling (Hillis-Steele) over the chunk's steps. The
``(B, c, D, N)`` temporaries exist only inside the chunk loop, as in the
reference. The padded steps have ``dt = 0``: decay 1 and input 0, so
``h_last`` is the state after the last real step.

The doubling multiplies in another order than XLA's
``associative_scan``; the two agree within float32 rounding (the
tolerance of ``tests/test_sscan_kernel.py``, rtol 1e-4 / atol 1e-5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _scan_pairs(a: torch.Tensor, b: torch.Tensor, dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` pairs along ``dim`` by doubling:
    after the pass with offset k, position i holds the combination of
    steps ``max(0, i - 2k + 1) .. i``."""
    n = a.shape[dim]
    k = 1
    while k < n:
        a_lo, b_lo = a.narrow(dim, 0, n - k), b.narrow(dim, 0, n - k)
        a_hi, b_hi = a.narrow(dim, k, n - k), b.narrow(dim, k, n - k)
        b = torch.cat([b.narrow(dim, 0, k), b_lo * a_hi + b_hi], dim)
        a = torch.cat([a.narrow(dim, 0, k), a_lo * a_hi], dim)
        k *= 2
    return a, b


def selective_scan_ref(
    dt: torch.Tensor,  # (B, S, D) f32, per-channel step sizes
    a: torch.Tensor,  # (D, N) f32, negative decay rates
    b_in: torch.Tensor,  # (B, S, N) f32
    c_in: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, D) f32
    h0: torch.Tensor,  # (B, D, N) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t``,
    ``y_t = sum_n C_t,n h_t,n``. Returns (y (B, S, D), h_last (B, D, N))."""
    bsz, s, d = x.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def pad_c(t):
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    dt, b_in, c_in, x = (pad_c(t) for t in (dt, b_in, c_in, x))
    h = h0
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        dt_c, b_c, c_c, x_c = dt[:, sl], b_in[:, sl], c_in[:, sl], x[:, sl]
        decay = torch.exp(dt_c[..., None] * a)  # (B, c, D, N)
        inp = dt_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
        acum, bcum = _scan_pairs(decay, inp, 1)
        h_chunk = acum * h[:, None] + bcum  # (B, c, D, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_chunk, c_c))
        h = h_chunk[:, -1]
        del decay, inp, acum, bcum, h_chunk
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h.contiguous()


def boundary_states(dt, a, b_in, c_in, x, h0, every: int) -> torch.Tensor:
    """The state before every ``every`` steps, (B, ceil(S / every), D,
    N): the plain version of the checkpoints the CUDA forward saves for
    its backward."""
    bsz, s, d = x.shape
    states, h = [], h0
    for t0 in range(0, s, every):
        states.append(h)
        sl = slice(t0, t0 + every)
        _, h = selective_scan_ref(dt[:, sl], a, b_in[:, sl], c_in[:, sl],
                                  x[:, sl], h, every)
    if not states:
        return h0.new_zeros((bsz, 0, d, a.shape[1]))
    return torch.stack(states, dim=1)


def selective_scan_bwd_ref(dt, a, b_in, c_in, x, h0, gy,
                           gh: Optional[torch.Tensor], chunk: int
                           ) -> Tuple[torch.Tensor, ...]:
    """The plain version of the backward kernel: autograd of
    ``selective_scan_ref`` at ``chunk``. Returns ``(ddt, da, db_in,
    dc_in, dx, dh0)`` of ``y`` under ``gy`` and ``h_last`` under ``gh``
    (None: no gradient reaches ``h_last``)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (dt, a, b_in, c_in, x, h0)]
        y, h = selective_scan_ref(*ins, chunk)
        outs, grads = [y], [gy]
        if gh is not None:
            outs.append(h)
            grads.append(gh)
        return torch.autograd.grad(outs, ins, grads)


def selective_scan_f64(
    dt: torch.Tensor,  # (B, S, D)
    a: torch.Tensor,  # (D, N)
    b_in: torch.Tensor,  # (B, S, N)
    c_in: torch.Tensor,  # (B, S, N)
    x: torch.Tensor,  # (B, S, D)
    h0: torch.Tensor,  # (B, D, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same recurrence step by step in float64: the yardstick both
    float32 versions (the kernel, step by step; ``selective_scan_ref``,
    chunked) are measured against. Returns float64 (y, h_last)."""
    dt, a, b_in, c_in, x, h = (t.double() for t in (dt, a, b_in, c_in, x,
                                                     h0))
    ys = []
    for t in range(x.shape[1]):
        dtt = dt[:, t, :, None]
        h = torch.exp(dtt * a) * h + dtt * b_in[:, t, None, :] * x[:, t, :,
                                                                   None]
        ys.append((h * c_in[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h

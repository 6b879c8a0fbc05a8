"""Wrapper: fused compressed-history attention + raw-tail merge.

``backend="ref"`` runs the kernel's plain version on whatever device
the tensors lie; ``backend="cuda"`` launches the CUDA kernel and needs
CUDA tensors (on a CPU tensor it raises; it never falls back). The
raw-tail partials and their merge with the history's are a few
elementwise ops, which the reference also ran outside its kernel; the
kernel's per-split partials and the tail's are merged in one step.
"""

from __future__ import annotations

import torch

from repro_torch.device import check_backend
from repro_torch.kernels.cdecode import kernel, ref
from repro_torch.models.kvcache import CHUNK, CompressedKV
from repro_torch.models.layers import scale_in


def history_inputs(q: torch.Tensor, ckv: CompressedKV):
    """The kernel's arguments for ``q`` (B, 1, H, D) over ``ckv``:
    ``(payload_k, emax_k, payload_v, emax_v, q_scaled, hist_len)`` with
    rows ``B * KVH``, and its keyword arguments but ``planes``."""
    b, _, h, d = q.shape
    kvh = ckv.tail_k.shape[2]
    qpk = h // kvh
    qr = (q.reshape(b, kvh, qpk, d).float()
          * scale_in(d, torch.float32)).reshape(b * kvh, qpk, d)
    w = ckv.payload_k.shape[-1]
    args = (ckv.payload_k.reshape(b * kvh, -1, w),
            ckv.emax_k.reshape(b * kvh, -1),
            ckv.payload_v.reshape(b * kvh, -1, w),
            ckv.emax_v.reshape(b * kvh, -1),
            qr, (ckv.length // CHUNK) * CHUNK)
    return args, dict(head_dim=d, qpk=qpk)


def fused_compressed_decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    ckv: CompressedKV,
    *,
    planes: int,
    max_len: int,
    backend: str = "ref",
) -> torch.Tensor:
    check_backend(backend, q, ckv.payload_k)
    b, _, h, d = q.shape
    kvh = ckv.tail_k.shape[2]
    qpk = h // kvh
    args, kw = history_inputs(q, ckv)
    qr, hist_len = args[4], args[5]
    if backend == "cuda":  # (B*KVH, splits, ...)
        m_h, l_h, acc_h = kernel.cdecode_partials(*args, planes=planes, **kw)
    else:
        m_h, l_h, acc_h = (x.unsqueeze(1) for x in
                           ref.fused_cdecode_attention_ref(
                               *args, planes=planes, **kw))
    # raw tail window partials
    tail_pos = ckv.length - hist_len
    tk = ckv.tail_k.float()  # (B, CHUNK, KVH, D)
    tv = ckv.tail_v.float()
    qb = qr.reshape(b, kvh, qpk, d)
    logits = torch.einsum("bgqd,btgd->bgqt", qb, tk)
    valid = torch.arange(CHUNK, device=q.device) < tail_pos
    logits = logits.masked_fill(~valid, float("-inf"))
    m_t = logits.amax(dim=-1)
    m_t_safe = torch.where(torch.isfinite(m_t), m_t, 0.0)
    p = torch.where(valid, torch.exp(logits - m_t_safe[..., None]), 0.0)
    l_t = p.sum(dim=-1)
    acc_t = torch.einsum("bgqt,btgd->bgqd", p, tv)
    # merge the history's splits and the tail, one softmax state each
    rows = b * kvh
    _, l, acc = ref.merge(
        torch.cat([m_h, m_t.reshape(rows, 1, qpk)], dim=1),
        torch.cat([l_h, l_t.reshape(rows, 1, qpk)], dim=1),
        torch.cat([acc_h, acc_t.reshape(rows, 1, qpk, d)], dim=1), dim=1,
    )
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)

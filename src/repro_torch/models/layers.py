"""Shared neural layers: norms, RoPE/M-RoPE, blocked attention
(training and prefill), the per-slot cache write, decode attention over
a raw KV cache, GLU.

Port of ``repro.models.layers``. The reference's promotions are kept:
norms and RoPE angles, sin and cos are computed in float32 and cast back
to the input's type; where the reference asks an einsum for float32
output on bfloat16 operands (``preferred_element_type=f32``), the
operands are cast to float32 first (a bfloat16 product is exact in
float32), so scores are not rounded to bfloat16. ``blocked_attention``
is the reference's online softmax over KV chunks, in plain PyTorch (it
is XLA in the reference, not a Pallas kernel), differentiable.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def norm(x: torch.Tensor, scale: torch.Tensor, eps: float, kind: str
         ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, scale, eps)
    return layer_norm(x, scale, eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Sequence[int] = ()) -> torch.Tensor:
    """x: (B, S, H, D). positions: (B, S) integers, or (3, B, S) for
    M-RoPE (temporal/height/width position streams, qwen2-vl §2.1)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)  # (d/2,)
    if mrope_sections:
        if positions.dim() != 3:
            raise ValueError("M-RoPE needs (3, B, S) positions")
        secs, start = [], 0
        for si, sec in enumerate(mrope_sections):
            secs.append(positions[si][:, :, None].float()
                        * inv[start:start + sec])
            start += sec
        ang = torch.cat(secs, dim=-1)  # (B, S, d/2)
    else:
        ang = positions[:, :, None].float() * inv  # (B, S, d/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked causal attention (training / prefill)
# ---------------------------------------------------------------------------


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, S, KVH, QPK, D), k: (B, T, KVH, D) -> (B, KVH, QPK, S, T),
    float32 (products of the inputs' type, accumulated in float32)."""
    return torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float())


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      kv_chunk: int, causal: bool = True) -> torch.Tensor:
    """Online-softmax attention over KV chunks; O(S * chunk) memory.
    q: (B, S, H, D); k, v: (B, S, KVH, D). Returns (B, S, H, D) float32.
    Masked scores are -inf; a row with nothing visible yet keeps zero
    weight and a zero correction, as in the reference."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qpk = h // kvh
    qr = q.reshape(b, s, kvh, qpk, d) * scale_in(d, q.dtype)
    nchunk = -(-s // kv_chunk)
    pad = nchunk * kv_chunk - s
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = torch.arange(s, device=q.device)
    m = torch.full((b, kvh, qpk, s), float("-inf"), device=q.device)
    l = torch.zeros((b, kvh, qpk, s), device=q.device)
    acc = torch.zeros((b, kvh, qpk, s, d), device=q.device)
    for ci in range(nchunk):
        kblk = kp[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vblk = vp[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        logits = _gqa_logits(qr, kblk)
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=q.device)
        if causal:
            mask = kpos[None, :] <= qpos[:, None]
        else:
            mask = (kpos[None, :] < s).expand(s, kv_chunk)
        mask = mask & (kpos[None, :] < s)
        logits = torch.where(mask, logits, float("-inf"))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        finite = torch.isfinite(m)
        corr = torch.exp(torch.where(finite, m - m_safe, float("-inf")))
        corr = torch.where(finite, corr, 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bgqst,btgd->bgqsd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


# ---------------------------------------------------------------------------
# Decode attention over a raw cache
# ---------------------------------------------------------------------------


def scale_in(head_dim: int, dtype: torch.dtype) -> float:
    """``1/sqrt(head_dim)`` rounded to ``dtype``, as the reference's
    ``jnp.asarray(1.0 / np.sqrt(d), q.dtype)``; multiplying a tensor of
    that type by it rounds once, as the reference does."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def batched_cache_update(cache: torch.Tensor, new: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, KVH, D) into ``cache`` (B, Smax, KVH, D) at
    per-slot position ``idx`` (B,): per-slot continuous batching.
    Unlike the reference, writes ``cache`` in place and returns it."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx.to(cache.device).long()] = new[:, 0].to(cache.dtype)
    return cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, 1, H, D); caches (B, Smax, KVH, D); ``length`` (B,) per-slot
    fill, the new token already in. Scores and output accumulate in
    float32; the output has q's type."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qpk = h // kvh
    qr = q.reshape(b, kvh, qpk, d) * scale_in(d, q.dtype)
    logits = torch.einsum("bgqd,btgd->bgqt", qr.float(), k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < length.to(q.device)[:, None]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgqt,btgd->bgqd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GLU MLP
# ---------------------------------------------------------------------------


def glu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    h = logical(h, "batch", "seq", "mlp")
    return h @ w_down

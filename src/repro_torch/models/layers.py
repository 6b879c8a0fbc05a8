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

from repro_torch.distributed.sharding import is_dtensor, logical

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
    qr = divisible_shards(q, 2, kvh).reshape(b, s, kvh, qpk, d) * scale_in(
        d, q.dtype)
    nchunk = -(-s // kv_chunk)
    pad = nchunk * kv_chunk - s
    # no pad where the chunks tile the sequence (the same values; the
    # card's torch 2.11 cannot place a pad of a sharded tensor)
    kp = F.pad(k, (0, 0, 0, 0, 0, pad)) if pad else k
    vp = F.pad(v, (0, 0, 0, 0, 0, pad)) if pad else v
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
    return merged(out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d), 2, kvh)


# ---------------------------------------------------------------------------
# Decode attention over a raw cache
# ---------------------------------------------------------------------------


def scale_in(head_dim: int, dtype: torch.dtype) -> float:
    """``1/sqrt(head_dim)`` rounded to ``dtype``, as the reference's
    ``jnp.asarray(1.0 / np.sqrt(d), q.dtype)``; multiplying a tensor of
    that type by it rounds once, as the reference does."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=dtype))


def divisible_shards(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t`` ready to have dimension ``dim`` split into ``parts`` leading
    pieces: a DTensor sharded there over a mesh axis whose size does not
    divide ``parts`` is first replicated along that axis (DTensor cannot
    split an unevenly sharded dimension; the resolved spec of the pieces
    replicates there too). A plain tensor is ``t`` itself."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(t):
        return t
    dim %= t.ndim
    mesh, pl = t.device_mesh, list(t.placements)
    keep = [Replicate() if p.is_shard(dim) and parts % mesh.size(i) else p
            for i, p in enumerate(pl)]
    return t if keep == pl else t.redistribute(mesh, keep)


class _GradDivisible(torch.autograd.Function):
    """The identity, whose backward makes the gradient
    ``divisible_shards``: the gradient of a merge of dimensions is split
    again by the merge's backward."""

    @staticmethod
    def forward(ctx, t, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return divisible_shards(grad, ctx.dim, ctx.parts), None, None


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    placements of the forward's tensor (a partial sum is reduced first)."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if grad.placements == ctx.placements:
            return grad
        return grad.redistribute(ctx.mesh, ctx.placements)


def grad_placed(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient over DTensors arrives in ``t``'s own
    placements: a gradient that reaches it as a partial sum (from a
    Mamba layer's backward) cannot be turned into the masked partial an
    embedding's backward takes. A plain tensor is ``t`` itself."""
    if not is_dtensor(t) or not t.requires_grad:
        return t
    return _GradPlaced.apply(t)


def merged(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t``, the result of merging ``parts`` leading pieces into
    dimension ``dim``, made safe for its gradient: over DTensors the
    gradient is ``divisible_shards`` before the merge's backward splits
    it. A plain tensor is ``t`` itself."""
    if not is_dtensor(t) or not t.requires_grad:
        return t
    return _GradDivisible.apply(t, dim, parts)


def _on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, moved only if it is elsewhere (a DTensor's
    ``.to(device)`` raises under inference mode, even to its own)."""
    return t if t.device == dev else t.to(dev)


def batched_cache_update(cache: torch.Tensor, new: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, KVH, D) into ``cache`` (B, Smax, KVH, D) at
    per-slot position ``idx`` (B,): per-slot continuous batching.
    Unlike the reference, writes ``cache`` in place and returns it. A
    sharded cache (a DTensor over batch and positions) is written
    shard by shard (``_sharded_cache_update``)."""
    if is_dtensor(cache):
        return _sharded_cache_update(cache, new, idx)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, _on_device(idx, cache.device).long()] = new[:, 0].to(
        cache.dtype)
    return cache


def _sharded_cache_update(cache, new, idx):
    """``batched_cache_update`` on each rank's shard of a DTensor cache:
    a slot whose position lies in the shard's positions is written
    there; elsewhere the shard's own row at the clamped position is
    written back, so no shape depends on the data."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, cache.placements
    local_shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, pl)
    row_pl = [p if p.is_shard(0) else Replicate() for p in pl]
    new_pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
              for p in pl]

    def write(c, n, i):
        rows = torch.arange(c.shape[0], device=c.device)
        at = i.long() - offset[1]
        here = (at >= 0) & (at < local_shape[1])
        at = at.clamp(0, local_shape[1] - 1)
        val = torch.where(here[:, None, None], n[:, 0].to(c.dtype),
                          c[rows, at])
        c[rows, at] = val
        return c

    return local_map(write, out_placements=list(pl),
                     in_placements=(pl, new_pl, row_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        cache, new, idx)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, 1, H, D); caches (B, Smax, KVH, D); ``length`` (B,) per-slot
    fill, the new token already in. Scores and output accumulate in
    float32; the output has q's type."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[2]
    qpk = h // kvh
    qr = divisible_shards(q, 2, kvh).reshape(b, kvh, qpk, d) * scale_in(
        d, q.dtype)
    logits = torch.einsum("bgqd,btgd->bgqt", qr.float(), k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, :] < _on_device(length, q.device)[:, None]
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

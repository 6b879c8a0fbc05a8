"""Plain PyTorch version of the fused ZFP-decode + flash-decode kernel.

``fused_cdecode_attention_ref`` computes what
``repro.kernels.cdecode.kernel.fused_cdecode_attention`` computes: per
(batch x kv-head) row, per 64-token chunk of the compressed history,
decode the K and V chunks (the codec's plain version: ``unpack_planes``
-> ``from_negabinary`` -> ``inv_transform(., 2)`` -> ``from_fixedpoint``,
the blocks arranged as the TPU kernel's ``_decode_tile``), take the
logits ``q . K^T`` masked by ``hist_len``, and run the online softmax
chunk by chunk. It returns the flash-decoding partials ``(m, l, acc)``.

Chunks at or past ``hist_len`` contribute exactly nothing (``m``
unchanged, ``p = 0``, ``corr = 1``, or 0 while ``m`` is still
``-inf``), so they are skipped. ``merge`` combines partial states with
the reference's guarded formulas; the ops wrapper merges the history's
splits and the raw tail window with it in one step.

``reference`` is the compositional oracle (decompress, then attend).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.zfp import ref as zref
from repro_torch.models.kvcache import CHUNK, _nb_per_chunk
from repro_torch.models.kvcache import compressed_decode_attention as reference

__all__ = ["decode_tiles", "fused_cdecode_attention_ref", "merge",
           "reference"]

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def live_chunks(hist_len: int, nchunks: int) -> int:
    """Chunks that hold at least one of the first ``hist_len`` tokens."""
    return min(nchunks, -(-max(hist_len, 0) // CHUNK))


def decode_tiles(payload: torch.Tensor, emax: torch.Tensor, planes: int,
                 head_dim: int) -> torch.Tensor:
    """(BG, n*nbc, W) payload and (BG, n*nbc) emax -> (BG, n*CHUNK, D)
    float32: each chunk's (16, D/4) grid of 4x4 blocks decoded and laid
    out as ``(sb, db, 4, 4) -> transpose(0, 2, 1, 3) -> (CHUNK, D)``."""
    bg, nb, w = payload.shape
    words = payload.view(torch.int32).reshape(-1, w)
    u = zref.unpack_planes(words, planes, 2)
    c = zref.from_negabinary(u)
    q = zref.inv_transform(c, 2)
    x = zref.from_fixedpoint(q, emax.reshape(-1))  # (bg * nb, 16)
    sb, db = CHUNK // 4, head_dim // 4
    n = nb // (sb * db)
    x = x.reshape(bg, n, sb, db, 4, 4).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(bg, n * CHUNK, head_dim)


def fused_cdecode_attention_ref(
    payload_k: torch.Tensor,  # (BG, NB, W) uint32
    emax_k: torch.Tensor,  # (BG, NB) int32
    payload_v: torch.Tensor,
    emax_v: torch.Tensor,
    q_scaled: torch.Tensor,  # (BG, QPK, D) float32, pre-scaled
    hist_len: int,  # compressed tokens valid
    *,
    planes: int,
    head_dim: int,
    qpk: int,
) -> Partials:
    """Flash-decoding partials ``(m, l (BG, QPK), acc (BG, QPK, D))``
    over the compressed history; the caller merges the raw tail."""
    bg = payload_k.shape[0]
    nbc = _nb_per_chunk(head_dim)
    live = live_chunks(int(hist_len), payload_k.shape[1] // nbc)
    dev = q_scaled.device
    m = torch.full((bg, qpk), float("-inf"), device=dev)
    l = torch.zeros((bg, qpk), device=dev)
    acc = torch.zeros((bg, qpk, head_dim), device=dev)
    if live == 0:
        return m, l, acc
    n = live * nbc
    k = decode_tiles(payload_k[:, :n], emax_k[:, :n], planes, head_dim)
    v = decode_tiles(payload_v[:, :n], emax_v[:, :n], planes, head_dim)
    for ci in range(live):
        rows = slice(ci * CHUNK, (ci + 1) * CHUNK)
        logits = torch.einsum("gqd,gtd->gqt", q_scaled, k[:, rows])
        valid = ci * CHUNK + torch.arange(CHUNK, device=dev) < hist_len
        logits = logits.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, torch.exp(logits - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        m = m_new
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("gqt,gtd->gqd", p,
                                                   v[:, rows])
    return m, l, acc


def merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, dim: int
          ) -> Partials:
    """Merge softmax partial states stacked along ``dim`` of ``m`` and
    ``l`` (and of ``acc``, whose last axis is D): the reference's
    guarded formulas (a state with ``m = -inf`` weighs 0)."""
    m_all = m.amax(dim=dim)
    m_safe = torch.where(torch.isfinite(m_all), m_all, 0.0)
    c = torch.where(torch.isfinite(m), torch.exp(m - m_safe.unsqueeze(dim)),
                    0.0)
    return (m_all, (l * c).sum(dim=dim),
            (acc * c[..., None]).sum(dim=dim))

"""Fixed-rate compressed KV cache: the paper's separate-compression idea
applied to the decode memory boundary.

Port of ``repro.models.kvcache``. The KV sequence is stored as
*compressed chunks* (4x4 ZFP blocks over (seq, head_dim), independently
addressable: new chunks append without touching old ones, the
dependency fix of paper §V-A) plus a raw *tail window* of the most
recent tokens (the "common region" still being written). Appending a
token writes the tail; when the tail fills a chunk, that chunk is
encoded once and never revisited.

Differences from the reference, none of them in the numbers:

* ``length`` is a host ``int``, so deciding a flush needs no device
  sync; the flush is a Python branch where the reference computes both
  branches under ``lax.cond``.
* ``append_token`` updates the cache tensors **in place** (tail write,
  chunk encode, tail reset) and returns the cache with ``length + 1``.
* A chunk is encoded with ``zfp.ops.compress(..., ndim=2)`` on the
  backend the caller names, so on the card a flush launches the codec's
  encode kernel.

The cache is slot-synchronous, as in the reference: one ``length`` for
all slots, every slot's tail written at ``length % CHUNK``.
``compressed_decode_attention`` is the compositional oracle (decode the
whole cache, then attend); the serving path uses the fused kernel in
``repro_torch.kernels.cdecode``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp import ref as zfp_ref
from repro_torch.models.layers import scale_in

CHUNK = 64  # tokens per compressed chunk (16 seq-blocks of 4)


class CompressedKV(NamedTuple):
    """Single-layer compressed KV for a (B, S, KVH, D) cache."""

    payload_k: torch.Tensor  # (B, KVH, NB, W) uint32
    emax_k: torch.Tensor  # (B, KVH, NB) int32
    payload_v: torch.Tensor
    emax_v: torch.Tensor
    tail_k: torch.Tensor  # (B, CHUNK, KVH, D) raw
    tail_v: torch.Tensor
    length: int  # total tokens, all slots


def _nb_per_chunk(head_dim: int) -> int:
    return (CHUNK // 4) * (head_dim // 4)


def _zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of ``dtype``; a uint32 tensor is made as int32 and viewed,
    since not every device fills or copies uint32."""
    if dtype == torch.uint32:
        return torch.zeros(shape, dtype=torch.int32,
                           device=device).view(torch.uint32)
    return torch.zeros(shape, dtype=dtype, device=device)


def init_compressed_kv(
    batch: int, max_len: int, kv_heads: int, head_dim: int, planes: int,
    dtype: torch.dtype = torch.bfloat16, device: device_mod.DeviceLike = None,
    *, lead: Tuple[int, ...] = (),
) -> CompressedKV:
    """An empty cache; ``lead`` prepends axes to every tensor (the
    layer axis of a model's stacked cache)."""
    if max_len % CHUNK:
        raise ValueError(f"max_len {max_len} is not a multiple of {CHUNK}")
    dev = device_mod.resolve(device)
    nb = (max_len // CHUNK) * _nb_per_chunk(head_dim)
    w = zfp_ref.payload_words(2, planes)
    lead = tuple(lead)
    pay = lambda: _zeros(lead + (batch, kv_heads, nb, w), torch.uint32, dev)
    em = lambda: _zeros(lead + (batch, kv_heads, nb), torch.int32, dev)
    tail = lambda: _zeros(lead + (batch, CHUNK, kv_heads, head_dim), dtype,
                         dev)
    return CompressedKV(pay(), em(), pay(), em(), tail(), tail(), 0)


def _encode_chunk(x: torch.Tensor, planes: int, backend: str):
    """x: (B, CHUNK, KVH, D) -> payload (B, KVH, nbc, W), emax."""
    b, _, kvh, d = x.shape
    xt = x.movedim(2, 1).float().contiguous()  # (B, KVH, CHUNK, D)
    comp = zfp_ops.compress(xt, planes=planes, ndim=2, backend=backend)
    nbc = _nb_per_chunk(d)
    return comp.payload.reshape(b, kvh, nbc, -1), comp.emax.reshape(b, kvh, nbc)


def _decode_all(payload, emax, planes: int, seq: int, head_dim: int,
                dtype: torch.dtype) -> torch.Tensor:
    """payload: (B, KVH, NB, W) -> (B, seq, KVH, D), plain codec."""
    b, kvh, _, w = payload.shape
    c = zfp_ref.Compressed(
        payload.reshape(-1, w), emax.reshape(-1), (b * kvh, seq, head_dim),
        planes, 2, "float32",
    )
    x = zfp_ops.decompress(c).reshape(b, kvh, seq, head_dim)
    return x.movedim(1, 2).to(dtype)  # (B, seq, KVH, D)


def _store(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """dst[:, :, start:start + n] = src, through int32 views for uint32."""
    if dst.dtype == torch.uint32:
        dst, src = dst.view(torch.int32), src.view(torch.int32)
    dst[:, :, start:start + src.shape[2]] = src


def append_token(ckv: CompressedKV, k: torch.Tensor, v: torch.Tensor, *,
                 planes: int, backend: str = "ref") -> CompressedKV:
    """k, v: (B, 1, KVH, D). Writes the tail in place; when the tail
    fills, encodes it as a new chunk (in place) and zeroes the tail.
    Returns the same tensors with ``length + 1``."""
    d = k.shape[-1]
    pos = ckv.length % CHUNK
    ckv.tail_k[:, pos] = k[:, 0].to(ckv.tail_k.dtype)
    ckv.tail_v[:, pos] = v[:, 0].to(ckv.tail_v.dtype)
    new_len = ckv.length + 1
    if new_len % CHUNK == 0:
        nbc = _nb_per_chunk(d)
        start = (new_len // CHUNK - 1) * nbc
        if start + nbc > ckv.payload_k.shape[2]:
            raise ValueError(
                f"compressed cache is full: chunk {new_len // CHUNK} of "
                f"{ckv.payload_k.shape[2] // nbc}"
            )
        for tail, pay, em in ((ckv.tail_k, ckv.payload_k, ckv.emax_k),
                              (ckv.tail_v, ckv.payload_v, ckv.emax_v)):
            p, e = _encode_chunk(tail, planes, backend)
            _store(pay, p, start)
            _store(em, e, start)
            tail.zero_()
    return ckv._replace(length=new_len)


def compressed_decode_attention(q: torch.Tensor, ckv: CompressedKV, *,
                                planes: int, max_len: int) -> torch.Tensor:
    """Attention over (decompressed chunks ++ tail window): the
    compositional oracle of the fused kernel. q: (B, 1, H, D)."""
    b, _, h, d = q.shape
    kvh = ckv.tail_k.shape[2]
    k_hist = _decode_all(ckv.payload_k, ckv.emax_k, planes, max_len, d,
                         ckv.tail_k.dtype)
    v_hist = _decode_all(ckv.payload_v, ckv.emax_v, planes, max_len, d,
                         ckv.tail_v.dtype)
    hist_len = (ckv.length // CHUNK) * CHUNK
    tail_pos = ckv.length - hist_len
    # mask history beyond hist_len, tail beyond tail fill
    k_all = torch.cat([k_hist, ckv.tail_k], dim=1)
    v_all = torch.cat([v_hist, ckv.tail_v], dim=1)
    idx = torch.arange(max_len + CHUNK, device=q.device)
    valid = (idx < hist_len) | ((idx >= max_len) & (idx < max_len + tail_pos))
    qpk = h // kvh
    qr = q.reshape(b, kvh, qpk, d) * scale_in(d, q.dtype)
    logits = torch.einsum("bgqd,btgd->bgqt", qr.float(), k_all.float())
    logits = logits.masked_fill(~valid, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgqt,btgd->bgqd", p.to(v_all.dtype).float(),
                       v_all.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def compressed_bytes(ckv: CompressedKV) -> int:
    return int(
        ckv.payload_k.numel() * 4 + ckv.payload_v.numel() * 4
        + ckv.emax_k.numel() * 2 + ckv.emax_v.numel() * 2
        + ckv.tail_k.numel() * ckv.tail_k.element_size()
        + ckv.tail_v.numel() * ckv.tail_v.element_size()
    )

"""Decoder LM, dense family, for serving: parameters, caches and the
one-token decode step over a raw or a fixed-rate compressed KV cache.

Port of the dense decode path of ``repro.models.model``. Each layer is
an ``nn.Module`` whose parameters carry the reference's leaf names
(``ln1``, ``wq``, ``bq``, ..., ``wg``, ``wu``, ``wd``) in its layout,
``(d_in, d_out)``, so ``h @ wq`` computes what the reference computes;
the layers sit in an ``nn.ModuleList`` where the reference scans a
stacked tree. As in the reference, the model has its own ``lm_head``
even when the config ties embeddings.

Caches keep the reference's shapes, are updated **in place**, and carry
``length`` as a host ``int``. Over a ``CompressedCache``,
``decode_step`` attends through the fused ZFP-decode kernel
(``kernels.cdecode.ops``; the reference's model calls the compositional
path instead) and encodes each full chunk with the codec kernel; both
launch on the card when ``backend="cuda"``, which is the default for a
model on a CUDA device. The compressed cache is slot-synchronous, as in
the reference.

Not ported yet (ROADMAP queue 1 item 14): ``forward``, ``prefill`` and
``loss_fn`` (they need ``blocked_attention``), the MoE, SSM and hybrid
families, and the audio and vision-language front ends.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cdecode import ops as cdecode_ops
from repro_torch.models import kvcache as KVC
from repro_torch.models import layers as L

NOT_PORTED = (
    "the {what} is not ported yet: ROADMAP.md queue 1 item 14 (the LM "
    "substrate; this port serves the dense family)"
)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            NOT_PORTED.format(what=f"{cfg.family!r} family ({cfg.name})"))


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class DenseLayer(nn.Module):
    """One attention + GLU layer, with the reference's leaves."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        f = cfg.d_ff
        p = lambda *shape: _param(shape, device, dtype)
        self.ln1 = p(d)
        self.wq, self.wk, self.wv = p(d, h * hd), p(d, kv * hd), p(d, kv * hd)
        self.wo = p(h * hd, d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(h * hd), p(kv * hd), p(kv * hd)
        if not cfg.parallel_block:
            self.ln2 = p(d)
        self.wg, self.wu, self.wd = p(d, f), p(d, f), p(f, d)

    def forward(self, x, positions, kv_cache, cache_len):
        return _decoder_layer(self.cfg, self, x, positions, kv_cache,
                              cache_len)


class Model(nn.Module):
    """The decoder's parameters: ``layers``, ``final_norm``, ``lm_head``
    and (for token input) ``embed``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DenseLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.num_layers))
        self.final_norm = _param((cfg.d_model,), device, dtype)
        self.lm_head = _param((cfg.d_model, cfg.vocab_size), device, dtype)
        if not cfg.embeds_input:
            self.embed = _param((cfg.vocab_size, cfg.d_model), device, dtype)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: device_mod.DeviceLike = None) -> Model:
    """Random weights as the reference draws them (normal in the
    config's type, scaled by ``fan_in ** -0.5``; norms one, biases zero,
    the embedding at 0.02), from ``generator`` (seed 0 on the device when
    none is given). The numbers differ from ``jax.random``'s; carry the
    reference's own weights over with ``convert.params_from_reference``."""
    _require_dense(cfg)
    dev = device_mod.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev, dtype=dtype_of(cfg))
    normal = lambda t, scale: t.normal_(generator=generator).mul_(scale)
    with torch.no_grad():
        for lp in model.layers:
            for name, t in lp.named_parameters():
                if name.startswith("ln"):
                    t.fill_(1.0)
                elif name.startswith("b"):
                    t.zero_()
                else:
                    normal(t, t.shape[0] ** -0.5)
        model.final_norm.fill_(1.0)
        normal(model.lm_head, cfg.d_model ** -0.5)
        if not cfg.embeds_input:
            normal(model.embed, 0.02)
    return model


# ---------------------------------------------------------------------------
# Layer bodies (decode)
# ---------------------------------------------------------------------------


def _qkv(cfg, p, h, positions):
    b, s, _ = h.shape
    q, k, v = h @ p.wq, h @ p.wk, h @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    return q, k, v


def _attn_block(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """Decode branch: returns (x_out, (k_cache, v_cache)), the caches
    written in place at each slot's position ``cache_len - 1``."""
    if kv_cache is None:
        raise NotImplementedError(NOT_PORTED.format(
            what="full-sequence attention (blocked_attention)"))
    h = L.norm(x, p.ln1, cfg.norm_eps, cfg.norm)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, h, positions)
    k_cache, v_cache = kv_cache
    idx = cache_len - 1
    k_cache = L.batched_cache_update(k_cache, k, idx)
    v_cache = L.batched_cache_update(v_cache, v, idx)
    attn = L.decode_attention(q, k_cache, v_cache, cache_len)
    out = attn.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p.wo
    return out, (k_cache, v_cache)


def _ffn_block(cfg, p, h):
    return L.glu_mlp(h, p.wg, p.wu, p.wd)


def _residual(cfg, p, x, h, attn_out):
    """The two residual forms: Cohere's parallel block (attention and
    FFN both read ``h = norm(x)``) or the sequential one."""
    if cfg.parallel_block:
        return x + attn_out + _ffn_block(cfg, p, h)
    x = x + attn_out
    return x + _ffn_block(cfg, p, L.norm(x, p.ln2, cfg.norm_eps, cfg.norm))


def _decoder_layer(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """One attention + FFN layer. Returns (x, new_kv)."""
    attn_out, new_kv = _attn_block(cfg, p, x, positions, kv_cache, cache_len)
    h = L.norm(x, p.ln1, cfg.norm_eps, cfg.norm) if cfg.parallel_block else None
    return _residual(cfg, p, x, h, attn_out), new_kv


def _embed_in(cfg, params: Model, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.embeds_input:
        return tokens.to(dtype_of(cfg))
    return params.embed[tokens.long()]


def _final_hidden_to_logits(cfg, params: Model, x: torch.Tensor):
    x = L.norm(x, params.final_norm, cfg.norm_eps, cfg.norm)
    return (x @ params.lm_head) * cfg.logit_scale


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """Attention KV (possibly absent), SSM states (possibly absent)."""

    k: Optional[torch.Tensor]  # (L, B, Smax, KV, hd)
    v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]  # (L_ssm, B, K-1, di): not ported yet
    h: Optional[torch.Tensor]
    length: int


class CompressedCache(NamedTuple):
    """Fixed-rate compressed KV: per-layer stacked ``CompressedKV``."""

    payload_k: torch.Tensor  # (L, B, KVH, NB, W) uint32
    emax_k: torch.Tensor  # (L, B, KVH, NB) int32
    payload_v: torch.Tensor
    emax_v: torch.Tensor
    tail_k: torch.Tensor  # (L, B, CHUNK, KVH, hd)
    tail_v: torch.Tensor
    length: int


def init_compressed_cache(cfg: ModelConfig, batch: int, max_len: int,
                          device: device_mod.DeviceLike = None
                          ) -> CompressedCache:
    return CompressedCache(*KVC.init_compressed_kv(
        batch, max_len=max_len, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, planes=cfg.kv_compress_planes,
        dtype=dtype_of(cfg), device=device, lead=(cfg.num_layers,),
    ))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: device_mod.DeviceLike = None):
    _require_dense(cfg)
    if cfg.kv_compress_planes:
        return init_compressed_cache(cfg, batch, max_len, device)
    dev = device_mod.resolve(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
    return DecodeCache(k, torch.zeros_like(k), None, None, 0)


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------


@torch.inference_mode()
def decode_step(
    cfg: ModelConfig,
    params: Model,
    cache,
    token: torch.Tensor,  # (B, 1) integers or (B, 1, d)
    positions: torch.Tensor,  # (B, 1) or (3, B, 1)
    *,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, object]:
    """One decode step; each slot's token is written at its own
    position (per-slot continuous batching; the compressed cache is
    slot-synchronous) and attention masks to position + 1. ``backend``
    picks the kernels of the compressed path: ``"cuda"`` (the default
    on a CUDA device) or ``"ref"`` (their plain versions). Returns
    (logits (B, V), the cache with ``length + 1``)."""
    _require_dense(cfg)
    dev = params.device
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "ref"
    token = torch.as_tensor(token, device=dev)
    positions = torch.as_tensor(positions, device=dev)
    x = _embed_in(cfg, params, token)
    if cfg.kv_compress_planes:
        return _decode_step_compressed(cfg, params, cache, x, positions,
                                       backend)
    pos_b = positions[0, :, 0] if cfg.mrope_sections else positions[:, 0]
    new_len = pos_b.to(torch.int32) + 1  # (B,) per-slot fill
    for i, lp in enumerate(params.layers):
        x, _ = lp(x, positions, (cache.k[i], cache.v[i]), new_len)
    logits = _final_hidden_to_logits(cfg, params, x)[:, 0]
    return logits, cache._replace(length=cache.length + 1)


def _decode_step_compressed(cfg, params, cache: CompressedCache, x,
                            positions, backend: str):
    """Decode over the fixed-rate compressed KV cache (paper §V-A
    layout: immutable compressed chunks + raw tail window), through the
    fused ZFP-decode attention kernel. Slot-synchronous fill."""
    planes = cfg.kv_compress_planes
    max_len = (cache.payload_k.shape[3] // KVC._nb_per_chunk(cfg.head_dim)
               * KVC.CHUNK)
    b, s, _ = x.shape
    for i, lp in enumerate(params.layers):
        ckv = KVC.CompressedKV(*(a[i] for a in cache[:6]), cache.length)
        hh = L.norm(x, lp.ln1, cfg.norm_eps, cfg.norm)
        q, k, v = _qkv(cfg, lp, hh, positions)
        ckv = KVC.append_token(ckv, k, v, planes=planes, backend=backend)
        attn = cdecode_ops.fused_compressed_decode_attention(
            q, ckv, planes=planes, max_len=max_len, backend=backend)
        out = attn.reshape(b, s, cfg.num_heads * cfg.head_dim) @ lp.wo
        x = _residual(cfg, lp, x, hh, out)
    logits = _final_hidden_to_logits(cfg, params, x)[:, 0]
    return logits, cache._replace(length=cache.length + 1)

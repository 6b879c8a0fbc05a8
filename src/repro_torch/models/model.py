"""Decoder LM: parameters, caches, the full-sequence forward, the
training loss, prefill and the one-token decode step.

Port of ``repro.models.model``, every family: dense, MoE, Mamba-1
(``ssm``), the zamba2 hybrid, and the audio and vision-language front
ends (``embeds_input``: the model takes precomputed embeddings, and
qwen2-vl (3, B, S) M-RoPE positions). Each layer is an ``nn.Module``
whose parameters carry the reference's leaf names (dense: ``ln1``,
``wq``, ``bq``, ..., ``wg``, ``wu``, ``wd``; MoE: the FFN's ``router``,
``wg_e``, ``wu_e``, ``wd_e`` and the shared expert's ``wg_s``, ``wu_s``,
``wd_s`` instead; Mamba-1: ``ln1``, ``in_proj``, ``conv_w``, ...,
``A_log``, ``D``, ``out_proj``; Mamba-2 the same without ``x_proj`` and
``dt_w``) in its layout, ``(d_in, d_out)``, so ``h @ wq`` computes what
the reference computes; the layers sit in an ``nn.ModuleList`` where the
reference scans a stacked tree (``stacked_leaves`` maps the port's names
onto the reference's ``(L, ...)`` leaves). The hybrid's shared attention
block is ``Model.shared_attn``, a ``DenseLayer`` (the reference's
``shared_attn`` subtree), applied after every ``attn_period`` Mamba-2
layers. As in the reference, the model has its own ``lm_head`` even when
the config ties embeddings, and a Mamba layer keeps ``A_log`` and ``D``
in float32.
Parameters are made with ``requires_grad=False``; training turns it on
for the model it trains (``launch.steps.make_train_step``).

The ``forward`` of every family is differentiable: blocked attention
(``layers.blocked_attention``), the Mamba-1 scan (through the sscan
kernel's backward on the card, ``kernels.sscan.ops.SelectiveScan``) and
each layer (the hybrid: each group of ``attn_period`` Mamba-2 layers and
the shared block) under the config's remat policy (``_remat``: none,
full, dots, or compressed residuals through ``core.remat``); an MoE
layer's FFN is ``models.moe.moe_ffn`` (top-k routing, capacity
dispatch, its load-balance loss summed over the layers into ``aux``);
``loss_fn`` adds the chunked cross-entropy and ``0.01 * aux``. The
activations carry the reference's ``logical(...)`` sharding hints
(``distributed.sharding``; no-ops outside ``use_rules``), and
``param_logical_axes``, ``cache_logical_axes`` and
``compressed_cache_logical_axes`` give the reference's axes.

Caches keep the reference's shapes, are updated **in place**, and carry
``length`` as a host ``int``. Over a ``CompressedCache``,
``decode_step`` attends through the fused ZFP-decode kernel
(``kernels.cdecode.ops``; the reference's model calls the compositional
path instead) and encodes each full chunk with the codec kernel. The
SSM family's layers scan through the selective-scan kernel
(``kernels.sscan.ops``, via ``models.ssm.mamba1_seq``; the reference's
model runs the XLA form) at decode, at prefill and in training, whose
gradient launches the scan's backward kernel. Every kernel launches
on the card when ``backend="cuda"``, which is the default for a model on
a CUDA device. The compressed cache is slot-synchronous, as in the
reference. The hybrid's Mamba-2 layers (``models.ssm.mamba2_seq``) and
its shared block are plain PyTorch, as the reference's are XLA, and its
cache is the raw one whatever ``kv_compress_planes`` says (the
reference's ``init_cache``): ``conv`` and ``h`` a Mamba-2 layer, K and
V a group.

Under ``use_rules`` on a mesh of ranks an MoE layer takes ``moe_ffn``'s
expert-parallel branch, and every function here also runs on sharded
tensors (DTensors placed by ``launch.steps.shardings_for``): where
DTensor cannot place an operator as written, a sharded tensor takes
another road to the same values (``layers.divisible_shards`` before a
head split, the embedding table gathered along its embedding dimension,
``layers.batched_cache_update`` shard by shard, the reference's one-hot
gold logit in ``chunked_xent``); a plain tensor takes the road it
always took.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import is_dtensor, logical
from repro_torch.kernels.cdecode import ops as cdecode_ops
from repro_torch.models import kvcache as KVC
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

REMATS = ("none", "full", "dots", "compressed")
COMPRESSED_REMAT_PLANES = 12  # the reference's model.py:344


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _mixer_kind(cfg: ModelConfig) -> str:
    if cfg.family == "ssm":
        return "mamba1"
    if cfg.family == "hybrid":
        return "mamba2"
    return "attn"


def stacked_leaves(names) -> Dict[str, List[str]]:
    """The reference's leaf of each parameter name, in first-seen order:
    ``layers.<i>.<leaf>`` joins ``layers/<leaf>`` (its pieces in layer
    order, the reference's ``(L, ...)`` stack), ``shared_attn.<leaf>`` is
    the leaf ``shared_attn/<leaf>`` of the hybrid's subtree, any other
    name is a leaf of its own. Keys are the checkpoint's flat keys of the
    reference's parameter tree."""
    out: Dict[str, List[str]] = {}
    for name in names:
        parts = name.split(".")
        key = "/".join((parts[0], parts[-1])) if len(parts) > 1 else name
        out.setdefault(key, []).append(name)
    return out


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class DenseLayer(nn.Module):
    """One attention + FFN layer, with the reference's leaves: a GLU
    (``wg``, ``wu``, ``wd``), or for the MoE family the router, the
    experts' stacked GLUs ``(E, d, f)`` / ``(E, f, d)`` and, when the
    config has one, the shared expert's GLU."""

    ONES = ("ln1", "ln2")
    ZEROS = ("bq", "bk", "bv")

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
        if cfg.family != "moe":
            self.wg, self.wu, self.wd = p(d, f), p(d, f), p(f, d)
            return
        e, fs = cfg.num_experts, cfg.shared_expert_ff
        self.router = p(d, e)
        self.wg_e, self.wu_e, self.wd_e = p(e, d, f), p(e, d, f), p(e, f, d)
        if fs:
            self.wg_s, self.wu_s, self.wd_s = p(d, fs), p(d, fs), p(fs, d)

    def forward(self, x, positions, kv_cache, cache_len):
        return _decoder_layer(self.cfg, self, x, positions, kv_cache,
                              cache_len)

    @torch.no_grad()
    def reset_parameters(self, normal) -> None:
        """The reference's initial values: norms one, biases zero, the
        rest ``normal(t, fan_in ** -0.5)`` with ``fan_in = t.shape[-2]``
        (a matrix's rows; an expert stack's ``d`` or ``f``)."""
        for name, t in self.named_parameters():
            if name in self.ONES:
                t.fill_(1.0)
            elif name in self.ZEROS:
                t.zero_()
            else:
                normal(t, t.shape[-2] ** -0.5)


class Mamba1Layer(nn.Module):
    """One Mamba-1 mixer layer (falcon-mamba), with the reference's
    leaves; ``A_log`` and ``D`` are float32 whatever ``dtype``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        dtr = cfg.ssm_dt_rank or max(1, d // 16)
        p = lambda *shape: _param(shape, device, dtype)
        self.ln1 = p(d)
        self.in_proj = p(d, 2 * di)
        self.conv_w, self.conv_b = p(di, cfg.ssm_conv), p(di)
        self.x_proj = p(di, dtr + 2 * n)
        self.dt_w, self.dt_b = p(dtr, di), p(di)
        self.A_log = _param((di, n), device, torch.float32)
        self.D = _param((di,), device, torch.float32)
        self.out_proj = p(di, d)

    def forward(self, x, state=None, *, backend="ref", h_out=None):
        return _mamba_layer(self.cfg, self, x, state, backend=backend,
                            h_out=h_out)

    @torch.no_grad()
    def reset_parameters(self, normal) -> None:
        """As ``_mamba1_layer_init``: ``conv_w`` scaled by the kernel
        width, ``dt_b`` at softplus^-1(0.01), ``A_log = log(1..N)``."""
        n = self.A_log.shape[1]
        self.ln1.fill_(1.0)
        normal(self.in_proj, self.in_proj.shape[0] ** -0.5)
        normal(self.conv_w, self.conv_w.shape[1] ** -0.5)
        self.conv_b.zero_()
        normal(self.x_proj, self.x_proj.shape[0] ** -0.5)
        normal(self.dt_w, self.dt_w.shape[0] ** -0.5)
        self.dt_b.fill_(-4.6)
        self.A_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=torch.float32, device=self.A_log.device)))
        self.D.fill_(1.0)
        normal(self.out_proj, self.out_proj.shape[0] ** -0.5)


class Mamba2Layer(nn.Module):
    """One Mamba-2 (SSD) mixer layer (zamba2), with the reference's leaves:
    ``in_proj`` gives z, x, B and C (``ssm_groups`` each) and the heads'
    dt; ``dt_b``, ``A_log`` and ``D`` are per head, the last two float32
    whatever ``dtype``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, g = cfg.ssm_heads, cfg.ssm_groups
        p = lambda *shape: _param(shape, device, dtype)
        self.ln1 = p(d)
        self.in_proj = p(d, 2 * di + 2 * g * n + nh)
        self.conv_w, self.conv_b = p(di, cfg.ssm_conv), p(di)
        self.dt_b = p(nh)
        self.A_log = _param((nh,), device, torch.float32)
        self.D = _param((nh,), device, torch.float32)
        self.out_proj = p(di, d)

    def forward(self, x, state=None, *, backend="ref", h_out=None):
        return _mamba_layer(self.cfg, self, x, state, backend=backend,
                            h_out=h_out)

    @torch.no_grad()
    def reset_parameters(self, normal) -> None:
        """As ``_mamba2_layer_init``: ``conv_w`` scaled by the kernel
        width, ``dt_b`` at softplus^-1(0.01), ``A_log = 0``, ``D = 1``."""
        self.ln1.fill_(1.0)
        normal(self.in_proj, self.in_proj.shape[0] ** -0.5)
        normal(self.conv_w, self.conv_w.shape[1] ** -0.5)
        self.conv_b.zero_()
        self.dt_b.fill_(-4.6)
        self.A_log.zero_()
        self.D.fill_(1.0)
        normal(self.out_proj, self.out_proj.shape[0] ** -0.5)


LAYERS = {"attn": DenseLayer, "mamba1": Mamba1Layer, "mamba2": Mamba2Layer}


class Model(nn.Module):
    """The decoder's parameters: ``layers``, ``final_norm``, ``lm_head``,
    (for token input) ``embed`` and (for the hybrid) ``shared_attn``."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        layer = LAYERS[_mixer_kind(cfg)]
        self.layers = nn.ModuleList(
            layer(cfg, device=device, dtype=dtype)
            for _ in range(cfg.num_layers))
        self.final_norm = _param((cfg.d_model,), device, dtype)
        self.lm_head = _param((cfg.d_model, cfg.vocab_size), device, dtype)
        if not cfg.embeds_input:
            self.embed = _param((cfg.vocab_size, cfg.d_model), device, dtype)
        if cfg.attn_period:
            self.shared_attn = DenseLayer(cfg, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: device_mod.DeviceLike = None) -> Model:
    """Random weights as the reference draws them (normal in the
    config's type, scaled by ``fan_in ** -0.5``; norms one, biases zero,
    the Mamba constants as ``_mamba1_layer_init`` / ``_mamba2_layer_init``,
    the embedding at 0.02), from ``generator`` (seed 0 on the device when
    none is given). The numbers differ from ``jax.random``'s; carry the
    reference's own weights over with ``convert.params_from_reference``.
    On ``meta`` every parameter has ``param_specs``' shape and type and
    nothing is drawn: no generator or card is needed."""
    dev = device_mod.resolve(device)
    if dev.type == "meta":
        return Model(cfg, device=dev, dtype=dtype_of(cfg))
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev, dtype=dtype_of(cfg))
    normal = lambda t, scale: t.normal_(generator=generator).mul_(scale)
    with torch.no_grad():
        for lp in model.layers:
            lp.reset_parameters(normal)
        model.final_norm.fill_(1.0)
        normal(model.lm_head, cfg.d_model ** -0.5)
        if not cfg.embeds_input:
            normal(model.embed, 0.02)
        if cfg.attn_period:
            model.shared_attn.reset_parameters(normal)
    return model


# ---------------------------------------------------------------------------
# Logical sharding axes (the reference's, keyed by the port's names)
# ---------------------------------------------------------------------------


def _dense_layer_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    p = {
        "ln1": (None,),
        "wq": ("p_embed", "p_heads"),
        "wk": ("p_embed", "p_kv_heads"),
        "wv": ("p_embed", "p_kv_heads"),
        "wo": ("p_heads", "p_embed"),
    }
    if cfg.qkv_bias:
        p.update(bq=("p_heads",), bk=("p_kv_heads",), bv=("p_kv_heads",))
    if not cfg.parallel_block:
        p["ln2"] = (None,)
    if cfg.family == "moe":
        p["router"] = (None, None)
        p["wg_e"] = ("p_experts", "p_embed", None)
        p["wu_e"] = ("p_experts", "p_embed", None)
        p["wd_e"] = ("p_experts", None, "p_embed")
        if cfg.shared_expert_ff:
            p["wg_s"] = ("p_embed", "p_mlp")
            p["wu_s"] = ("p_embed", "p_mlp")
            p["wd_s"] = ("p_mlp", "p_embed")
    else:
        p["wg"] = ("p_embed", "p_mlp")
        p["wu"] = ("p_embed", "p_mlp")
        p["wd"] = ("p_mlp", "p_embed")
    return p


def _mamba1_layer_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    return {
        "ln1": (None,),
        "in_proj": ("p_embed", "p_mlp"),
        "conv_w": ("p_mlp", None),
        "conv_b": ("p_mlp",),
        "x_proj": ("p_mlp", None),
        "dt_w": (None, "p_mlp"),
        "dt_b": ("p_mlp",),
        "A_log": ("p_mlp", None),
        "D": ("p_mlp",),
        "out_proj": ("p_mlp", "p_embed"),
    }


def _mamba2_layer_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    return {
        "ln1": (None,),
        "in_proj": ("p_embed", "p_mlp"),
        "conv_w": ("p_mlp", None),
        "conv_b": ("p_mlp",),
        "dt_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "out_proj": ("p_mlp", "p_embed"),
    }


_LAYER_AXES = {"attn": _dense_layer_axes, "mamba1": _mamba1_layer_axes,
               "mamba2": _mamba2_layer_axes}


def param_specs(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every parameter as a ``meta`` tensor (shape and type, no
    allocation), in ``named_parameters()`` order."""
    model = Model(cfg, device=torch.device("meta"), dtype=dtype_of(cfg))
    return dict(model.named_parameters())


def param_logical_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """The logical axes of every parameter, keyed by the port's names in
    ``named_parameters()`` order: a layer's leaf (``layers.<i>.<leaf>``)
    takes the reference's per-layer axes, without the leading ``L`` axis
    of its stack (unsharded there), ``shared_attn.<leaf>`` the dense
    layer's, and ``final_norm``, ``lm_head``, ``embed`` their own."""
    layer = _LAYER_AXES[_mixer_kind(cfg)](cfg)
    dense = _dense_layer_axes(cfg)
    top = {"final_norm": (None,), "lm_head": ("p_embed", "p_vocab"),
           "embed": ("p_vocab", "p_embed")}
    out = {}
    for name in param_specs(cfg):
        parts = name.split(".")
        if parts[0] == "layers":
            out[name] = layer[parts[-1]]
        elif parts[0] == "shared_attn":
            out[name] = dense[parts[-1]]
        else:
            out[name] = top[name]
    return out


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def _split_heads(t: torch.Tensor, heads: int, head_dim: int):
    """(B, S, heads · head_dim) -> (B, S, heads, head_dim)."""
    b, s, _ = t.shape
    return L.divisible_shards(t, -1, heads).reshape(b, s, heads, head_dim)


def _qkv(cfg, p, h, positions):
    b, s, _ = h.shape
    q, k, v = h @ p.wq, h @ p.wk, h @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = _split_heads(q, cfg.num_heads, cfg.head_dim)
    k = _split_heads(k, cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.num_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    q = logical(q, "batch", "seq", "heads", None)
    k = logical(k, "batch", "seq", "kv_heads", None)
    return q, k, v


def _attn_block(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """Returns (x_out, (k, v)). Full sequence (no cache): blocked
    attention over ``cfg.attn_chunk`` chunks, the new K and V returned.
    Decode: the caches written in place at each slot's position
    ``cache_len - 1`` and returned."""
    h = L.norm(x, p.ln1, cfg.norm_eps, cfg.norm)
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, h, positions)
    if kv_cache is None:
        attn = L.blocked_attention(
            q, k, v, kv_chunk=min(cfg.attn_chunk, s)).to(x.dtype)
        new_kv = (k, v)
    else:
        k_cache, v_cache = kv_cache
        idx = cache_len - 1
        k_cache = L.batched_cache_update(k_cache, k, idx)
        v_cache = L.batched_cache_update(v_cache, v, idx)
        attn = L.decode_attention(q, k_cache, v_cache, cache_len)
        new_kv = (k_cache, v_cache)
    flat = L.merged(attn.reshape(b, s, cfg.num_heads * cfg.head_dim), -1,
                    cfg.num_heads)
    return flat @ p.wo, new_kv


def _ffn_block(cfg, p, h):
    """The FFN. Returns (y, aux): the MoE family's load-balance loss, 0.0
    for the dense GLU."""
    if cfg.family != "moe":
        return L.glu_mlp(h, p.wg, p.wu, p.wd), 0.0
    y, aux = MOE.moe_ffn(h, p.router, p.wg_e, p.wu_e, p.wd_e,
                         k=cfg.experts_per_token,
                         capacity_factor=cfg.capacity_factor)
    if cfg.shared_expert_ff:
        y = y + L.glu_mlp(h, p.wg_s, p.wu_s, p.wd_s)
    return y, aux


def _residual(cfg, p, x, h, attn_out):
    """The two residual forms: Cohere's parallel block (attention and
    FFN both read ``h = norm(x)``) or the sequential one. Returns (x,
    the FFN's aux)."""
    if cfg.parallel_block:
        y, aux = _ffn_block(cfg, p, h)
        return x + attn_out + y, aux
    x = x + attn_out
    y, aux = _ffn_block(cfg, p, L.norm(x, p.ln2, cfg.norm_eps, cfg.norm))
    return x + y, aux


def _decoder_layer(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """One attention + FFN layer. Returns (x, new_kv, aux)."""
    attn_out, new_kv = _attn_block(cfg, p, x, positions, kv_cache, cache_len)
    h = L.norm(x, p.ln1, cfg.norm_eps, cfg.norm) if cfg.parallel_block else None
    x, aux = _residual(cfg, p, x, h, attn_out)
    return logical(x, "batch", "seq", "embed"), new_kv, aux


def _mamba_layer(cfg, p, x, state=None, *, backend="ref", h_out=None):
    """Pre-norm Mamba mixer (Mamba-1 through the scan's ``backend``, or
    Mamba-2) with its residual. Returns (x, new state)."""
    h = L.norm(x, p.ln1, cfg.norm_eps, cfg.norm)
    if _mixer_kind(cfg) == "mamba1":
        y, new_state = SSM.mamba1_seq(p, h, chunk=cfg.ssm_chunk, state=state,
                                      backend=backend, h_out=h_out)
    else:
        y, new_state = SSM.mamba2_seq(
            p, h, chunk=cfg.ssm_chunk, ngroups=cfg.ssm_groups,
            ssm_state=cfg.ssm_state, state=state, h_out=h_out)
    return logical(x + y, "batch", "seq", "embed"), new_state


def _embed_in(cfg, params: Model, tokens: torch.Tensor) -> torch.Tensor:
    if cfg.embeds_input:
        return tokens.to(dtype_of(cfg))
    # a sharded table is gathered along its embedding dimension first
    # (FSDP's gather: whole in one piece there; DTensor's embedding cannot
    # mask a lookup whose rows are split both ways), and its gradient
    # arrives in the rows' own placements
    table = L.divisible_shards(params.embed, 1, 1)
    rows = torch.nn.functional.embedding(tokens.long(), table)
    return L.grad_placed(logical(rows, "batch", "seq", "embed"))


def _final_hidden_to_logits(cfg, params: Model, x: torch.Tensor):
    x = L.norm(x, params.final_norm, cfg.norm_eps, cfg.norm)
    return logical((x @ params.lm_head) * cfg.logit_scale,
                   "batch", "seq", "vocab_out")


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    """Attention KV (possibly absent), SSM states (possibly absent)."""

    k: Optional[torch.Tensor]  # (L_attn, B, Smax, KV, hd); hybrid: a group
    v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]  # (L_ssm, B, K-1, di)
    h: Optional[torch.Tensor]  # (L_ssm, B, di, N) f32; Mamba-2 (.., H, P, N)
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
    """The decode cache: the ssm family's ``conv`` and ``h`` a layer; the
    hybrid's ``conv`` and ``h`` a Mamba-2 layer and a raw K/V a group
    (``kv_compress_planes`` ignored, as in the reference); the attention
    families' K/V a layer, raw or compressed."""
    dev = device_mod.resolve(device)
    mixer = _mixer_kind(cfg)
    if mixer != "attn":
        state = ((cfg.d_inner,) if mixer == "mamba1"
                 else (cfg.ssm_heads, cfg.ssm_head_dim))
        conv = torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                            cfg.d_inner), dtype=dtype_of(cfg), device=dev)
        h = torch.zeros((cfg.num_layers, batch) + state + (cfg.ssm_state,),
                        dtype=torch.float32, device=dev)
        if mixer == "mamba1":
            return DecodeCache(None, None, conv, h, 0)
        shape = (cfg.num_layers // cfg.attn_period, batch, max_len,
                 cfg.num_kv_heads, cfg.head_dim)
        k = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        return DecodeCache(k, torch.zeros_like(k), conv, h, 0)
    if cfg.kv_compress_planes:
        return init_compressed_cache(cfg, batch, max_len, device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
    return DecodeCache(k, torch.zeros_like(k), None, None, 0)


def compressed_cache_logical_axes(cfg: ModelConfig) -> CompressedCache:
    pay = (None, "cache_batch", "cache_kv_heads", "cache_seq", None)
    em = (None, "cache_batch", "cache_kv_heads", "cache_seq")
    tail = (None, "cache_batch", None, "cache_kv_heads", None)
    return CompressedCache(pay, em, pay, em, tail, tail, ())


def cache_logical_axes(cfg: ModelConfig):
    """The logical axes of ``init_cache``'s fields (``length``, a host
    int here, takes ``()``)."""
    kv_axes = (None, "cache_batch", "cache_seq", "cache_kv_heads", None)
    ssm_axes = (None, "cache_batch", None, "mlp")
    h1_axes = (None, "cache_batch", "mlp", None)
    h2_axes = (None, "cache_batch", None, None, None)
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        if cfg.kv_compress_planes:
            return compressed_cache_logical_axes(cfg)
        return DecodeCache(kv_axes, kv_axes, None, None, ())
    if cfg.family == "ssm":
        return DecodeCache(None, None, ssm_axes, h1_axes, ())
    return DecodeCache(kv_axes, kv_axes, ssm_axes, h2_axes, ())


def _on(a, dev: torch.device) -> torch.Tensor:
    """A tensor, or a copy of a numpy array (the pipelines' positions are
    read-only broadcasts), on ``dev``."""
    if isinstance(a, torch.Tensor):
        # a DTensor's ``.to`` raises under inference mode, even to its
        # own device
        return a if a.device == dev else a.to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


# ---------------------------------------------------------------------------
# Full forward (train / prefill)
# ---------------------------------------------------------------------------


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``checkpoint_dots``): keep the outputs of matrix products, recompute
    everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, backend: str):
    """``fn`` under the config's remat policy. Without autograd (prefill,
    evaluation) every policy runs ``fn`` as it is, as the reference's do
    outside a gradient."""
    if cfg.remat not in REMATS:
        raise ValueError(cfg.remat)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt

    if cfg.remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda *a: ckpt.checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_dots))
    from repro_torch.core.remat import compressed_checkpoint

    return compressed_checkpoint(fn, planes=COMPRESSED_REMAT_PLANES,
                                 backend=backend)


def _dense_body(cfg, names, positions, collect_cache: bool):
    """One decoder layer as a function of tensors only, ``(h, aux,
    *weights) -> (h, aux[, k, v])``: the remat policies see every weight
    as an argument (``core.remat`` saves and differentiates them)."""
    def body(h, aux, *weights):
        lp = SimpleNamespace(**dict(zip(names, weights)))
        h, (k, v), a = _decoder_layer(cfg, lp, h, positions)
        aux = aux + a
        return (h, aux, k, v) if collect_cache else (h, aux)

    return body


def _hybrid_body(cfg, m_names, s_names, positions, collect_cache: bool):
    """One hybrid group as a function of tensors only, ``(h, aux,
    *mamba_weights, *shared_weights) -> (h, aux[, conv, h_ssm, k, v])``:
    ``attn_period`` Mamba-2 layers (``m_names`` a layer, in layer order),
    then the shared attention block. Every weight is an argument, as in
    ``_dense_body``; ``conv`` and ``h_ssm`` are the group's layers'
    states stacked ``(period, ...)``."""
    period, nm = cfg.attn_period, len(m_names)

    def body(h, aux, *weights):
        convs, hs = [], []
        for j in range(period):
            lp = SimpleNamespace(**dict(zip(
                m_names, weights[j * nm:(j + 1) * nm])))
            h, st = _mamba_layer(cfg, lp, h)
            convs.append(st.conv)
            hs.append(st.h)
        sp = SimpleNamespace(**dict(zip(s_names, weights[period * nm:])))
        h, (k, v), a = _decoder_layer(cfg, sp, h, positions)
        aux = aux + a
        if not collect_cache:
            return h, aux
        return h, aux, torch.stack(convs), torch.stack(hs), k, v

    return body


def _hybrid_forward(cfg, params, x, positions, collect_cache, backend):
    """``num_layers // attn_period`` groups, each under ``_remat``. With
    ``collect_cache`` the reference's grouped cache: (MambaState(conv
    (G, period, B, K-1, di), h (G, period, B, H, P, N)), (k, v) each
    (G, B, S, KV, hd))."""
    period = cfg.attn_period
    m_names = [n for n, _ in params.layers[0].named_parameters()]
    s_names = [n for n, _ in params.shared_attn.named_parameters()]
    shared = [getattr(params.shared_attn, n) for n in s_names]
    body = _remat(cfg, _hybrid_body(cfg, m_names, s_names, positions,
                                    collect_cache), backend)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    parts = []
    for g in range(cfg.num_layers // period):
        group = params.layers[g * period:(g + 1) * period]
        outs = body(x, aux, *(getattr(lp, n) for lp in group
                              for n in m_names), *shared)
        x, aux = outs[0], outs[1]
        parts.append(outs[2:])
    if not collect_cache:
        return x, aux, None
    conv, h, k, v = (torch.stack(t) for t in zip(*parts))
    return x, aux, (SSM.MambaState(conv, h), (k, v))


def _ssm_body(cfg, names, collect_cache: bool, backend: str):
    """One Mamba-1 layer as a function of tensors only, ``(h, *weights)
    -> h`` (with ``collect_cache``: ``(h, conv, h_ssm)``), as
    ``_dense_body``: the remat policies see every weight as an argument.
    The scan differentiates through the sscan kernels on the card
    (``kernels.sscan.ops.SelectiveScan``)."""
    def body(h, *weights):
        lp = SimpleNamespace(**dict(zip(names, weights)))
        h, st = _mamba_layer(cfg, lp, h, backend=backend)
        return (h, st.conv, st.h) if collect_cache else h

    return body


def _ssm_forward(cfg, params, x, collect_cache, backend):
    """Each Mamba-1 layer under ``_remat``; with ``collect_cache`` one
    ``MambaState`` of ``(L, ...)`` stacks."""
    names = [n for n, _ in params.layers[0].named_parameters()]
    body = _remat(cfg, _ssm_body(cfg, names, collect_cache, backend),
                  backend)
    convs, hs = [], []
    for lp in params.layers:
        outs = body(x, *(getattr(lp, n) for n in names))
        if collect_cache:
            x, conv, h = outs
            convs.append(conv)
            hs.append(h)
        else:
            x = outs
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_cache:
        return x, aux, None
    return x, aux, SSM.MambaState(torch.stack(convs), torch.stack(hs))


def forward(cfg: ModelConfig, params: Model, tokens: torch.Tensor,
            positions: torch.Tensor, collect_cache: bool = False, *,
            backend: Optional[str] = None):
    """Full-sequence forward. Returns (hidden (B, S, d), aux loss, cache).

    Every family is differentiable. Dense, MoE, audio and vlm: each
    layer under ``_remat``; with ``collect_cache`` the per-layer K and V
    as ``(L, B, S, KV, hd)`` stacks ``(k, v)``. hybrid: each group under
    ``_remat``, the grouped cache of ``_hybrid_forward``. ssm: each layer
    under ``_remat``; with ``collect_cache`` one ``MambaState`` of
    ``(L, ...)`` stacks; ``positions`` unused, as in the reference's ssm
    branch. ``backend`` picks the kernels (the compressed remat's codec,
    the selective scan and its backward): ``"cuda"``, the default on a
    CUDA device, or ``"ref"``."""
    dev = params.device
    backend = device_mod.backend_for(dev, backend)
    x = _embed_in(cfg, params, _on(tokens, dev))
    if cfg.family == "ssm":
        return _ssm_forward(cfg, params, x, collect_cache, backend)
    positions = _on(positions, dev)
    if cfg.family == "hybrid":
        return _hybrid_forward(cfg, params, x, positions, collect_cache,
                               backend)
    names = [n for n, _ in params.layers[0].named_parameters()]
    body = _remat(cfg, _dense_body(cfg, names, positions, collect_cache),
                  backend)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    ks, vs = [], []
    for lp in params.layers:
        outs = body(x, aux, *(getattr(lp, n) for n in names))
        x, aux = outs[0], outs[1]
        if collect_cache:
            ks.append(outs[2])
            vs.append(outs[3])
    cache = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, cache


def chunked_xent(cfg: ModelConfig, params: Model, hidden: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over labels >= 0, the (B, S, V) logits made
    ``chunk`` positions at a time. The gold logit is gathered (the
    reference's one-hot sum picks the same value exactly)."""
    b, s, _ = hidden.shape
    nchunk = -(-s // chunk)
    pad = nchunk * chunk - s
    labels = _on(labels, hidden.device)
    if pad:  # (the card's torch 2.11 cannot place a pad of a sharded tensor)
        hp = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        lp = torch.nn.functional.pad(labels, (0, pad), value=-1)
    else:
        hp, lp = hidden, labels
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nchunk):
        h = hp[:, c * chunk:(c + 1) * chunk]
        y = lp[:, c * chunk:(c + 1) * chunk]
        logits = _final_hidden_to_logits(cfg, params, h).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        if is_dtensor(logits):
            # over sharded logits the reference's one-hot sum: a gather
            # across vocabulary shards does not place (the gather is
            # cheaper where the logits are whole)
            vocab = torch.arange(logits.shape[-1], device=logits.device)
            hot = (y.clamp(min=0).long()[..., None] == vocab).to(
                logits.dtype)
            gold = torch.sum(logits * hot, dim=-1)
        else:
            gold = logits.gather(-1, y.clamp(min=0).long()[..., None])[
                ..., 0]
        valid = (y >= 0).to(torch.float32)
        tot = tot + torch.sum((lse - gold) * valid)
        cnt = cnt + torch.sum(valid)
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params: Model, batch, *,
            backend: Optional[str] = None) -> torch.Tensor:
    """The training loss: batch ``tokens`` (or embeddings), ``labels``,
    ``positions`` (tensors or numpy arrays)."""
    hidden, aux, _ = forward(cfg, params, batch["tokens"],
                             batch["positions"], backend=backend)
    loss = chunked_xent(cfg, params, hidden, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# Serving: prefill and decode
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill(cfg: ModelConfig, params: Model, tokens: torch.Tensor,
            positions: torch.Tensor, *, backend: Optional[str] = None):
    """Full-sequence forward; returns (last-token logits (B, V), the
    cache parts: the attention families' ``(k, v)`` stacks of shape
    (L, B, S, KV, hd), the ssm family's ``MambaState`` stacks, the
    hybrid's grouped ``(MambaState, (k, v))``)."""
    hidden, _, cache = forward(cfg, params, tokens, positions,
                               collect_cache=True, backend=backend)
    logits = _final_hidden_to_logits(cfg, params, hidden[:, -1:])[:, 0]
    return logits, cache


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
    slot-synchronous) and attention masks to position + 1; an SSM layer
    advances each slot's ``conv`` and ``h`` in place, and the hybrid's
    shared block after group g attends over group g's K/V. ``backend`` picks
    the kernels of the compressed path and of the selective scan:
    ``"cuda"`` (the default on a CUDA device) or ``"ref"`` (their plain
    versions). An MoE layer routes the step's B tokens with no drop
    (``moe._capacity``) and its load-balance loss is dropped, as in the
    reference. Returns (logits (B, V), the cache with ``length + 1``)."""
    dev = params.device
    backend = device_mod.backend_for(dev, backend)
    token = _on(token, dev)
    positions = _on(positions, dev)
    x = _embed_in(cfg, params, token)
    pos_b = positions[0, :, 0] if cfg.mrope_sections else positions[:, 0]
    new_len = pos_b.to(torch.int32) + 1  # (B,) per-slot fill
    if cfg.family in ("ssm", "hybrid"):
        period = cfg.attn_period
        for i, lp in enumerate(params.layers):
            x, st = lp(x, SSM.MambaState(cache.conv[i], cache.h[i]),
                       backend=backend, h_out=cache.h[i])
            cache.conv[i].copy_(st.conv)
            if period and (i + 1) % period == 0:
                g = i // period
                x, _, _ = params.shared_attn(
                    x, positions, (cache.k[g], cache.v[g]), new_len)
        logits = _final_hidden_to_logits(cfg, params, x)[:, 0]
        return logits, cache._replace(length=cache.length + 1)
    if cfg.kv_compress_planes:
        return _decode_step_compressed(cfg, params, cache, x, positions,
                                       backend)
    for i, lp in enumerate(params.layers):
        x, _, _ = lp(x, positions, (cache.k[i], cache.v[i]), new_len)
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
        x, _ = _residual(cfg, lp, x, hh, out)
    logits = _final_hidden_to_logits(cfg, params, x)[:, 0]
    return logits, cache._replace(length=cache.length + 1)

"""Model/experiment configuration schema + the assigned input shapes."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (seq_len x global_batch). decode_* / long_*
# lower serve_step (one token against a seq_len KV cache / SSM state).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    parallel_block: bool = False  # Cohere-style attn||mlp residual
    logit_scale: float = 1.0
    tie_embeddings: bool = False
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (sum=hd/2)
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0
    ssm_head_dim: int = 0  # mamba2/SSD head dim (0 => mamba1)
    ssm_groups: int = 1  # B/C groups (mamba2)
    # hybrid (zamba2): shared attention block every N mamba layers
    attn_period: int = 0
    # modality frontend stub: model consumes precomputed embeddings
    embeds_input: bool = False
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # scan chunk for SSM / blocked attention
    attn_chunk: int = 1024
    ssm_chunk: int = 64
    # paper-technique integration knobs (beyond-paper features)
    kv_compress_planes: int = 0  # 0 = off; fixed-rate compressed KV
    grad_compress_planes: int = 0  # compressed cross-pod all-reduce
    remat: str = "full"  # none | full | compressed
    source: str = ""  # public provenance note

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def params_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6*N*D."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            hd = self.head_dim
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                self.num_heads * hd * d
            )
        else:
            attn = 0
        if self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            dtr = self.ssm_dt_rank or max(1, self.d_model // 16)
            per = (
                d * 2 * di  # in_proj
                + di * self.ssm_conv
                + di * (dtr + 2 * N)  # x_proj
                + dtr * di  # dt_proj
                + di * N + di  # A, D
                + di * d  # out_proj
            )
            return n + L * per
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            per = (
                d * 2 * di + di * self.ssm_conv
                + self.ssm_heads * 2  # dt bias / A per head
                + di * (2 * self.ssm_groups * N)
                + di * d
            )
            shared_attn = attn + 3 * d * self.d_ff
            return n + L * per + shared_attn
        mlp = 3 * d * self.d_ff
        if self.family == "moe":
            mlp = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
            if self.shared_expert_ff:
                mlp += 3 * d * self.shared_expert_ff
        return n + L * (attn + mlp)

    def active_params_count(self) -> int:
        """N_active for MoE MODEL_FLOPS."""
        if self.family != "moe":
            return self.params_count()
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d * 2
        hd = self.head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
            self.num_heads * hd * d
        )
        mlp = self.experts_per_token * 3 * d * self.d_ff + (
            d * self.num_experts
        )
        if self.shared_expert_ff:
            mlp += 3 * d * self.shared_expert_ff
        return n + L * (attn + mlp)


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2 * cfg.attn_period if cfg.attn_period else 2,
        d_model=64,
        vocab_size=256,
        dtype="float32",
        attn_chunk=32,
        ssm_chunk=8,
    )
    if cfg.has_attention:
        kw.update(num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))
    if cfg.family == "moe":
        kw.update(num_experts=4, experts_per_token=2)
        if cfg.shared_expert_ff:
            kw.update(shared_expert_ff=96)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8)
        if cfg.ssm_head_dim:
            kw.update(ssm_head_dim=16, ssm_groups=1)
    return replace(cfg, **kw)


SMOKE_SHAPES = {
    "train": ShapeSpec("smoke_train", 64, 2, "train"),
    "prefill": ShapeSpec("smoke_prefill", 64, 2, "prefill"),
    "decode": ShapeSpec("smoke_decode", 64, 2, "decode"),
}

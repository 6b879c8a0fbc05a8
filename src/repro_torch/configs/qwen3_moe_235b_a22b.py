"""Qwen3-235B-A22B MoE [hf:Qwen/Qwen3-30B-A3B family scaling; hf].

128 experts, top-8, expert d_ff=1536, no shared expert. (Qwen3 uses
QK-norm instead of QKV bias; neither is modeled — parameter shapes
match the assignment sheet.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    head_dim=128, d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, capacity_factor=1.25,
    qkv_bias=False, rope_theta=1e6, norm="rmsnorm", norm_eps=1e-6,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)

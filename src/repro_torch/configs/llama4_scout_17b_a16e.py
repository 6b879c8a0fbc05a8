"""Llama-4-Scout 17B-active 16-expert MoE
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

top-1 routing + shared expert; early-fusion multimodal — vision
frontend is a stub per the assignment (text backbone only). Chunked-
attention layers modeled as full attention (hence long_500k skip).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    num_experts=16, experts_per_token=1, shared_expert_ff=8192,
    capacity_factor=1.25,
    qkv_bias=False, rope_theta=5e5, norm="rmsnorm", norm_eps=1e-5,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)

"""Qwen2-VL-7B [arXiv:2409.12191; hf Qwen/Qwen2-VL-7B-Instruct].

M-RoPE (temporal/height/width position streams, sections 16/24/24) on
the qwen2-7b text backbone. Vision tower + dynamic-resolution patching
are a stub per the assignment: input_specs() provides pre-merged patch/
token embeddings and the (3, B, S) position streams.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
    embeds_input=True, norm="rmsnorm", norm_eps=1e-6,
    source="arXiv:2409.12191; hf",
)

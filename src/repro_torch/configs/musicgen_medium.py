"""MusicGen-medium [arXiv:2306.05284; hf facebook/musicgen-medium].

Decoder-only transformer over EnCodec tokens. The EnCodec frontend and
4-codebook delay pattern are a stub per the assignment: input_specs()
provides precomputed frame embeddings (B, S, d); the head predicts one
2048-way codebook. RoPE stands in for the learned positions (noted).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    head_dim=64, d_ff=6144, vocab_size=2048,
    embeds_input=True, qkv_bias=False, rope_theta=1e4,
    norm="layernorm", norm_eps=1e-5,
    source="arXiv:2306.05284; hf",
)

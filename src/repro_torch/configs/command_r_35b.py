"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified].

Cohere block: parallel attention+FFN residual, LayerNorm (no bias),
tied embeddings, logit scaling. GQA kv=8 per the assignment sheet.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22528, vocab_size=256000,
    qkv_bias=False, rope_theta=8e6, norm="layernorm",
    parallel_block=True, tie_embeddings=True, logit_scale=0.0625,
    norm_eps=1e-5, source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)

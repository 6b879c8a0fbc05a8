"""Cohere Command-R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
    head_dim=128, d_ff=33792, vocab_size=256000,
    qkv_bias=False, rope_theta=75e6, norm="layernorm",
    parallel_block=True, tie_embeddings=True, logit_scale=0.0625,
    norm_eps=1e-5, source="hf:CohereForAI/c4ai-command-r-plus; unverified",
)

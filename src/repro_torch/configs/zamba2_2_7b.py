"""Zamba2-2.7B [arXiv:2411.15242; hf Zyphra/Zamba2-2.7B] — hybrid.

54 Mamba-2 layers + a *shared* full-attention block applied every 6
layers (per-invocation LoRA deltas folded into the shared block —
noted simplification, parameter shapes unchanged). MHA: kv=32.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    head_dim=80, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, attn_period=6,
    qkv_bias=False, rope_theta=1e4, norm="rmsnorm", norm_eps=1e-5,
    source="arXiv:2411.15242; hf",
)

"""Falcon-Mamba-7B [arXiv:2410.05355; unverified] — pure Mamba-1.

Attention-free: KV-cache compression is inapplicable (DESIGN.md
§Arch-applicability); long_500k runs natively (O(1) state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_dt_rank=256,
    norm="rmsnorm", norm_eps=1e-5,
    source="arXiv:2410.05355; unverified",
)

"""Architecture registry: --arch <id> resolves here.

A copy of ``repro.configs`` (plain data, no JAX): every arch id
resolves, and ``repro_torch.models.model.init_params`` builds every
family.
"""
from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec, smoke

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "command-r-35b": "command_r_35b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-1.5b": "qwen2_1_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


# long_500k policy (see DESIGN.md §4): sub-quadratic archs only.
LONG_CONTEXT_ARCHS = {"falcon-mamba-7b", "zamba2-2.7b"}


def shape_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True

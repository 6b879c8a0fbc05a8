#!/usr/bin/env python3
"""Run chosen phases of ``chip_smoke.py`` on the card and time each.

    python3 tools/smoke_phases.py ssm:64 ssm:16 moe
    python3 tools/smoke_phases.py hybrid embeds hybrid:18

Each argument names a phase: ``ssm`` (phase 9: falcon-mamba,
its depth after the colon, the smoke's own ``SSM_LAYERS`` without one),
``serving`` (phase 7: Qwen2-1.5B), ``moe`` (phase ``moe``: Qwen3-MoE),
``hybrid`` (phase ``hybrid``: zamba2-2.7b, its depth after the colon,
``HYB_LAYERS`` without one), ``embeds`` (phase ``embeds``: qwen2-vl-7b
and musicgen-medium), ``train`` (phase 10: the launcher and Qwen2-1.5B's
steps), ``train_ssm`` (phase 10s: the scan's backward kernel,
falcon-mamba's and zamba2's steps), ``moe_ep`` (phase ``moe_ep``: the
expert-parallel MoE branch over two gloo ranks) or ``dryrun`` (phase
``dryrun``: ``launch/dryrun.py``'s cells on a fake process group, and
the card's bf16 matrix rate and copy bandwidth).
Needs one CUDA device and ``nvcc``; builds every kernel first. Prints the
card line (``nvidia-smi`` name and power limit), the phases' own JSON
lines, and after each one ``{"phase_seconds": ..., "phase": ...}``: the
host clock around it, the way its cost in the whole smoke is read. A
phase's checks raise as they do in the smoke.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main(argv) -> int:
    smoke = load_smoke()
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    print(smoke.device_mod.card_line(), flush=True)
    smoke._build.build_all()
    phases = {"ssm": smoke.ssm_slice, "serving": smoke.serving_slice,
              "moe": smoke.moe_slice, "hybrid": smoke.hybrid_slice,
              "embeds": smoke.embeds_slice,
              "train": lambda: smoke.train_slice({}),
              "train_ssm": lambda: smoke.train_ssm_slice({}),
              "moe_ep": smoke.moe_ep_slice, "dryrun": smoke.dryrun_slice}
    depths = {"ssm": ("SSM_LAYERS", smoke.SSM_LAYERS),
              "hybrid": ("HYB_LAYERS", smoke.HYB_LAYERS)}
    for arg in argv:
        name, _, depth = arg.partition(":")
        if name in depths:
            attr, default = depths[name]
            setattr(smoke, attr, int(depth) if depth else default)
        t0 = time.perf_counter()
        phases[name]()
        seconds = time.perf_counter() - t0
        print(json.dumps({"phase_seconds": seconds, "phase": arg}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

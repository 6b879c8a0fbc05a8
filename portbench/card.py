"""The device a run measures: the CUDA card.

``harness.run`` reads the device only through this object (synchronise,
the peak allocation, freeing, the kernels' build, its name), so the
measured path holds no branch on the kind of device. ``run.py`` passes a
``Card``; the CPU tests pass one of their own (``portbench/tests``).
"""

from __future__ import annotations

import gc
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (out.stdout.strip().splitlines() or [out.stderr.strip()])[0]


class Card:
    """The first CUDA card, driving the program's hand-written kernels."""

    platform = "gpu"
    device = "cuda"  # where the inputs are made and the reference runs
    backend = "cuda"  # the program's kernels

    def build(self, libraries: Sequence[str]) -> Dict[str, object]:
        """Load the program's kernel ``libraries`` (``csrc/<name>.cu``),
        building with ``nvcc`` those not built yet, one ``nvcc`` each at
        once: ``{"build_s", "built"}``, the seconds it took and the
        libraries it had to build."""
        from repro_torch import _build

        t0 = time.perf_counter()
        built = sorted(n for n in libraries
                       if not _build._lib_path(n).exists())
        with ThreadPoolExecutor(max(1, len(libraries))) as pool:
            list(pool.map(_build.library, libraries))
        return {"build_s": time.perf_counter() - t0, "built": built}

    def sync(self) -> None:
        torch.cuda.synchronize()

    def reset_peak(self) -> None:
        torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated()

    def free(self) -> None:
        gc.collect()
        torch.cuda.empty_cache()

    def kind(self) -> str:
        return torch.cuda.get_device_name(0)

    def describe(self) -> str:
        return card_line()

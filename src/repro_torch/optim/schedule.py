"""LR schedule: linear warmup + cosine decay (the production default).

Port of ``repro.optim.schedule``, in float32 as the reference computes it.
"""

from __future__ import annotations

import math
from typing import Union

import torch


def warmup_cosine(step: Union[int, torch.Tensor], *, peak_lr: float,
                  warmup: int, total: int, floor_frac: float = 0.1
                  ) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), as a float32
    tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (
        floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)

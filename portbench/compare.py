"""The comparison that decides ``correct``.

Each number compared has a limit of its own, in ``limits/<cell>.json``
(see PERF.md for the readings each was set from):

* ``<field>_rel_err``: max |got - want| / max |want| over the whole
  field, ``want`` the plain reference's in-core run of as many steps as
  the program ran; a field with a value that is not finite reads inf;
* ``wire_bytes_off``: how far, in bytes and crossings summed over the
  summary's keys, the program's transfer summary lies from the block
  plan's, over the window and over the whole run (limit 0).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SLAB = 64  # planes compared at once


def field_error(got, want: torch.Tensor,
                slab: int = SLAB) -> Tuple[float, float]:
    """(max |got - want|, max |want|), slab by slab on ``want``'s device
    and in its type (``got``: a host array or a tensor); the first is inf
    where ``got`` is not finite or misshapen."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf, float(want.abs().max())
    err = scale = 0.0
    for z0 in range(0, got.shape[0], slab):
        w = want[z0:z0 + slab]
        g = torch.as_tensor(got[z0:z0 + slab]).to(w.device)
        if not bool(torch.isfinite(g).all()):
            return math.inf, float(want.abs().max())
        err = max(err, float((g.to(w.dtype) - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err, scale


def rel_err(got, want: torch.Tensor) -> float:
    err, scale = field_error(got, want)
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def wire_off(got: Dict[str, int], want: Dict[str, int], sweeps: int) -> int:
    """Sum over ``want``'s keys of |got - sweeps * want|."""
    return sum(abs(int(got.get(k, 0)) - sweeps * v) for k, v in want.items())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], List[str]]:
    """``(correct, {name: {"value", "limit"}}, failed names)``: every
    number at or under its limit, and every limit read."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for limits {missing}")
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    failed = [k for k, v in table.items()
              if not (v["value"] <= v["limit"])]
    return not failed, table, failed

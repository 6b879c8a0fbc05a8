"""The general generator: a cell's initial fields from its seed.

The traffic mix's ``inputs`` parameters say what the fields look like;
the seed draws where: the pulse's centre, the velocity layers' depths,
steps and dip. Every seed gives the same sizes and the same kind of
field, so the work is the seed's in values only.

* ``p_cur``: a Ricker-like pulse ``(1 - 2 r^2) exp(-r^2)``, r in units
  of ``width`` times the volume's largest extent, its centre the
  volume's moved by up to ``jitter`` of each extent;
* ``p_prev``: ``prev_scale`` times ``p_cur``;
* ``vel2``: smooth dipping layers between ``lo`` and ``hi``: the sum of
  ``layers`` tanh steps (depths drawn in [0.1, 0.9] Z, heights summing
  to 1, each ``transition`` Z wide) of a depth tilted by up to ``dip``
  along y and x.

The scalars come from numpy's generator on the host; the fields are
computed on the device, in the configuration's type, a slab of planes
at a time, so the same seed gives the same bits on every call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

FIELDS = ("p_prev", "p_cur", "vel2")
SLAB = 64  # planes computed at once


@dataclass(frozen=True)
class Draw:
    """The seed's scalars."""

    centre: Tuple[float, float, float]
    depths: Tuple[float, ...]
    heights: Tuple[float, ...]
    dip: Tuple[float, float]


def draw(seed: int, shape, params: dict) -> Draw:
    rng = np.random.default_rng(int(seed) % 2**64)
    jit = params["jitter"]
    centre = tuple(float((s - 1) / 2 + rng.uniform(-jit, jit) * s)
                   for s in shape)
    k = int(params["layers"])
    depths = tuple(float(d) for d in np.sort(rng.uniform(0.1, 0.9, k))
                   * shape[0])
    heights = tuple(float(h) for h in rng.dirichlet(np.ones(k)))
    dip = tuple(float(d) for d in rng.uniform(-params["dip"],
                                               params["dip"], 2))
    return Draw(centre, depths, heights, dip)


def _axes(shape, z0: int, z1: int, dtype, device):
    z = torch.arange(z0, z1, dtype=dtype, device=device)[:, None, None]
    y = torch.arange(shape[1], dtype=dtype, device=device)[None, :, None]
    x = torch.arange(shape[2], dtype=dtype, device=device)[None, None, :]
    return z, y, x


def slab(name: str, d: Draw, shape, params: dict, z0: int, z1: int,
         dtype: torch.dtype, device) -> torch.Tensor:
    """Planes [z0, z1) of field ``name``."""
    z, y, x = _axes(shape, z0, z1, dtype, device)
    if name in ("p_cur", "p_prev"):
        w = params["width"] * max(shape)
        cz, cy, cx = d.centre
        r2 = ((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2) / (w * w)
        p = (1.0 - 2.0 * r2) * torch.exp(-r2)
        return params["prev_scale"] * p if name == "p_prev" else p
    if name == "vel2":
        lo, hi = params["vel2"]
        t = params["transition"] * shape[0]
        depth = (z + d.dip[0] * (y - (shape[1] - 1) / 2)
                 + d.dip[1] * (x - (shape[2] - 1) / 2))
        s = torch.zeros_like(depth)
        for dk, hk in zip(d.depths, d.heights):
            s = s + hk * (0.5 * (1.0 + torch.tanh((depth - dk) / t)))
        return (lo + (hi - lo) * s).clamp_(lo, hi)
    raise KeyError(name)


def slabs(shape, step: int = SLAB) -> Iterator[Tuple[int, int]]:
    for z0 in range(0, shape[0], step):
        yield z0, min(shape[0], z0 + step)


def on_device(name: str, seed: int, shape, params: dict,
              dtype: torch.dtype, device) -> torch.Tensor:
    """The whole field ``name`` as a device tensor."""
    d = draw(seed, shape, params)
    out = torch.empty(shape, dtype=dtype, device=device)
    for z0, z1 in slabs(shape):
        out[z0:z1] = slab(name, d, shape, params, z0, z1, dtype, device)
    return out


def on_host(name: str, seed: int, shape, params: dict, dtype: torch.dtype,
            device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole field ``name`` made on ``device`` and brought to a host
    tensor (``out`` when given) a slab at a time."""
    d = draw(seed, shape, params)
    host = torch.empty(shape, dtype=dtype) if out is None else out
    for z0, z1 in slabs(shape):
        host[z0:z1].copy_(slab(name, d, shape, params, z0, z1, dtype,
                               device))
    return host

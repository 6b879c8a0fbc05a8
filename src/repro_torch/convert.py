"""Carry the state of a reference engine over into the port.

For this system the host unit store plays the role that weights play
for a model: it is the whole state of a run. ``wave_from_reference``
takes what the JAX package writes for a checkpoint,
``OOCConfig.to_dict()`` and ``HostUnitStore.state_dict()`` (numpy
leaves with crc32 metadata), and builds a port ``OutOfCoreWave`` whose
store holds the same units, every digest verified unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave


def wave_from_reference(
    cfg_dict: Dict[str, object],
    leaves: Dict[str, np.ndarray],
    meta: Dict[str, object],
    sweeps_done: int,
    device: device_mod.DeviceLike = None,
    *,
    temporal: int = 1,
) -> OutOfCoreWave:
    """A port engine resuming the reference's run.

    ``cfg_dict``'s own ``backend`` names a backend of the reference
    (``"ref"`` or ``"pallas"``) and is not carried over: the port runs
    the CUDA kernels on a CUDA device and the plain versions on the CPU.
    ``temporal`` must be the fusion the snapshot's unit layout was made
    under; a mismatch raises.
    """
    dev = device_mod.resolve(device)
    d = dict(cfg_dict)
    d["backend"] = "cuda" if dev.type == "cuda" else "ref"
    d["device"] = str(dev)
    cfg = OOCConfig.from_dict(d)
    return OutOfCoreWave.from_state(cfg, leaves, meta, sweeps_done, temporal)

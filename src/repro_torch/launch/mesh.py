"""Production mesh construction.

Port of ``repro.launch.mesh``: the same axis names and shapes, as a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names`` (the mesh
``distributed.sharding`` resolves logical axes against). A mesh is built
only over an initialized process group of its size (give
``torch.distributed.init_process_group`` its address, world size and
rank); otherwise the call raises, naming the ranks that are missing.
The mesh's device comes from ``device.resolve``: ``cuda`` by default
(``NoCudaDevice`` without a card), the CPU only when the caller names
it (the CPU tests, and ``launch.dryrun`` over its in-process ``fake``
group). Functions, not module constants: importing this module touches
no device. A run across several cards is not checked on one H100.
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch import device as device_mod


def _device_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                 device: device_mod.DeviceLike = None):
    import torch.distributed as dist

    kind = device_mod.resolve(device).type
    need = math.prod(shape)
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)
    if have != need:
        missing = (f"ranks {have}..{need - 1} are missing" if have < need
                   else f"ranks {need}..{have - 1} are too many")
        raise RuntimeError(
            f"a {shape} mesh over {axes} needs an initialized process "
            f"group of {need} ranks; it has {have}: {missing}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: device_mod.DeviceLike = None):
    """16x16 = 256 ranks a pod over ``data, model``; 2 pods = 512 ranks
    over ``pod, data, model``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device)


def make_mesh_for_devices(n: int, model_parallel: int = 1,
                          device: device_mod.DeviceLike = None):
    """Elastic variant: ``(n // model_parallel, model_parallel)`` over
    ``data, model``, for whatever ranks exist (tests, examples)."""
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model-parallel "
                         f"groups of {model_parallel}")
    return _device_mesh((n // model_parallel, model_parallel),
                        ("data", "model"), device)

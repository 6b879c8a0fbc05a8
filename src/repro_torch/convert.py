"""Carry the state of a reference run over into the port.

For the stencil engine the host unit store plays the role that weights
play for a model: it is the whole state of a run. ``wave_from_reference``
takes what the JAX package writes for a checkpoint,
``OOCConfig.to_dict()`` and ``HostUnitStore.state_dict()`` (numpy
leaves with crc32 metadata), and builds a port ``OutOfCoreWave`` whose
store holds the same units, every digest verified unchanged.

For the decoder, ``params_from_reference`` takes the reference's
parameter tree and ``cache_from_reference`` its decode cache, both as
numpy leaves (the caller does the ``np.asarray``), so a reference run
can be resumed in the port mid-sequence. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave
from repro_torch.models import model as M


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


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a numpy leaf on ``device``, bits unchanged (the port
    writes caches in place): uint32 crosses as an int32 view, bfloat16
    (numpy's ``ml_dtypes`` type) as a uint16 view."""
    a = np.array(a, order="C")
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_reference(cfg: ModelConfig, leaves: Mapping[str, object],
                          device: device_mod.DeviceLike = None) -> M.Model:
    """The port's model holding the reference's parameters.

    ``leaves`` is the reference's tree as numpy arrays: ``layers`` maps
    each leaf name to its ``(L, ...)`` stack (as ``jax.vmap`` made it),
    beside ``final_norm``, ``lm_head`` and ``embed``. Every leaf must
    match a parameter of the port by name and shape, and the other way
    round."""
    dev = device_mod.resolve(device)
    model = M.Model(cfg, device=dev, dtype=M.dtype_of(cfg))
    layers = dict(leaves["layers"])
    top = {k: v for k, v in leaves.items() if k != "layers"}
    want_layer = {name for name, _ in model.layers[0].named_parameters()}
    want_top = {name for name, _ in model.named_parameters()
                if not name.startswith("layers.")}
    if set(layers) != want_layer or set(top) != want_top:
        raise KeyError(
            f"reference leaves {sorted(layers)} + {sorted(top)} do not match "
            f"the port's {sorted(want_layer)} + {sorted(want_top)}")
    with torch.no_grad():
        for name, stack in layers.items():
            for i, lp in enumerate(model.layers):
                getattr(lp, name).copy_(_tensor(np.asarray(stack)[i], dev))
        for name, leaf in top.items():
            getattr(model, name).copy_(_tensor(np.asarray(leaf), dev))
    return model


def cache_from_reference(cache_leaves: Mapping[str, object],
                         device: device_mod.DeviceLike = None
                         ) -> Union[M.DecodeCache, M.CompressedCache]:
    """The port's cache holding a reference ``DecodeCache`` or
    ``CompressedCache``, given as its fields (``cache._asdict()``) with
    numpy arrays (``None`` for an absent field)."""
    dev = device_mod.resolve(device)
    kind = M.CompressedCache if "payload_k" in cache_leaves else M.DecodeCache
    if set(cache_leaves) != set(kind._fields):
        raise KeyError(f"cache fields {sorted(cache_leaves)} are neither a "
                       f"DecodeCache's nor a CompressedCache's")
    fields = {
        name: None if a is None else _tensor(np.asarray(a), dev)
        for name, a in cache_leaves.items() if name != "length"
    }
    return kind(**fields, length=int(np.asarray(cache_leaves["length"])))

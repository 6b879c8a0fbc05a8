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
can be resumed in the port mid-sequence. For training,
``params_to_reference`` and ``opt_state_to_reference`` give the
reference's trees back (per-layer leaves stacked ``(L, ...)``) and
``opt_state_from_reference`` takes its ``AdamWState``: a checkpoint of
``(params, opt_state)`` in those trees resumes in either package.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState


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
    (numpy's ``ml_dtypes`` type) as a uint16 view; a tensor is copied."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device).clone()
    a = np.array(a, order="C")
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32)).to(device).view(torch.uint32)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _array(a):
    """A leaf as numpy, or as it is when it is a tensor (bfloat16)."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def params_from_reference(cfg: ModelConfig, leaves: Mapping[str, object],
                          device: device_mod.DeviceLike = None) -> M.Model:
    """The port's model holding the reference's parameters.

    ``leaves`` is the reference's tree as numpy arrays: ``layers`` maps
    each leaf name to its ``(L, ...)`` stack (as ``jax.vmap`` made it),
    beside ``final_norm``, ``lm_head``, ``embed`` and, for the hybrid,
    the ``shared_attn`` subtree of single leaves. Every leaf must match a
    parameter of the port by name and shape, and the other way round."""
    dev = device_mod.resolve(device)
    model = M.Model(cfg, device=dev, dtype=M.dtype_of(cfg))
    layers = dict(leaves["layers"])
    top = {}
    for key, leaf in leaves.items():
        if key == "layers":
            continue
        if isinstance(leaf, Mapping):
            top.update({f"{key}.{name}": a for name, a in leaf.items()})
        else:
            top[key] = leaf
    want_layer = {name for name, _ in model.layers[0].named_parameters()}
    want_top = {name for name, _ in model.named_parameters()
                if not name.startswith("layers.")}
    if set(layers) != want_layer or set(top) != want_top:
        raise KeyError(
            f"reference leaves {sorted(layers)} + {sorted(top)} do not match "
            f"the port's {sorted(want_layer)} + {sorted(want_top)}")
    with torch.no_grad():
        for name, stack in layers.items():
            stack = _array(stack)
            for i, lp in enumerate(model.layers):
                getattr(lp, name).copy_(_tensor(stack[i], dev))
        for name, leaf in top.items():
            model.get_parameter(name).copy_(_tensor(_array(leaf), dev))
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


def _host(t: torch.Tensor):
    """A host copy of ``t``: numpy, or a CPU tensor for bfloat16 (numpy
    has no bfloat16; the checkpoint writes its bits as the reference's)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _to_reference_tree(tensors: Mapping[str, torch.Tensor]):
    """A name -> tensor mapping in ``Model.named_parameters()`` naming as
    the reference's tree: ``layers`` holds each per-layer leaf stacked
    ``(L, ...)``, ``shared_attn`` (the hybrid's) its leaves as they are."""
    tree: Dict[str, object] = {}
    for key, names in M.stacked_leaves(tensors).items():
        parts = [tensors[n].detach() for n in names]
        if "/" not in key:
            tree[key] = _host(parts[0])
            continue
        sub, leaf = key.split("/", 1)
        tree.setdefault(sub, {})[leaf] = _host(
            torch.stack(parts) if sub == "layers" else parts[0])
    return tree


def _from_reference_tree(tree: Mapping[str, object], names,
                         device: torch.device) -> Dict[str, torch.Tensor]:
    """Inverse of ``_to_reference_tree`` for the parameter names
    ``names``: every name's piece of its reference leaf on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    for key, group in M.stacked_leaves(names).items():
        if "/" not in key:
            out[key] = _tensor(tree[key], device)
            continue
        sub, leaf = key.split("/", 1)
        if sub == "layers":
            for i, name in enumerate(group):
                out[name] = _tensor(tree[sub][leaf][i], device)
        else:
            out[group[0]] = _tensor(tree[sub][leaf], device)
    return {n: out[n] for n in names}


def params_to_reference(model: M.Model):
    """The reference's parameter tree of ``model`` (the inverse of
    ``params_from_reference``): host arrays, per-layer leaves stacked
    ``(L, ...)`` under ``layers``, the hybrid's ``shared_attn`` subtree."""
    return _to_reference_tree(dict(model.named_parameters()))


def opt_state_to_reference(state: AdamWState) -> AdamWState:
    """The reference's ``AdamWState`` of a port state: ``step`` a 0-d
    int32 array, ``m``, ``v`` (and ``ef``, or None) parameter trees."""
    conv = lambda d: None if d is None else _to_reference_tree(d)
    return AdamWState(np.asarray(state.step.cpu().numpy(), np.int32),
                      conv(state.m), conv(state.v), conv(state.ef))


def opt_state_from_reference(model: M.Model, state,
                             device: device_mod.DeviceLike = None
                             ) -> AdamWState:
    """A port ``AdamWState`` for ``model``'s parameters from the
    reference's (numpy leaves, e.g. from ``checkpoint.restore``), on
    ``device`` (default the model's)."""
    dev = model.device if device is None else device_mod.resolve(device)
    names = [n for n, _ in model.named_parameters()]
    conv = lambda t: None if t is None else _from_reference_tree(
        t, names, dev)
    step = torch.as_tensor(np.array(state.step), dtype=torch.int32,
                           device=dev)
    return AdamWState(step, conv(state.m), conv(state.v), conv(state.ef))

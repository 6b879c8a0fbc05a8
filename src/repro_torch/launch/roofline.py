"""Roofline terms of a step, from a count of what one rank runs.

Port of ``repro.launch.roofline``. Three terms, each in seconds a step
of the *per-device* program:

  compute    = dot_flops_per_device / peak_flops
  memory     = hbm_bytes_per_device / hbm_bytes_per_s
  collective = collective_bytes_per_device / link_bytes_per_s

``repro`` reads them from the compiled HLO of an XLA program (its
``parse_hlo``). The port makes no such text: ``StepCounter``, a
``TorchDispatchMode``, counts one run of the step's function instead.
Over DTensors it leaves each DTensor operator to DTensor
(``NotImplemented``) and counts the operators DTensor then runs on the
local shards and the functional collectives it issues, so every number
is what one rank runs (``FlopCounterMode`` around DTensor operators
would count the global operator); the shape inference DTensor runs on
fake tensors of the global shapes is not counted. On a mesh of the CPU
device type (the dry run's) DTensor moves a shard from one dimension to
another by an all-gather and a chunk (on a CUDA mesh it would issue an
all-to-all): counted as the all-gather it is. It counts, under
``repro``'s conventions:

- ``dot_flops``: matrix products (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, and ``matmul`` where inference mode hands it over whole)
  by ``torch.utils.flop_counter``'s formulas: 2 · M · N · K each, as
  ``parse_hlo``'s dots;
- ``buffer_bytes``: the HBM proxy, twice the bytes of each
  materialised result (views, allocations and aliases excluded; an
  operator in place counts its update, as ``parse_hlo``'s scatter and
  dynamic-update-slice do). The results are an eager run's, one buffer
  an operator, where ``parse_hlo`` reads XLA's fused program: an
  unfused upper bound, 1.03-1.90 times ``parse_hlo``'s on the families'
  smoke train steps (``tests/test_torch_roofline.py``), so the memory
  term and a "memory" dominant are not comparable with ``repro``'s;
- ``collectives``: wire bytes by kind: an all-gather's result, a
  reduce-scatter's result times the group size, an all-reduce's result;
- ``launches``: the operators counted into ``buffer_bytes``, one
  kernel launch each in an eager run.

The hardware is a ``Hardware`` record passed in; the default,
``H100_SXM``, holds the H100 SXM5 data sheet's dense bf16 peak, HBM3
bandwidth and NVLink bandwidth a direction, not measured numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A card's peak rates, per device."""

    name: str
    peak_flops: float  # FLOP/s, the step's matrix type
    hbm_bytes_per_s: float
    link_bytes_per_s: float  # one direction, per device


# NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s dense BF16 tensor core
# (1,979 with sparsity), 3.35 TB/s HBM3, NVLink 900 GB/s both ways
H100_SXM = Hardware("H100 SXM5 (data sheet)", peak_flops=989.4e12,
                    hbm_bytes_per_s=3.35e12, link_bytes_per_s=450e9)

# functional collectives (``torch.distributed._functional_collectives``)
# by kind, and the position of their group size (reduce-scatter's wire
# bytes scale by it)
_COLLECTIVE_OPS = {
    "all_reduce": ("all-reduce", None),
    "all_gather_into_tensor": ("all-gather", None),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
}
# allocations: no HBM traffic and no kernel of their own
_NO_BUFFER = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided"}
_DOT_OPS = {"mm", "addmm", "bmm", "baddbmm"}


def _aliases(outs, ins) -> bool:
    """An output shares its storage with an input (a view, or an op in
    place)."""
    def key(t):
        return t.untyped_storage()._cdata

    seen = {key(t) for t in ins}
    return any(key(t) in seen for t in outs)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepCounter(TorchDispatchMode):
    """Counts one rank's matrix flops, HBM proxy bytes, collective wire
    bytes and launches while active (see the module docstring). Read
    ``dot_flops``, ``buffer_bytes``, ``collectives`` and ``launches``
    after the run."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.buffer_bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.launches = 0

    def __enter__(self):
        # DTensor infers each operator's global output shape and, for an
        # operator it places through a decomposition, its strategy by
        # running them on tensors of the global shapes: nothing a rank
        # runs, so not counted
        from torch.distributed.tensor._decompositions import (
            DecompShardingStrategy)
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)

        self._inferring = 0
        self._restore = []
        for cls, attr in ((ShardingPropagator,
                           "_propagate_tensor_meta_non_cached"),
                          (DecompShardingStrategy, "propagate_strategy")):
            inner = getattr(cls, attr)
            self._restore.append((cls, attr, inner))
            setattr(cls, attr, self._uncounted(inner))
        return super().__enter__()

    def _uncounted(self, inner):
        def run(*args, **kwargs):
            self._inferring += 1
            try:
                return inner(*args, **kwargs)
            finally:
                self._inferring -= 1

        return run

    def __exit__(self, *exc):
        for cls, attr, inner in self._restore:
            setattr(cls, attr, inner)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if self._inferring:
            return out
        name = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        nbytes = sum(_nbytes(t) for t in outs)
        if name in _COLLECTIVE_OPS:
            kind, group_at = _COLLECTIVE_OPS[name]
            wire = nbytes * (int(args[group_at]) if group_at else 1)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + wire
        elif func.is_view or name in _NO_BUFFER or not outs:
            return out
        elif _aliases(outs, ins):
            if not func._schema.is_mutable:
                return out  # a view by another name (reshape, to, ...)
            # in place: the update's bytes, as parse_hlo counts a
            # scatter or a dynamic-update-slice
            nbytes = _nbytes(ins[-1]) if len(ins) > 1 else 0
        if name in _DOT_OPS:
            from torch.utils.flop_counter import flop_registry

            self.dot_flops += flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        elif name == "matmul":
            # under inference mode it reaches the mode whole: 2 flops a
            # result element a step of the contracted dimension
            self.dot_flops += 2.0 * out.numel() * args[0].shape[-1]
        self.buffer_bytes += 2 * nbytes
        self.launches += 1
        return out

    def as_dict(self) -> Dict:
        return {"dot_flops": self.dot_flops,
                "buffer_bytes": self.buffer_bytes,
                "collectives": dict(self.collectives),
                "launches": self.launches}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    chips: int
    hardware: Hardware = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.hardware.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.hardware.hbm_bytes_per_s

    @property
    def collective_s(self) -> float:
        return (self.collective_bytes_per_device
                / self.hardware.link_bytes_per_s)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (chips * counted flops): remat/redundancy
        waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the card's peak the step achieves on its useful
        FLOPs if it runs exactly at the bounding term: the score."""
        ideal = self.model_flops / (self.chips * self.hardware.peak_flops)
        return ideal / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N active."""
    n = cfg.active_params_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    flops = 2.0 * n * tokens
    if cfg.has_attention:
        kv_layers = (
            cfg.num_layers // cfg.attn_period if cfg.attn_period
            else cfg.num_layers
        )
        flops += (
            4.0 * tokens * kv_layers * shape.seq_len
            * cfg.num_kv_heads * cfg.head_dim
        )
    return flops

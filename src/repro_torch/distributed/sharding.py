"""Logical-axis sharding rules, and the out-of-core domain partitioner
(``ShardSpec``, ``partition_domain``).

Port of ``repro.distributed.sharding``, both halves.

**Logical axes.** Model code annotates tensors with *logical* axis names
(``logical(x, "batch", "seq", "embed")``); a rules table maps logical
names to mesh axes; ``resolve_spec`` turns a tensor's logical axes into
one entry a dimension (``None``, a mesh axis name or a tuple of them),
the same entries as ``tuple()`` of the reference's ``PartitionSpec``.
A mesh is anything whose ``.shape`` maps axis names to sizes (a JAX
``AbstractMesh`` does) or a ``torch.distributed`` ``DeviceMesh`` with
``mesh_dim_names``. ``named_sharding_tree`` gives each leaf of a tree
its DTensor placements over the mesh's dimensions (``Shard(i)`` /
``Replicate()``). Outside ``use_rules``, and on a mesh whose axes are
all of size 1, every annotation is ``x`` itself, so the same model code
runs on one device unchanged. A run across several cards is not
checked here (one H100); the CPU tests hold the specs to the
reference's and place shards over two gloo ranks.

**The partitioner.** The Z-block decomposition of
``core.blocks.BlockPlan`` is split into contiguous block ranges, one
per shard. Each shard owns the storage units its blocks write back (its
remainders plus its *left*-boundary common) and keeps a read-only
*ghost* of its right-boundary common, refreshed once a round by a
versioned halo put from the right neighbour (see
``core.sharded.ShardedExecutor``). The partition is a pure function of
``(ndiv, nshards)``. Shards are pinned round-robin onto an explicit
list of ``torch.device``s (``devices=``); there is no ``mesh=``
argument.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Rules = Dict[str, Optional[Union[str, Tuple[str, ...]]]]

# Baseline rule set (the reference's): FSDP over `data`, tensor parallel
# over `model`, pure data parallel over `pod`.
DEFAULT_RULES: Rules = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "moe_experts": "model",
    "vocab_out": "model",
    # params
    "p_vocab": "model",
    "p_embed": "data",
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_mlp": "model",
    "p_experts": "model",
    "p_embed_alt": None,  # second embed axis on attn/mlp weights
    # optimizer / cache
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
    "cache_kv_heads": None,
}

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(mesh, rules: Rules):
    """Annotate under ``mesh`` and ``rules`` inside the block (this
    thread only)."""
    old = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = old


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh, in the mesh's dimension order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _mesh_axis_size(sizes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def resolve_spec(
    logical_axes: Sequence[Optional[str]],
    shape: Optional[Sequence[int]] = None,
    rules: Optional[Rules] = None,
    mesh=None,
) -> Spec:
    """Map logical axes to one entry a dimension, dropping mesh axes the
    mesh lacks, axes that do not divide the dimension (replicated
    instead) and axes used twice; the reference's ``resolve_spec``."""
    rules = rules if rules is not None else (current_rules() or {})
    mesh = mesh if mesh is not None else current_mesh()
    sizes = axis_sizes(mesh) if mesh is not None else None
    used: set = set()
    out: List[Optional[Union[str, Tuple[str, ...]]]] = []
    for i, name in enumerate(logical_axes):
        axis = rules.get(name) if name else None
        if axis is None:
            out.append(None)
            continue
        flat = tuple(
            a for a in (axis if isinstance(axis, tuple) else (axis,))
            if sizes is None or a in sizes  # drop absent mesh axes
        )
        if not flat or any(a in used for a in flat):
            out.append(None)
            continue
        # a one-name tuple is that name (as PartitionSpec normalises it)
        axis = flat if len(flat) > 1 else flat[0]
        if sizes is not None and shape is not None:
            if shape[i] % _mesh_axis_size(sizes, axis) != 0:
                out.append(None)
                continue
        used.update(flat)
        out.append(axis)
    return tuple(out)


def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` over the mesh's dimensions: mesh
    axis ``a`` named by entry ``i`` shards dimension ``i``
    (``Shard(i)``), an axis no entry names replicates."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for i, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = i
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_sizes(mesh))


def is_dtensor(t) -> bool:
    """``t`` is a DTensor (the classes load only when asked)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def logical(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Annotate an activation with logical axes: ``x`` itself without
    rules or on a mesh of size-1 axes; under a mesh of more ranks a
    DTensor is redistributed to the resolved placements, a plain tensor
    returned unchanged."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    if all(n == 1 for n in axis_sizes(mesh).values()):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = resolve_spec(axes, x.shape, rules, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def _is_axes_leaf(a) -> bool:
    """An axes annotation is a plain tuple of axis names (NamedTuples
    like AdamWState/DecodeCache must keep being traversed)."""
    return isinstance(a, tuple) and not hasattr(a, "_fields") and all(
        e is None or isinstance(e, str) for e in a
    )


def map_axes(fn, axes_tree, shape_tree):
    """``fn(axes, leaf)`` over the leaves of an axes tree (dicts, lists,
    tuples, NamedTuples; an axes tuple is a leaf, ``None`` stays
    ``None``) and the tree of tensors or specs of the same structure."""
    if axes_tree is None:
        return None
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, shape_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, shape_tree[k])
                for k, v in axes_tree.items()}
    parts = [map_axes(fn, a, s) for a, s in zip(axes_tree, shape_tree)]
    if hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*parts)
    return type(axes_tree)(parts)


def named_sharding_tree(axes_tree, shape_tree, mesh, rules: Rules):
    """The DTensor placements of every leaf of ``shape_tree`` (tensors,
    meta tensors or anything with ``.shape``; a host scalar, such as a
    cache's ``length``, has shape ``()``) over ``mesh``, from its logical
    axes in ``axes_tree``: the counterpart of the reference's
    ``NamedSharding`` tree."""
    return map_axes(
        lambda axes, leaf: placements(resolve_spec(
            axes, tuple(getattr(leaf, "shape", ())), rules, mesh), mesh),
        axes_tree, shape_tree)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One shard of the out-of-core Z decomposition: the contiguous
    global block range ``[block_lo, block_hi)`` of a ``BlockPlan`` with
    ``ndiv`` blocks, shard ``index`` of ``nshards``.

    * **owned units**: ``R_i`` for every local block, plus the common at
      the shard's left boundary (``C_{block_lo-1}``) and every interior
      common: the units local writebacks commit (block *i* writes
      ``R_i`` and ``C_{i-1}``);
    * **ghost units**: the right-boundary common ``C_{block_hi-1}``,
      committed by the right neighbour's first block and mirrored here
      by a versioned halo put each round.

    ``device`` optionally pins the shard to a ``torch.device``; it is
    left out of ``to_dict`` and of equality, so a checkpoint restores on
    another layout of devices.
    """

    index: int
    nshards: int
    block_lo: int
    block_hi: int
    ndiv: int
    device: Optional[Any] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if not 0 <= self.index < self.nshards:
            raise ValueError(f"shard index {self.index} outside "
                             f"0..{self.nshards - 1}")
        if not 0 <= self.block_lo < self.block_hi <= self.ndiv:
            raise ValueError(
                f"block range [{self.block_lo}, {self.block_hi}) is not "
                f"a non-empty part of 0..{self.ndiv}"
            )

    @property
    def first(self) -> bool:
        """The shard holding global block 0 (the bottom edge)."""
        return self.block_lo == 0

    @property
    def last(self) -> bool:
        """The shard holding global block ndiv-1 (the top edge)."""
        return self.block_hi == self.ndiv

    @property
    def nblocks(self) -> int:
        return self.block_hi - self.block_lo

    @property
    def blocks(self) -> range:
        """Global block indices this shard executes, in visit order."""
        return range(self.block_lo, self.block_hi)

    def owned_units(self) -> List[Tuple[str, int]]:
        """Units committed by local writebacks: every local remainder and
        the commons ``C_{block_lo-1} .. C_{block_hi-2}``."""
        out = [("R", i) for i in self.blocks]
        lo = self.block_lo - 1 if not self.first else self.block_lo
        out += [("C", j) for j in range(lo, self.block_hi - 1)]
        return out

    def ghost_units(self) -> List[Tuple[str, int]]:
        """Units mirrored from the right neighbour: its left common."""
        return [] if self.last else [("C", self.block_hi - 1)]

    def unit_keys(self) -> List[Tuple[str, int]]:
        """Every unit in this shard's host store (owned and ghost)."""
        return sorted(self.owned_units() + self.ghost_units())

    def halo_units(self) -> List[Tuple[str, int]]:
        """Units this shard exports each round: its committed left common
        (the encoded payload, to the left neighbour's ghost) and the
        held lower half of its right common (raw planes, to the right
        neighbour's writeback)."""
        out = []
        if not self.first:
            out.append(("C", self.block_lo - 1))
        if not self.last:
            out.append(("C", self.block_hi - 1))
        return out

    def to_dict(self) -> Dict[str, int]:
        """JSON-able layout for checkpoint manifests, with no device."""
        return {
            "index": self.index, "nshards": self.nshards,
            "block_lo": self.block_lo, "block_hi": self.block_hi,
            "ndiv": self.ndiv,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, int],
                  device: Optional[Any] = None) -> "ShardSpec":
        return cls(
            index=int(d["index"]), nshards=int(d["nshards"]),
            block_lo=int(d["block_lo"]), block_hi=int(d["block_hi"]),
            ndiv=int(d["ndiv"]), device=device,
        )


def pins(devices: Optional[Sequence[Any]], n: int) -> List[Optional[Any]]:
    """``n`` device pins round-robin over ``devices`` (each a
    ``torch.device``), or ``n`` Nones when no devices are given."""
    if not devices:
        return [None] * n
    devs = [torch.device(d) for d in devices]
    return [devs[d % len(devs)] for d in range(n)]


def partition_domain(
    ndiv: int,
    nshards: int,
    *,
    devices: Optional[Sequence[Any]] = None,
) -> List[ShardSpec]:
    """Partition ``ndiv`` Z blocks over ``nshards`` contiguous shards:
    shard ``d`` gets blocks ``[floor(d*ndiv/N), floor((d+1)*ndiv/N))``,
    sizes differing by at most one block.

    ``devices`` pins the shards round-robin onto those devices; without
    it the shards carry no pin and each runs on its config's device.
    """
    if nshards < 1:
        raise ValueError(f"nshards must be >= 1, got {nshards}")
    if nshards > ndiv:
        raise ValueError(
            f"cannot split ndiv={ndiv} blocks over nshards={nshards} "
            "shards: every shard needs at least one block"
        )
    cuts = [d * ndiv // nshards for d in range(nshards + 1)]
    return [
        ShardSpec(index=d, nshards=nshards, block_lo=cuts[d],
                  block_hi=cuts[d + 1], ndiv=ndiv, device=pin)
        for d, pin in enumerate(pins(devices, nshards))
    ]

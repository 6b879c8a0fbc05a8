"""The out-of-core domain partitioner: ``ShardSpec`` and
``partition_domain``.

Port of the second half of ``repro.distributed.sharding``. The Z-block
decomposition of ``core.blocks.BlockPlan`` is split into contiguous
block ranges, one per shard. Each shard owns the storage units its
blocks write back (its remainders plus its *left*-boundary common) and
keeps a read-only *ghost* of its right-boundary common, refreshed once
a round by a versioned halo put from the right neighbour (see
``core.sharded.ShardedExecutor``). The partition is a pure function of
``(ndiv, nshards)``.

Shards are pinned round-robin onto an explicit list of ``torch.device``s
(``devices=``). There is no JAX ``Mesh`` here, so there is no ``mesh=``
argument. The reference module's first half, the logical-axis rules of
the LM's sharding hints (``DEFAULT_RULES``, ``resolve_spec``,
``logical``, ``named_sharding_tree``), is not ported here: it goes with
the logical-axis half of sharding (ROADMAP queue 1 item 21).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch


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

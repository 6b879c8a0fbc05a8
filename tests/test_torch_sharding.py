"""The port's domain partitioner (``repro_torch.distributed.sharding``)
against the JAX package's: pure Python, so equal exactly.

Over an (ndiv, nshards) grid: every shard's block range, topology flags
and unit footprints (owned, ghost, all, halo) and its ``to_dict``; the
same rejections; device pins round-robin over ``torch.device``s, left
out of the dict and of equality.
"""

import pytest
import torch

from repro.distributed import sharding as jsh
from repro_torch.distributed import sharding as tsh

GRID = [(ndiv, n) for ndiv in (1, 2, 3, 4, 5, 7, 8, 12)
        for n in range(1, ndiv + 1)]


def _view(spec):
    return (spec.index, spec.nshards, spec.block_lo, spec.block_hi,
            spec.ndiv, spec.first, spec.last, spec.nblocks,
            list(spec.blocks), spec.owned_units(), spec.ghost_units(),
            spec.unit_keys(), spec.halo_units(), spec.to_dict())


@pytest.mark.parametrize("ndiv,nshards", GRID)
def test_partition_and_footprints_equal_reference(ndiv, nshards):
    ref = jsh.partition_domain(ndiv, nshards)
    got = tsh.partition_domain(ndiv, nshards)
    assert [_view(s) for s in got] == [_view(s) for s in ref]
    # the shards tile the blocks, and the owned units tile the plan's
    assert [b for s in got for b in s.blocks] == list(range(ndiv))
    owned = sorted(u for s in got for u in s.owned_units())
    assert owned == sorted([("R", i) for i in range(ndiv)]
                           + [("C", j) for j in range(ndiv - 1)])
    for s in got:
        assert tsh.ShardSpec.from_dict(s.to_dict()) == s
        assert s.device is None


@pytest.mark.parametrize("ndiv,nshards", [(4, 0), (4, -1), (3, 4), (1, 2)])
def test_partition_rejections_equal_reference(ndiv, nshards):
    with pytest.raises(ValueError) as jerr:
        jsh.partition_domain(ndiv, nshards)
    with pytest.raises(ValueError) as terr:
        tsh.partition_domain(ndiv, nshards)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", [
    dict(index=2, nshards=2, block_lo=0, block_hi=1, ndiv=4),
    dict(index=0, nshards=1, block_lo=2, block_hi=2, ndiv=4),
    dict(index=0, nshards=1, block_lo=0, block_hi=5, ndiv=4),
])
def test_invalid_spec_rejected(bad):
    with pytest.raises(ValueError):
        tsh.ShardSpec(**bad)


def test_device_pins_round_robin_and_not_persisted():
    devs = [torch.device("cpu"), "cpu"]
    specs = tsh.partition_domain(8, 3, devices=devs)
    assert [s.device for s in specs] == [torch.device("cpu")] * 3
    assert tsh.pins(None, 3) == [None, None, None]
    assert tsh.pins(["cpu", "meta"], 3) == [
        torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    for s in specs:
        assert "device" not in s.to_dict()
        back = tsh.ShardSpec.from_dict(s.to_dict(), device="cpu")
        assert back == s and back.device == "cpu"

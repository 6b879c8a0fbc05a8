"""The port's sharded engine (``repro_torch.core.sharded.ShardedExecutor``)
on the CPU with the plain versions, at the reference's test size
((96, 12, 10), ndiv 4):

* against the JAX package's ``ShardedExecutor`` on the same numpy
  inputs: the transfer multiset (halos included, bytes and blocks), the
  summary with its per-device breakdown and each shard's store wire log
  exactly; the fields within ``tests/test_torch_outofcore.py``'s
  ``GATHER_RTOL`` (the engines may disagree on one ``rint`` of the
  codec);
* inside the port, for 2 and 4 shards across schedules unitgrain, depth2
  and temporal2 × budgets 0 and 1 << 30: bit for bit the port's
  single-device engine, the transfers those of ``build_sharded_tasks``;
* a sharded checkpoint and restore bit for bit; incremental cuts point
  unchanged units at the previous cut's shards and gc keeps the cuts
  they reference; a straggling shard in ``stats()``; the mid-round cut
  guard; a corrupted halo put retried and verified as op ``"halo"``,
  with the model's attempt multiset under the same plan.
"""

import json
import pathlib
from collections import Counter

import numpy as np
import pytest

from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import paper_code_fields as jfields
from repro.core.sharded import ShardedExecutor as JSharded
from repro_torch.core.executor import AsyncExecutor
from repro_torch.core.outofcore import OOCConfig, paper_code_fields
from repro_torch.core.pipeline import V100_PCIE, sharded_timeline
from repro_torch.core.sharded import ShardedExecutor
from repro_torch.core.taskgraph import build_sharded_tasks
from repro_torch.distributed.fault import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    HeartbeatMonitor,
    RetryPolicy,
    UnrecoverableFault,
)
from test_torch_outofcore import GATHER_RTOL

SHAPE = (96, 12, 10)
NDIV = 4
SCHEDULES = [("unitgrain", 2), ("depth2", 2), ("temporal2", 1)]


def _initial(seed=0):
    rng = np.random.default_rng(seed)
    p_prev = rng.standard_normal(SHAPE, dtype=np.float32)
    p_cur = rng.standard_normal(SHAPE, dtype=np.float32)
    vel2 = (1.0 + rng.random(SHAPE, dtype=np.float32)) * 0.05
    return p_prev, p_cur, vel2


def _cfg(code=4, bt=2):
    return OOCConfig(SHAPE, NDIV, bt, paper_code_fields(code),
                     backend="ref", device="cpu")


def _sharded(nshards=2, code=4, bt=2, seed=0, **kw):
    kw.setdefault("schedule", "depth2")
    return ShardedExecutor(_cfg(code, bt), *_initial(seed),
                           nshards=nshards, **kw)


def _log(transfers):
    return sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                   t.raw_bytes, t.wire_bytes, t.block) for t in transfers)


# ----------------------------------------------------------------------
# against the JAX package's sharded engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("code", [1, 4])
@pytest.mark.parametrize("nshards,schedule,bt", [
    (2, "depth2", 2), (4, "depth2", 2), (2, "temporal2", 1)])
def test_transfers_and_fields_equal_reference(nshards, schedule, bt, code,
                                              budget):
    fields = _initial(2)
    ref = JSharded(JConfig(SHAPE, NDIV, bt, jfields(code)), *fields,
                   nshards=nshards, schedule=schedule, cache_bytes=budget)
    got = ShardedExecutor(_cfg(code, bt), *fields, nshards=nshards,
                          schedule=schedule, cache_bytes=budget)
    for eng in (ref, got):
        eng.run_sweeps(3)
        eng.finish()
    assert _log(got.transfers) == _log(ref.transfers)
    assert got.transfer_summary() == ref.transfer_summary()
    assert got.transfer_summary()["halo_count"] > 0
    for t, j in zip(got.shards, ref.shards):
        assert t.store.attempt_multiset() == j.store.attempt_multiset()
        assert t.cache.stats.as_dict() == j.cache.stats.as_dict()
    for name in ("p_prev", "p_cur"):
        want = ref.gather(name)
        np.testing.assert_allclose(got.gather(name), want, rtol=0,
                                   atol=GATHER_RTOL[code]
                                   * np.abs(want).max())
    got.close()


# ----------------------------------------------------------------------
# bit for bit the port's single-device engine; transfers its graph's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("schedule,bt", SCHEDULES)
@pytest.mark.parametrize("code", [1, 4])
@pytest.mark.parametrize("nshards", [2, 4])
def test_bit_identical_to_single_device(nshards, code, schedule, bt, budget):
    fields = _initial()
    single = AsyncExecutor(_cfg(code, bt), *fields, schedule=schedule,
                           cache_bytes=budget)
    single.run(3 * bt)
    sh = ShardedExecutor(_cfg(code, bt), *fields, nshards=nshards,
                         schedule=schedule, cache_bytes=budget)
    sh.run_sweeps(3)
    sh.finish()
    stats = {}
    tasks = build_sharded_tasks(_cfg(code, bt), nshards, sweeps=3,
                                schedule=schedule, cache_bytes=budget,
                                stats=stats)
    assert sorted((t.direction, t.field, t.unit, t.sweep, t.flush)
                  for t in sh.transfers) == sorted(
        (t.kind, t.field, t.unit, t.sweep, t.flush)
        for t in tasks if t.kind in ("h2d", "d2h", "halo"))
    summary = sh.transfer_summary()
    assert summary["halo_wire"] == sum(t.amount for t in tasks
                                       if t.kind == "halo")
    for d, ex in enumerate(sh.shards):
        cache = ex.stats()["cache"]
        for k in ("hits", "evictions", "flushes", "d2h_elided"):
            assert cache[k] == stats["per_device"][d][k], (d, k)
        assert cache["halo_count"] == summary["per_device"][d]["halo_count"]
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(sh.gather(name), single.gather(name))
    single.close()
    sh.close()


def test_pinned_shards_run_on_their_device():
    sh = _sharded(devices=["cpu"])
    assert [str(s.device) for s in sh.specs] == ["cpu", "cpu"]
    assert all(ex.device.type == "cpu" and ex.cfg.device == "cpu"
               for ex in sh.shards)
    sh.run_sweeps(2)
    assert sh.gather("p_cur").shape == SHAPE
    sh.close()


# ----------------------------------------------------------------------
# checkpoints: a consistent global cut, incremental, gc
# ----------------------------------------------------------------------
@pytest.mark.parametrize("nshards", [2, 4])
def test_checkpoint_restore_bit_identical(tmp_path, nshards):
    sh = _sharded(nshards, seed=1, cache_bytes=1 << 30)
    d = str(tmp_path)
    sh.run_sweeps(2)
    sh.checkpoint(d, zstd_level=0)
    sh.run_sweeps(1)
    paths = sh.checkpoint(d, zstd_level=0, incremental=True)
    assert [pathlib.Path(p).parent.name for p in paths] == [
        f"shard{i:02d}" for i in range(nshards)]
    sh.run_sweeps(1)
    want = {n: sh.gather(n) for n in ("p_prev", "p_cur")}
    rest = ShardedExecutor.restore(d, device="cpu")
    assert rest.sweeps_done == 3 and rest.rounds_done == 3
    assert [s.to_dict() for s in rest.specs] == [
        s.to_dict() for s in sh.specs]
    assert rest.shards[0].cache.budget_bytes == 1 << 30
    rest.run_sweeps(1)
    for n, arr in want.items():
        np.testing.assert_array_equal(rest.gather(n), arr)
    again = ShardedExecutor.restore(d, devices=["cpu"])
    assert all(str(s.device) == "cpu" for s in again.specs)
    for eng in (sh, rest, again):
        eng.close()


def test_incremental_cuts_reuse_units_and_gc_keeps_sources(tmp_path):
    sh = _sharded(2)
    d = tmp_path
    sh.run_sweeps(1)
    sh.checkpoint(str(d), zstd_level=0, keep=1)
    sh.run_sweeps(1)
    sh.checkpoint(str(d), zstd_level=0, keep=1, incremental=True)
    for shard in ("shard00", "shard01"):
        steps = sorted(p for p in (d / shard).iterdir()
                       if p.name.startswith("step_"))
        # keep=1, but the first cut is referenced by the second
        assert [p.name for p in steps] == ["step_0000000001",
                                           "step_0000000002"]
        m = json.loads((steps[1] / "manifest.json").read_text())
        ext = {k: e for k, e in m["leaves"].items() if "dir" in e}
        # the read-only velocity never moves: every vel2 leaf is reused
        assert ext and all(e["dir"] == steps[0].name for e in ext.values())
        assert {k.split(".")[0] for k in ext} == {"vel2"}
    assert sum(ex.ckpt_stats["units_reused"] for ex in sh.shards) > 0
    want = sh.gather("p_cur")
    rest = ShardedExecutor.restore(str(d), device="cpu")
    np.testing.assert_array_equal(rest.gather("p_cur"), want)
    sh.run_sweeps(1)
    sh.checkpoint(str(d), zstd_level=0, keep=1, incremental=False)
    for shard in ("shard00", "shard01"):
        assert [p.name for p in (d / shard).iterdir()
                if p.name.startswith("step_")] == ["step_0000000003"]
    sh.close()
    rest.close()


def test_mid_round_cut_guard(tmp_path):
    sh = _sharded(2)
    sh.run_sweeps(1)
    sh.shards[0].sweep(1)  # one shard ahead, behind the coordinator
    with pytest.raises(RuntimeError, match="sweep cursors"):
        sh.checkpoint(str(tmp_path))
    sh2 = _sharded(2)
    sh2.sweep()
    # the coordinator took the round's held slices; one delivered now
    # would be pending at the cut
    assert sh2.shards[0].take_held() == {}
    sh2.shards[1].deliver_held("p_cur", np.zeros(1))
    with pytest.raises(RuntimeError, match="held import"):
        sh2.checkpoint(str(tmp_path))
    sh.close()
    sh2.close()


# ----------------------------------------------------------------------
# the heartbeat and the halo wire
# ----------------------------------------------------------------------
def test_straggler_shard_surfaces_in_stats():
    sh = _sharded(2, monitor=HeartbeatMonitor(2, straggler_factor=1.2))
    # a scripted clock: each round reads beat(0), beat(1), then the
    # straggler check; shard 1's cadence is 5x shard 0's
    ticks = []
    for r in range(4):
        ticks += [r * 1.0, r * 5.0, r * 5.0 + 0.1]
    it = iter(ticks)
    sh._timer = lambda: next(it, ticks[-1])
    sh.run_sweeps(4)
    st = sh.stats()
    assert st["heartbeat"]["straggler_rounds"] >= 1
    rows = [r for r in sh.recovery_log if r["kind"] == "straggler"]
    assert rows and all(1 in r["shards"] for r in rows)
    assert st["heartbeat"]["median_round_time_s"] is not None
    assert set(st["per_device"]) == {0, 1}
    sh.close()


def test_corrupt_halo_put_retried_and_verified():
    """A halo put corrupted once in flight fails its digest, is retried
    and lands: the result bit for bit a clean run's, the crossing in the
    importer's wire log at two attempts, as the model prices it. Without
    a retry the run raises before the ghost is written."""
    plan = FaultPlan([FaultSpec("corrupt", op="halo", field="p_prev",
                                version=1)])
    sh = _sharded(2, injector=FaultInjector(plan),
                  retry=RetryPolicy(attempts=3))
    clean = _sharded(2)
    for eng in (sh, clean):
        eng.run_sweeps(3)
        eng.finish()
    importer = sh.shards[0].store
    halos = Counter(e for e in importer.wire_log if e[0] == "halo")
    assert halos[("halo", "p_prev", "C1", 1, 2)] == 1
    assert importer.wire_stats["checksum_failures"] == 1
    assert importer.wire_stats["d2h_retries"] == 1
    live = Counter()
    for ex in sh.shards:
        live.update(ex.store.wire_log)
    model = sharded_timeline(_cfg(), V100_PCIE, 2, sweeps=3,
                             faults=plan, retry=RetryPolicy(attempts=3))
    assert live == model.attempt_multiset()
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(sh.gather(name), clean.gather(name))
    bad = _sharded(2, injector=FaultInjector(plan))
    with pytest.raises(UnrecoverableFault, match="halo"):
        bad.run_sweeps(1)
    for eng in (sh, clean, bad):
        eng.close()

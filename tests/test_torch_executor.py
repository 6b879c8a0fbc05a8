"""The port's live engine (``repro_torch.core.executor.AsyncExecutor``)
on the CPU with the plain versions (``device="cpu"``, ``backend="ref"``):
the contract of ``tests/test_executor.py`` on the port.

* bit for bit equal to the port's ``OutOfCoreWave`` across schedules
  (``temporal-2`` included) × residency budgets × write policies, and
  with a ``RateController``;
* its transfer log equal, as a multiset, to the port's task-graph model
  (h2d, d2h and flush records, flush bytes exact, wire totals within
  the model's 2% codec padding) and to the JAX package's live engine on
  the same numpy inputs (exactly, bytes included), with the fields
  within ``tests/test_torch_outofcore.py``'s ``GATHER_RTOL`` of that
  engine's (its jitted stencil drifts a few ulps from the port's eager
  one);
* the window: depth accounting, open across a sweep boundary, the
  fetch-after-writeback hazard held in the store's wire log;
* write-back residency: versions committed on the device only, a failed
  flush leaving its entry dirty, a ``reissue=`` second attempt;
* the wire under a fault injector: a corrupt crossing is retried, or
  raises before the unit it guards is decoded or committed;
* the parts not ported yet raise naming their ROADMAP items;
* float64 at the paper's rates: bit for bit the float64 sync engine, its
  transfers those of the task graph, every assembly of one type.
"""

import functools
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core.executor import AsyncExecutor as JExecutor
from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import paper_code_fields as jfields
from repro.distributed import fault as jfault
from repro_torch import device as device_mod
from repro_torch.core.executor import AsyncExecutor
from repro_torch.core import outofcore as outofcore_mod
from repro_torch.core.streams import Lanes
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave, \
    paper_code_fields
from repro_torch.core.ratecontrol import RateController
from repro_torch.core.taskgraph import build_sweep_tasks, depth_k, \
    wire_totals
from repro_torch.distributed.fault import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    ReissuePolicy,
    RetryPolicy,
    UnrecoverableFault,
)
from repro_torch.kernels.stencil import ref as stencil_ref
from repro_torch.kernels.zfp import ops as zfp_ops
from test_torch_outofcore import GATHER_RTOL

SHAPE = (96, 12, 12)
BUDGETS = [0, 100_000, 1 << 30]  # off / evicting / everything fits
SCHEDULES = ["paper", "unitgrain", "depth1", "depth2", "depth3",
             "temporal-2"]
SWEEPS = 4


def _initial():
    p_cur = stencil_ref.ricker_source(SHAPE).numpy()
    return (0.95 * p_cur).astype(np.float32), p_cur, \
        np.full(SHAPE, 0.07, np.float32)


def _bt(schedule):
    # temporal-2 at bt 2 would widen the halo past ndiv 4's blocks
    name = getattr(schedule, "name", schedule)
    return 1 if name.startswith("temporal") else 2


def _cfg(code=4, ndiv=4, bt=2):
    return OOCConfig(SHAPE, ndiv, bt, paper_code_fields(code),
                     backend="ref", device="cpu")


@functools.lru_cache(maxsize=None)
def _sync(code, ndiv, bt, temporal, sweeps):
    eng = OutOfCoreWave(_cfg(code, ndiv, bt), *_initial(), temporal=temporal)
    eng.run(sweeps * bt)
    return {n: eng.gather(n) for n in ("p_prev", "p_cur", "vel2")}


def _live(code=4, ndiv=4, schedule="depth2", sweeps=SWEEPS, **kw):
    bt = _bt(schedule)
    live = AsyncExecutor(_cfg(code, ndiv, bt), *_initial(),
                         schedule=schedule, **kw)
    live.run(sweeps * bt)
    return live


def _model_log(tasks):
    return sorted((t.kind, t.field, t.unit, t.sweep, t.flush,
                   int(t.amount) if t.flush else None)
                  for t in tasks if t.kind in ("h2d", "d2h"))


def _live_log(live):
    return sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                   t.wire_bytes if t.flush else None)
                  for t in live.transfers)


def _check_against_model(live, cfg, schedule, budget, policy, rates=None):
    """The live log (after ``run``, before any gather flush) against
    the graph of the same run."""
    stats = {}
    tasks = build_sweep_tasks(cfg, sweeps=SWEEPS, schedule=schedule,
                              cache_bytes=budget, policy=policy,
                              stats=stats, rates=rates)
    assert _live_log(live) == _model_log(tasks)
    modeled, real = wire_totals(tasks), live.transfer_summary()
    for d in ("h2d", "d2h"):
        assert real[f"{d}_wire"] == pytest.approx(modeled[d], rel=0.02,
                                                  abs=1)
    cache = live.stats()["cache"]
    for k in ("hits", "evictions", "flushes", "d2h_elided",
              "d2h_elided_wire_bytes", "dirty_bytes"):
        assert cache[k] == stats[k], k


@pytest.mark.parametrize("policy", ["write-back", "write-through"])
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_bit_identical_and_model_log(schedule, budget, policy):
    live = _live(schedule=schedule, cache_bytes=budget, policy=policy)
    bt = _bt(schedule)
    _check_against_model(live, _cfg(bt=bt), schedule, budget, policy)
    temporal = live.temporal
    want = _sync(4, 4, bt, temporal, SWEEPS // temporal * temporal)
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(live.gather(name), want[name])
    assert live.stats()["cache"]["dirty_bytes"] == 0


@pytest.mark.parametrize("code,ndiv", [(1, 4), (2, 4), (4, 3)])
def test_codes_and_block_counts_bit_identical(code, ndiv):
    live = _live(code, ndiv, cache_bytes=100_000)
    want = _sync(code, ndiv, 2, 1, SWEEPS)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), want[name])
    lanes = live.stats()["lanes"]
    assert lanes["streams"] == 0 and lanes["pinned_bytes"] == 0
    assert lanes["host_jobs"] > 0
    assert 0 <= lanes["crc_wait_s"] <= lanes["host_wait_s"]


def test_caller_wait_counts_the_awaited_jobs_digest(monkeypatch):
    # the job digests for 0.2 s once the caller waits on it: that part of
    # the wait is crc32 on the caller's critical path
    real = outofcore_mod.unit_checksum

    def slow(value, version):
        time.sleep(0.2)
        return real(value, version)

    monkeypatch.setattr(outofcore_mod, "unit_checksum", slow)
    lanes = Lanes(torch.device("cpu"), slot_bytes=256, slots=1, threads=1)
    go, spans = threading.Event(), []
    unit = np.arange(8, dtype=np.float32)

    def job():
        go.wait()
        return lanes.digest(unit, 3, spans)

    fut = lanes._submit(job)
    go.set()
    try:
        assert lanes._result(fut, spans) == real(unit, 3)
    finally:
        lanes.close()
    assert len(spans) == 1 and spans[0][1] - spans[0][0] >= 0.2
    assert 0.15 < lanes.crc_wait_s <= lanes.wait_s


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_rates_bit_identical_and_model_log(mode, budget):
    cfg = _cfg()
    sync = OutOfCoreWave(cfg, *_initial(), rates=RateController(
        cfg, mode=mode, error_budget=1e-2))
    sync.run(SWEEPS * cfg.bt)
    rates = RateController(cfg, mode=mode, error_budget=1e-2)
    live = _live(cache_bytes=budget, rates=rates)
    _check_against_model(live, cfg, "depth2", budget, "write-back", rates)
    assert rates.state_dict() == sync.rates.state_dict()
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))
    if mode == "adaptive":  # units really changed rate on the wire
        assert len({t.wire_bytes for t in live.transfers
                    if t.field == "p_prev" and t.unit == ("R", 1)}) > 1


def _jax_live(code, schedule, budget, sweeps, **kw):
    bt = _bt(schedule)
    live = JExecutor(JConfig(SHAPE, 4, bt, jfields(code)), *_initial(),
                     schedule=schedule, cache_bytes=budget, **kw)
    live.run(sweeps * bt)
    return live


def _multiset(live):
    return Counter((t.direction, t.field, t.unit, t.sweep, t.block,
                    t.raw_bytes, t.wire_bytes, t.flush, t.reissued)
                   for t in live.transfers)


@pytest.mark.parametrize("code,schedule,budget", [
    (1, "depth2", 0), (2, "unitgrain", 100_000), (4, "depth3", 1 << 30),
    (4, "temporal-2", 100_000), (4, "paper", 100_000),
])
def test_matches_reference_live_engine(code, schedule, budget):
    jlive = _jax_live(code, schedule, budget, 2)
    tlive = _live(code, schedule=schedule, cache_bytes=budget, sweeps=2)
    assert _multiset(tlive) == _multiset(jlive)
    assert tlive.stats()["cache"] == jlive.stats()["cache"]
    assert tlive.max_inflight == jlive.max_inflight
    for name in ("p_prev", "p_cur", "vel2"):
        want = jlive.gather(name)
        tol = GATHER_RTOL[code] * np.abs(want).max()
        np.testing.assert_allclose(tlive.gather(name), want, rtol=0,
                                   atol=tol)
    assert _multiset(tlive) == _multiset(jlive)  # the gather flushes too


@pytest.mark.parametrize("k", [1, 2, 3])
def test_inflight_window_depth_accounting(k):
    live = _live(1, schedule=depth_k(k), sweeps=2)
    stats = live.stats()
    assert stats["depth"] == k
    assert stats["max_inflight"] == min(k, 4)


def test_window_stays_open_across_sweep_boundary():
    cfg = _cfg(1)
    live = AsyncExecutor(cfg, *_initial(), schedule="depth2")
    live.sweep()
    assert live.stats()["pending"] == 2  # tail of sweep 0 still parked
    assert not any(t.direction == "d2h" and t.block >= 2
                   for t in live.transfers)
    live.sweep()
    live.finish()
    by_sweep = {}
    for t in live.transfers:
        if t.direction == "d2h":
            by_sweep.setdefault(t.sweep, set()).add(t.unit)
    assert set(by_sweep) == {0, 1} and by_sweep[0] == by_sweep[1]


def test_fetch_after_writeback_hazard_in_wire_log():
    """Every fetch of a read-write unit crosses the version the last
    writeback committed, after that writeback landed on the host."""
    live = _live(2, schedule="depth3", sweeps=3)
    landed = set()
    for op, field, unit, ver, _ in live.store.wire_log:
        if op == "d2h":
            landed.add((field, unit, ver))
        elif field != "vel2" and ver > 0:
            assert (field, unit, ver) in landed, (field, unit, ver)
    assert sum(op == "h2d" and ver == 2
               for op, _, _, ver, _ in live.store.wire_log) > 0


def test_gather_drains_pending_window():
    cfg = _cfg(1)
    sync = OutOfCoreWave(cfg, *_initial())
    live = AsyncExecutor(cfg, *_initial())
    sync.sweep()
    live.sweep()  # tail still parked: gather must drain it
    np.testing.assert_array_equal(live.gather("p_cur"),
                                  sync.gather("p_cur"))


def test_writeback_commits_on_device_until_flushed():
    live = _live(2, cache_bytes=1 << 30, sweeps=3)
    assert live.transfer_summary()["d2h_wire"] == 0
    assert live.store.version_of("p_prev", "R", 1) == 3
    assert live.store.host_version_of("p_prev", "R", 1) == 0
    assert not live.store.host_current("p_prev", "R", 1)
    with pytest.raises(RuntimeError, match="stale"):
        live.store.get("p_prev", "R", 1)
    live.flush()
    assert live.store.host_current("p_prev", "R", 1)
    assert live.store.host_version_of("p_prev", "R", 1) == 3


def _flaky(live):
    """Fail the store's next put once."""
    put = live.store.put
    state = {"failed": False}

    def flaky(*args, **kw):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("injected flush failure")
        return put(*args, **kw)

    live.store.put = flaky


def test_flush_failure_leaves_dirty_for_retry():
    live = _live(2, cache_bytes=1 << 30, sweeps=2)
    dirty = live.stats()["cache"]["dirty_bytes"]
    assert dirty > 0
    _flaky(live)
    with pytest.raises(RuntimeError, match="injected"):
        live.flush()
    assert live.stats()["cache"]["dirty_bytes"] == dirty
    assert live.flush() > 0
    assert live.stats()["cache"]["dirty_bytes"] == 0
    want = _sync(2, 4, 2, 1, 2)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), want[name])


def test_flush_reissue_second_attempt():
    live = _live(2, cache_bytes=1 << 30, sweeps=2, reissue=ReissuePolicy())
    _flaky(live)
    assert live.flush() > 0
    assert live.stats()["cache"]["flush_reissues"] == 1
    assert sum(t.reissued for t in live.transfers) == 1
    assert live.stats()["cache"]["dirty_bytes"] == 0
    want = _sync(2, 4, 2, 1, 2)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), want[name])


def _plan(mod, specs):
    return mod.FaultInjector(mod.FaultPlan([mod.FaultSpec(**s)
                                            for s in specs]))


SPECS = [dict(kind="corrupt", op="h2d", field="p_prev", unit="R1"),
         dict(kind="transfer", op="d2h", field="p_cur", unit="C0"),
         dict(kind="corrupt", op="d2h", field="p_prev", unit="R2",
              version=1)]


@pytest.mark.parametrize("budget", [0, 100_000])
def test_injected_faults_retry_like_reference(budget):
    jlive = _jax_live(4, "depth2", budget, 2, injector=_plan(jfault, SPECS),
                      retry=jfault.RetryPolicy(attempts=2))
    tlive = _live(4, cache_bytes=budget, sweeps=2,
                  injector=FaultInjector(FaultPlan(
                      [FaultSpec(**s) for s in SPECS])),
                  retry=RetryPolicy(attempts=2))
    assert tlive.store.attempt_multiset() == jlive.store.attempt_multiset()
    assert tlive.store.wire_stats == jlive.store.wire_stats
    assert tlive.store.wire_stats["checksum_failures"] > 0
    assert tlive.stats()["cache"]["h2d_retries"] > 0
    want = _sync(4, 4, 2, 1, 2)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(tlive.gather(name), want[name])


def test_corrupt_fetch_raises_before_decode(monkeypatch):
    """Without a retry, a corrupt H2D of p_prev.R1 (block 1's visit)
    raises before block 1 decodes anything."""
    decoded = []
    real = zfp_ops.decompress_units

    def record(cs, **kw):
        decoded.append(len(cs))
        return real(cs, **kw)

    monkeypatch.setattr(zfp_ops, "decompress_units", record)
    live = AsyncExecutor(_cfg(4), *_initial(), injector=FaultInjector(
        FaultPlan([FaultSpec("corrupt", op="h2d", field="p_prev",
                             unit="R1")])))
    with pytest.raises(UnrecoverableFault, match="h2d of unit p_prev.R1"):
        live.sweep()
    assert len(decoded) == 1  # block 0's visit only
    assert live.store.wire_stats["checksum_failures"] == 1


def test_corrupt_writeback_raises_before_commit():
    live = AsyncExecutor(_cfg(4), *_initial(), injector=FaultInjector(
        FaultPlan([FaultSpec("corrupt", op="d2h", field="p_prev",
                             unit="R0", version=1)])))
    crc0 = live.store.checksum_of("p_prev", "R", 0)
    with pytest.raises(UnrecoverableFault, match="d2h of unit p_prev.R0"):
        live.sweep()  # block 2's admission drains block 0's writebacks
    assert live.store.version_of("p_prev", "R", 0) == 0
    assert live.store.checksum_of("p_prev", "R", 0) == crc0


def test_crash_point_at_round_boundary():
    from repro_torch.distributed.fault import InjectedCrash

    live = AsyncExecutor(_cfg(1), *_initial(), injector=FaultInjector(
        FaultPlan([FaultSpec("crash", sweep=1)])))
    with pytest.raises(InjectedCrash, match="boundary 1"):
        live.run(3 * 2)
    assert live.sweeps_done == 1
    assert live.advance_round(3) == 1 and live.sweeps_done == 2


def test_unported_parts_raise_naming_their_items(monkeypatch):
    cfg = _cfg(1)
    with pytest.raises(NotImplementedError, match="item 11"):
        AsyncExecutor(cfg, *_initial(), shard=object())
    live = AsyncExecutor(cfg, *_initial())
    with pytest.raises(NotImplementedError, match="item 7b"):
        live.run(2, ckpt_policy=object())
    with pytest.raises(NotImplementedError, match="item 7c"):
        live.run(2, recovery=object())
    for call in (lambda: live.checkpoint("d"),
                 lambda: live.begin_checkpoint("d"),
                 lambda: AsyncExecutor.restore("d")):
        with pytest.raises(NotImplementedError, match="item 7b"):
            call()
    for call in (live.take_held, live.take_halo,
                 lambda: live.deliver_held("p_cur", None),
                 lambda: live.deliver_halo("p_cur", "C", 0, None, 1)):
        with pytest.raises(NotImplementedError, match="item 11"):
            call()
    with pytest.raises(ValueError, match="all three"):
        AsyncExecutor(cfg, *_initial()[:2], None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        AsyncExecutor(OOCConfig(SHAPE, 4, 2, paper_code_fields(1)),
                      *_initial())


@pytest.mark.parametrize("code,schedule,budget", [
    (4, "depth2", 100_000), (2, "paper", 0), (1, "temporal-2", 1 << 30)])
def test_f64_live_bit_identical_to_sync(code, schedule, budget, monkeypatch):
    """The live engine on float64 fields at the paper's rates (32/24):
    bit for bit the float64 sync engine after the same sweeps, its
    transfer log the task graph's (which prices itemsize 8), and every
    block assembly of float64 pieces only (the halo planes were float32,
    which ``torch.cat`` promotes silently)."""
    seen = []
    real_cat = torch.cat

    def cat(pieces, *args, **kwargs):
        seen.append({t.dtype for t in pieces})
        return real_cat(pieces, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", cat)
    bt = _bt(schedule)
    cfg = OOCConfig(SHAPE, 4, bt, paper_code_fields(code, f32=False),
                    backend="ref", device="cpu", dtype="float64")
    p_cur = stencil_ref.ricker_source(SHAPE, dtype=torch.float64).numpy()
    fields = (0.95 * p_cur, p_cur, np.full(SHAPE, 0.07))
    live = AsyncExecutor(cfg, *fields, schedule=schedule, cache_bytes=budget)
    live.run(SWEEPS * bt)
    _check_against_model(live, cfg, schedule, budget, "write-back")
    sync = OutOfCoreWave(cfg, *fields, temporal=live.temporal)
    sync.run(SWEEPS * bt)
    for name in ("p_prev", "p_cur", "vel2"):
        got = live.gather(name)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, sync.gather(name))
    live.close()
    assert seen and all(d == {torch.float64} for d in seen), seen

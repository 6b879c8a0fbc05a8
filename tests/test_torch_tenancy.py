"""The port's multi-tenant serving (``repro_torch.core.tenancy``,
``taskgraph.build_tenant_tasks``, ``pipeline.tenant_timeline``,
``serving.ooc.TenantScheduler`` and ``launch.serve --ooc``) against the
JAX package's, on the CPU with the plain versions, at the reference's
own test size ((32, 8, 8), ndiv 2, bt 1, code 2):

* ``interleave_rounds``, ``working_set_bytes`` (codes 1-4, every
  schedule, a float64 config under ``jax_enable_x64``) and
  ``build_tenant_tasks`` (every ``Task`` field, and ``stats``) equal
  exactly; ``tenant_timeline`` on ``V100_PCIE`` with its makespan and
  spans;
* ``TenantScheduler`` over ``tests/test_tenancy.py``'s two/three ×
  working/tight matrix: each tenant's transfer log and ``stats()``
  exactly the reference's, its fields within ``GATHER_RTOL`` of the
  reference's (the engines may disagree on one ``rint`` of the codec),
  bit for bit the port's solo engine, its transfers those of the merged
  graph; routed flushes logged by the victim;
* admission (reject, queue, retire), duplicates, priority eviction, the
  quota gauges, a per-tenant checkpoint cut, the modelled interleave
  against serial runs, ``TenantView``'s split and rollback, and
  ``serve.main(["--ooc", "--device", "cpu"])`` at the reference's
  defaults, its per-tenant stats those of the reference's ``run_ooc``.
"""

import argparse
import dataclasses

import numpy as np
import pytest

from repro.core import outofcore as jooc
from repro.core import pipeline as jpl
from repro.core import taskgraph as jtg
from repro.core import tenancy as jten
from repro.serving import ooc as jooc_serving
from repro_torch.core import outofcore as tooc
from repro_torch.core import pipeline as tpl
from repro_torch.core import taskgraph as ttg
from repro_torch.core import tenancy as tten
from repro_torch.core.executor import AsyncExecutor
from repro_torch.core.unitcache import DeviceResidencyManager, \
    ResidencyArbiter
from repro_torch.serving.ooc import AdmissionError, TenantScheduler
from test_torch_outofcore import GATHER_RTOL
from test_torch_pipeline import _view
from test_torch_stencil import _x64

SHAPE = (32, 8, 8)
CODE = 2
SCHEDULES = ["paper", "unitgrain", "depth2", "depth3", "temporal2"]

# (name, schedule, sweeps, priority), tests/test_tenancy.py's scenarios;
# seeds are positional
TWO = [("A", "depth2", 4, 10), ("B", "temporal2", 3, 0)]
THREE = [
    ("A", "unitgrain", 2, 10),
    ("B", "depth2", 4, 5),
    ("C", "temporal2", 3, 0),
]
SCENARIOS = {"two": TWO, "three": THREE}


def _initial(seed):
    rng = np.random.default_rng(seed)
    p_prev = rng.standard_normal(SHAPE).astype(np.float32)
    p_cur = rng.standard_normal(SHAPE).astype(np.float32)
    vel2 = (1.0 + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
    return p_prev, p_cur, vel2


def _cfg(code=CODE):
    return tooc.OOCConfig(SHAPE, 2, 1, tooc.paper_code_fields(code),
                          backend="ref", device="cpu")


def _jcfg(code=CODE):
    return jooc.OOCConfig(SHAPE, 2, 1, jooc.paper_code_fields(code))


def _budget(tenants, kind, cfg_of):
    """``tests/test_tenancy.py``'s regimes: ``working`` reserves every
    tenant's working set inside their sum; ``tight`` halves the budget
    and reserves half the top-priority tenant's working set only."""
    ws = {name: cfg_of.working_set(name, sched)
          for name, sched, _, _ in tenants}
    if kind == "working":
        return sum(ws.values()), dict(ws)
    top = max(tenants, key=lambda t: t[3])[0]
    return sum(ws.values()) // 2, {n: ws[n] // 2 if n == top else 0
                                   for n in ws}


class _Port:
    Scheduler = TenantScheduler
    cfg = staticmethod(_cfg)

    @staticmethod
    def working_set(name, sched):
        return tten.working_set_bytes(_cfg(), sched)


class _Ref:
    Scheduler = jooc_serving.TenantScheduler
    cfg = staticmethod(_jcfg)

    @staticmethod
    def working_set(name, sched):
        return jten.working_set_bytes(_jcfg(), sched)


def _submit_all(side, tenants, budget_kind):
    budget, reserves = _budget(tenants, budget_kind, side)
    sched = side.Scheduler(budget)
    for i, (name, schedule, sweeps, priority) in enumerate(tenants):
        sched.submit(name, side.cfg(), *_initial(i), schedule=schedule,
                     sweeps=sweeps, reserve=reserves[name],
                     priority=priority)
    return sched, budget


def _routed(sched):
    """Count the flushes routed to each victim, by depositor and victim."""
    counts = {}
    route = sched._route_flush
    current = {"who": None}

    def wrapped(tenant, key, ent):
        pair = (current["who"], tenant)
        counts[pair] = counts.get(pair, 0) + 1
        route(tenant, key, ent)

    for name, run in sched.tenants.items():
        run.executor.cache.router = wrapped
        adv = run.executor.advance_round

        def advance(target, _adv=adv, _name=name):
            current["who"] = _name
            try:
                return _adv(target)
            finally:
                current["who"] = None

        run.executor.advance_round = advance
    return counts


def _records(transfers):
    return [dataclasses.astuple(t) for t in transfers]


def _graph_log(tasks, name):
    return sorted((t.kind, t.field, t.unit, t.sweep, t.flush,
                   int(t.amount) if t.flush else None)
                  for t in tasks
                  if t.tenant == name and t.kind in ("h2d", "d2h"))


def _live_log(transfers):
    return sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                   t.wire_bytes if t.flush else None) for t in transfers)


def _solo(i, schedule, sweeps, code=CODE):
    solo = AsyncExecutor(_cfg(code), *_initial(i), schedule=schedule)
    solo.run(sweeps)
    return solo


def _specs(side, tenants, reserves):
    mod = tten if side is _Port else jten
    return [mod.TenantSpec(name, side.cfg(), sched, sweeps,
                           reserves[name], prio)
            for name, sched, sweeps, prio in tenants]


# ----------------------------------------------------------------------
# the pure policy: round order, working sets, graphs, timelines
# ----------------------------------------------------------------------
def test_interleave_rounds_equals_reference():
    for tenants in (TWO, THREE, [("x", "temporal3", 7, 0),
                                 ("y", "paper", 2, 0),
                                 ("z", "temporal2", 5, 0)]):
        reserves = {t[0]: 0 for t in tenants}
        got = tten.interleave_rounds(_specs(_Port, tenants, reserves))
        want = jten.interleave_rounds(_specs(_Ref, tenants, reserves))
        assert got == want
    a = tten.TenantSpec("a", None, "temporal2", sweeps=3)
    b = tten.TenantSpec("b", None, "unitgrain", sweeps=2)
    assert tten.interleave_rounds([a, b]) == [
        ("a", 0, 2), ("b", 0, 1), ("a", 2, 1), ("b", 1, 1)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_working_set_bytes_equals_reference(code, schedule):
    shape = (96, 12, 12)
    got = tten.working_set_bytes(
        tooc.OOCConfig(shape, 4, 1, tooc.paper_code_fields(code),
                       backend="ref", device="cpu"), schedule)
    want = jten.working_set_bytes(
        jooc.OOCConfig(shape, 4, 1, jooc.paper_code_fields(code)), schedule)
    assert got == want > 0


def test_working_set_bytes_float64_equals_reference():
    shape = (96, 12, 12)
    with _x64():
        for code in (1, 4):
            jcfg = jooc.OOCConfig(shape, 4, 1,
                                  jooc.paper_code_fields(code, f32=False),
                                  dtype="float64")
            tcfg = tooc.OOCConfig(shape, 4, 1,
                                  tooc.paper_code_fields(code, f32=False),
                                  backend="ref", device="cpu",
                                  dtype="float64")
            for schedule in ("depth2", "temporal2"):
                assert (tten.working_set_bytes(tcfg, schedule)
                        == jten.working_set_bytes(jcfg, schedule))


@pytest.mark.parametrize("policy", ["write-back", "write-through"])
@pytest.mark.parametrize("budget_kind", ["off", "working", "tight"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_build_tenant_tasks_equals_reference(scenario, budget_kind, policy):
    tenants = SCENARIOS[scenario]
    if budget_kind == "off":
        budget, reserves = 0, {t[0]: 0 for t in tenants}
    else:
        budget, reserves = _budget(tenants, budget_kind, _Port)
    js, ts = {}, {}
    jt = jtg.build_tenant_tasks(_specs(_Ref, tenants, reserves), budget,
                                stats=js, policy=policy)
    tt = ttg.build_tenant_tasks(_specs(_Port, tenants, reserves), budget,
                                stats=ts, policy=policy)
    assert [dataclasses.astuple(t) for t in tt] == [
        dataclasses.astuple(t) for t in jt]
    assert ts == js
    assert {t.tenant for t in tt} == {t[0] for t in tenants}
    assert ttg.wire_totals(tt) == jtg.wire_totals(jt)


@pytest.mark.parametrize("budget_kind", ["working", "tight"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tenant_timeline_equals_reference(scenario, budget_kind):
    tenants = SCENARIOS[scenario]
    budget, reserves = _budget(tenants, budget_kind, _Port)
    js, ts = {}, {}
    jt = jpl.tenant_timeline(_specs(_Ref, tenants, reserves),
                             jpl.V100_PCIE, budget_bytes=budget, stats=js)
    tt = tpl.tenant_timeline(_specs(_Port, tenants, reserves),
                             tpl.V100_PCIE, budget_bytes=budget, stats=ts)
    assert _view(tt) == _view(jt)
    assert ts == js
    assert tt.makespan > 0


def test_interleaved_makespan_beats_serial():
    """The modelled shared-device makespan of the interleaved run beats
    the tenants run one after the other (``tests/test_tenancy.py``'s
    claim, on the port's one profile)."""
    specs = [
        tten.TenantSpec("A", _cfg(), "depth2", sweeps=4, priority=10),
        tten.TenantSpec("B", _cfg(), "temporal2", sweeps=4),
    ]
    ws = sum(tten.working_set_bytes(s.cfg, s.schedule) for s in specs)
    hw = tpl.V100_PCIE
    interleaved = tpl.tenant_timeline(specs, hw, budget_bytes=ws).makespan
    serial = sum(
        tpl.sweep_timeline(s.cfg, hw, sweeps=s.sweeps, schedule=s.schedule,
                           cache_bytes=ws).makespan
        for s in specs
    )
    assert interleaved < serial


# ----------------------------------------------------------------------
# the live scheduler
# ----------------------------------------------------------------------
@pytest.mark.parametrize("budget_kind", ["working", "tight"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_matrix_equals_reference(scenario, budget_kind):
    """The headline matrix: each tenant's transfer log and ``stats()``
    exactly the reference's, its fields within ``GATHER_RTOL`` of the
    reference's and bit for bit the port's solo engine, its transfers
    those of the merged graph."""
    tenants = SCENARIOS[scenario]
    sched, budget = _submit_all(_Port, tenants, budget_kind)
    jsched, jbudget = _submit_all(_Ref, tenants, budget_kind)
    assert budget == jbudget
    sched.run()
    jsched.run()
    tasks = ttg.build_tenant_tasks(sched.specs(), budget_bytes=budget)
    for i, (name, schedule, sweeps, _) in enumerate(tenants):
        assert _records(sched.transfers(name)) == _records(
            jsched.transfers(name)), name
        assert _live_log(sched.transfers(name)) == _graph_log(tasks, name)
        solo = _solo(i, schedule, sweeps)
        for field in ("p_cur", "p_prev", "vel2"):
            got = sched.gather(name, field)
            np.testing.assert_array_equal(got, solo.gather(field))
            want = jsched.gather(name, field)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=GATHER_RTOL[CODE] * np.abs(want).max())
        solo.close()
    # the gathers flushed on both sides alike
    assert sched.stats() == jsched.stats()
    for name, _, _, _ in tenants:
        assert _records(sched.transfers(name)) == _records(
            jsched.transfers(name)), name
    sched.close()


def test_tight_budget_routes_flushes_to_the_victim():
    """The tight three-tenant run contends: flushes are routed between
    the batch tenants B and C in both directions, each logged by the
    victim as a flush at block -1, the per-tenant counters those of the
    merged graph, and every tenant's staging pool is whole after the
    run."""
    sched, budget = _submit_all(_Port, THREE, "tight")
    routed = _routed(sched)
    sched.run()
    assert routed.get(("B", "C"), 0) > 0 and routed.get(("C", "B"), 0) > 0
    graph = {}
    tasks = ttg.build_tenant_tasks(sched.specs(), budget_bytes=budget,
                                   stats=graph)
    modelled = {}
    for t in tasks:
        emitter = t.tid.split("/")[0]
        if t.flush and emitter != t.tenant:
            modelled[(emitter, t.tenant)] = modelled.get(
                (emitter, t.tenant), 0) + 1
    assert routed == modelled
    per = sched.stats()["per_tenant"]
    for name, _, _, _ in THREE:
        n = sum(c for (_, v), c in routed.items() if v == name)
        logged = [t for t in sched.transfers(name)
                  if t.flush and t.block == -1]
        assert len(logged) == n
        lanes = sched.tenants[name].executor.lanes
        assert lanes.free_slots == len(lanes._slots)
        for key in ("hits", "misses", "evictions", "flushes", "d2h_elided",
                    "flush_wire_bytes", "peak_bytes"):
            assert per[name][key] == graph["per_tenant"][name][key], key
    sched.close()


def test_priority_eviction_spares_latency_tenant():
    """A latency tenant holding its whole working set as reserve is
    never evicted while the batch tenant has bytes to steal."""
    cfg = _cfg()
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(ws + ws // 2)
    sched.submit("latency", cfg, *_initial(0), schedule="depth2",
                 sweeps=4, reserve=ws, priority=10)
    sched.submit("batch", cfg, *_initial(1), schedule="depth2",
                 sweeps=4, reserve=0, priority=0)
    sched.run()
    per = sched.stats()["per_tenant"]
    assert per["latency"]["evictions"] == 0
    assert per["batch"]["evictions"] > 0
    assert per["latency"]["peak_bytes"] == ws
    for i, name in enumerate(("latency", "batch")):
        solo = _solo(i, "depth2", 4)
        np.testing.assert_array_equal(sched.gather(name, "p_cur"),
                                      solo.gather("p_cur"))
    sched.close()


def test_admission_reject_over_reserve():
    cfg = _cfg()
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(ws)
    assert sched.submit("A", cfg, *_initial(0), sweeps=1,
                        reserve=ws) == "admitted"
    with pytest.raises(AdmissionError, match="unreserved"):
        sched.submit("B", cfg, *_initial(1), sweeps=1, reserve=ws)
    with pytest.raises(AdmissionError, match="does not fit"):
        sched.submit("C", cfg, *_initial(2), sweeps=1, reserve=16,
                     require_fit=True)
    assert list(sched.tenants) == ["A"]
    sched.run()
    with pytest.raises(ValueError, match="admission"):
        TenantScheduler(ws, admission="later")
    sched.close()


def test_admission_queue_runs_after_retire():
    """A queued tenant is admitted when the first wave retires and still
    finishes bit for bit its solo run; retiring drops the footprint and
    returns the reserve."""
    cfg = _cfg()
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(ws, admission="queue")
    assert sched.submit("A", cfg, *_initial(0), schedule="depth2",
                        sweeps=2, reserve=ws) == "admitted"
    assert sched.submit("B", cfg, *_initial(1), schedule="depth2",
                        sweeps=2, reserve=ws) == "queued"
    sched.run()
    for i, name in enumerate(("A", "B")):
        solo = _solo(i, "depth2", 2)
        for field in ("p_cur", "p_prev"):
            np.testing.assert_array_equal(sched.gather(name, field),
                                          solo.gather(field))
    st = sched.stats()
    assert st["per_tenant"]["A"]["retired"]
    assert not st["per_tenant"]["B"]["retired"]
    assert st["reserved_bytes"] == ws
    # a queue that can never drain raises
    never = TenantScheduler(ws, admission="queue")
    never.submit("A", cfg, *_initial(0), sweeps=1, reserve=ws)
    never.submit("B", cfg, *_initial(1), sweeps=1, reserve=2 * ws)
    with pytest.raises(AdmissionError, match="never"):
        never.run()
    sched.close()
    never.close()


def test_duplicate_tenant_rejected():
    cfg = _cfg()
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(ws, admission="queue")
    sched.submit("A", cfg, *_initial(0), sweeps=1)
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit("A", cfg, *_initial(1), sweeps=1)
    sched.submit("B", cfg, *_initial(1), sweeps=1)  # queued
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit("B", cfg, *_initial(2), sweeps=1)
    sched.close()


def test_per_tenant_checkpoint_cut(tmp_path):
    """A mid-run cut of one tenant freezes only its versions: restored
    as a solo run it finishes bit for bit, with the view's budget and
    policy, and the other tenant, which kept running through the cut,
    stays bit for bit its solo run."""
    cfg = _cfg()
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(2 * ws)
    sched.submit("A", cfg, *_initial(0), schedule="depth2", sweeps=2,
                 reserve=ws)
    sched.submit("B", cfg, *_initial(1), schedule="depth2", sweeps=4,
                 reserve=ws)
    cut_path = None
    for name, start, kr in tten.interleave_rounds(sched.specs()):
        if name == "A" and start == 1:
            cut_path = sched.checkpoint_tenant("A", str(tmp_path),
                                               zstd_level=0)
        sched.tenants[name].executor.advance_round(start + kr)
    assert cut_path is not None
    sched.run()
    restored = AsyncExecutor.restore(cut_path, device="cpu")
    assert restored.cache.budget_bytes == 2 * ws
    assert restored.cache.policy == "write-back"
    assert restored.cache.arbiter is None
    restored.run(1)
    solo = _solo(0, "depth2", 2)
    np.testing.assert_array_equal(restored.gather("p_cur"),
                                  solo.gather("p_cur"))
    soloB = _solo(1, "depth2", 4)
    np.testing.assert_array_equal(sched.gather("B", "p_cur"),
                                  soloB.gather("p_cur"))
    sched.close()


def test_quota_accounting_coheres():
    """After a contended run the tenants' byte gauges sum to the
    manager's, nothing exceeds the budget, and retiring every tenant
    flushes it to its own store and zeroes its footprint."""
    sched, budget = _submit_all(_Port, THREE, "tight")
    sched.run()
    mgr = sched.manager
    assert sum(mgr.tenant_bytes.values()) == mgr.bytes_used <= budget
    st = sched.stats()
    assert st["reserved_bytes"] <= budget
    assert all(ts["peak_bytes"] <= budget
               for ts in st["per_tenant"].values())
    for name in list(sched.tenants):
        sched.retire(name)
    st = sched.stats()
    assert st["reserved_bytes"] == 0 and mgr.bytes_used == 0
    for name, ts in st["per_tenant"].items():
        assert ts["dirty_bytes"] == 0 and ts["bytes_used"] == 0, name
    for i, (name, schedule, sweeps, _) in enumerate(THREE):
        solo = _solo(i, schedule, sweeps)
        np.testing.assert_array_equal(sched.gather(name, "p_prev"),
                                      solo.gather("p_prev"))
    sched.close()


def test_tenant_view_splits_and_rolls_back_alone():
    """``TenantView``: a foreign flush handback goes through the router
    (and raises without one), its own comes back un-namespaced; its
    ``rollback_reset`` drops only its tenant and resets its gauges as a
    private manager's; it refuses a manager with no arbiter."""
    arb = ResidencyArbiter()
    arb.grant("a", 0, 0)
    arb.grant("b", 0, 5)
    mgr = DeviceResidencyManager(100, arbiter=arb)
    routed = []
    va = tten.TenantView(mgr, "a", router=lambda *r: routed.append(r))
    vb = tten.TenantView(mgr, "b")
    assert vb.deposit("k", 1, "b1", 60, dirty=True).stored
    assert vb.peek("k").value == "b1" and vb.bytes_used == 60
    # a's deposit evicts b's dirty entry: routed to b
    res = va.deposit("k", 1, "a1", 70, dirty=True, rate="p12")
    assert res.stored and res.flushes == []
    assert [(t, k, e.value) for t, k, e in routed] == [("b", "k", "b1")]
    # a's own eviction comes back un-namespaced
    res = va.deposit("m", 1, "a2", 40, dirty=True)
    assert [(k, e.value) for k, e in res.flushes] == [("k", "a1")]
    # b's deposit evicts a's dirty entry, and b has no router: it raises
    with pytest.raises(RuntimeError, match="no router"):
        vb.deposit("j", 1, "b2", 70, dirty=True)
    assert va.deposit("p", 1, "a3", 20, dirty=True).stored
    assert va.dirty_entries() == [("p", mgr.peek(("a", "p")))]
    assert va.pin("p") is not None and va.pinned_keys() == ["p"]
    assert va.bytes_used == 20 and vb.bytes_used == 70
    va.stats.rate_bytes = {"p12": 20}
    assert va.rollback_reset() is va
    assert va.bytes_used == 0 and va.dirty_bytes == 0
    assert va.stats.pinned_bytes == 0 and va.stats.rate_bytes == {}
    assert vb.peek("j").value == "b2" and vb.bytes_used == 70
    assert vb.dirty_bytes == 70 and mgr.bytes_used == 70
    with pytest.raises(ValueError, match="arbiter"):
        tten.TenantView(DeviceResidencyManager(100), "a")


def test_scheduler_device_fills_configs_that_name_none():
    """``TenantScheduler(device="cpu")`` runs a config that names no
    device on the CPU with the plain versions; a config's own device
    stays."""
    cfg = tooc.OOCConfig(SHAPE, 2, 1, tooc.paper_code_fields(CODE))
    ws = tten.working_set_bytes(cfg, "depth2")
    sched = TenantScheduler(2 * ws, device="cpu")
    sched.submit("A", cfg, *_initial(0), sweeps=2)
    ex = sched.tenants["A"].executor
    assert ex.device.type == "cpu" and ex.cfg.backend == "ref"
    sched.run()
    np.testing.assert_array_equal(sched.gather("A", "p_cur"),
                                  _solo(0, "depth2", 2).gather("p_cur"))
    sched.close()


def test_serve_ooc_on_cpu_equals_reference(monkeypatch, capsys):
    """``serve.main(["--ooc", "--device", "cpu"])`` at the reference
    launcher's defaults (2 tenants, (32, 8, 8), 4 sweeps, budget 1.5 ×
    the largest working set): the scheduler it returns has the per-tenant
    stats of the reference's ``run_ooc`` and its transfers, each tenant
    bit for bit a solo run of its schedule from the same seed stream."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    eng = serve.main(["--ooc", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 tenants" in out and "(cpu)" in out
    made = []

    class Recording(jooc_serving.TenantScheduler):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jooc_serving, "TenantScheduler", Recording)
    jserve.run_ooc(argparse.Namespace(
        tenants=2, sweeps=4, blocks=2, budget_mult=1.5, shape=[32, 8, 8],
        seed=0))
    (jeng,) = made
    assert eng.stats() == jeng.stats()
    assert [s.schedule for s in eng.specs()] == ["depth2", "temporal2"]
    rng = np.random.default_rng(0)
    for name, spec in zip(("t0", "t1"), eng.specs()):
        assert _records(eng.transfers(name)) == _records(
            jeng.transfers(name))
        fields = [rng.standard_normal(SHAPE).astype(np.float32),
                  rng.standard_normal(SHAPE).astype(np.float32),
                  (1.0 + 0.1 * rng.standard_normal(SHAPE)).astype(
                      np.float32)]
        solo = AsyncExecutor(spec.cfg, *fields, schedule=spec.schedule)
        solo.run(4)
        np.testing.assert_array_equal(eng.gather(name, "p_cur"),
                                      solo.gather("p_cur"))
        solo.close()
    eng.close()

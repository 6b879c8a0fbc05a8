"""The port's timeline model (``repro_torch.core.pipeline``) against the
JAX package's: pure Python over the same task graphs, so equal exactly.

On ``V100_PCIE`` (and on the reference's TPU profile, rebuilt as the
port's ``Hardware`` from its fields here): the makespan, every span,
busy time by kind and by stream, the bounding ones, ``transfer_wire``,
and under a ``FaultPlan`` with a ``RetryPolicy`` or a ``ReissuePolicy``
``attempt_multiset``, the attempt spans, reissued and failed tasks; for
the sweep replay (schedules, residency budgets, checkpoint modes, rate
control, stragglers) and the sharded replay (2-4 shards, halos
included) at the reference's test sizes. The paper's Fig. 5/6 structure
holds on the port's model as on the reference's. The multi-tenant
replay (two tenants, every budget) equals the reference's too.
"""

import dataclasses

import pytest

from repro.core import outofcore as jooc
from repro.core import pipeline as jpl
from repro.core import ratecontrol as jrc
from repro.distributed import fault as jfault
from repro_torch.core import outofcore as tooc
from repro_torch.core import pipeline as tpl
from repro_torch.core import ratecontrol as trc
from repro_torch.distributed import fault as tfault

SHAPE = (96, 12, 10)
SCHEDULES = [("paper", 2), ("unitgrain", 2), ("depth2", 2),
             ("temporal2", 1)]
BUDGETS = [0, 60_000, 1 << 30]


def _cfgs(code, bt, shape=SHAPE, ndiv=4):
    return (jooc.OOCConfig(shape, ndiv, bt, jooc.paper_code_fields(code)),
            tooc.OOCConfig(shape, ndiv, bt, tooc.paper_code_fields(code),
                           backend="ref", device="cpu"))


def _port_hw(hw):
    return tpl.Hardware(**dataclasses.asdict(hw))


def _view(tl):
    return {
        "makespan": tl.makespan,
        "spans": {k: (v.start, v.end) for k, v in tl.spans.items()},
        "busy": tl.busy(),
        "busy_by_resource": tl.busy_by_resource(),
        "bounding": (tl.bounding_operation(), tl.bounding_resource())
        if tl.spans else None,
        "wire": tl.transfer_wire(),
        "attempts": tl.attempt_multiset(),
        "attempt_spans": {k: [(r, s.start, s.end) for r, s in v]
                          for k, v in tl.attempts.items()},
        "reissued": tl.reissued, "failed": tl.failed,
        "wire_attempts": tl.wire_attempts,
    }


def test_v100_profile_equals_reference():
    assert dataclasses.asdict(tpl.V100_PCIE) == dataclasses.asdict(
        jpl.V100_PCIE)
    assert not hasattr(tpl, "TPU_V5E_HOST")


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("schedule,bt", SCHEDULES)
@pytest.mark.parametrize("code", [1, 2, 4])
def test_sweep_timeline_equals_reference(code, schedule, bt, budget):
    jcfg, tcfg = _cfgs(code, bt)
    js, ts = {}, {}
    jt = jpl.sweep_timeline(jcfg, jpl.V100_PCIE, sweeps=3,
                            schedule=schedule, cache_bytes=budget, stats=js)
    tt = tpl.sweep_timeline(tcfg, tpl.V100_PCIE, sweeps=3,
                            schedule=schedule, cache_bytes=budget, stats=ts)
    assert _view(tt) == _view(jt)
    assert ts == js
    assert tt.makespan > 0


@pytest.mark.parametrize("policy", ["write-back", "write-through"])
@pytest.mark.parametrize("mode", ["overlapped", "quiesced"])
def test_checkpoint_modes_equal_reference(mode, policy):
    jcfg, tcfg = _cfgs(2, 2)
    kw = dict(sweeps=4, schedule="depth2", cache_bytes=60_000,
              policy=policy, ckpt_every=2, ckpt_mode=mode)
    jt = jpl.sweep_timeline(jcfg, jpl.V100_PCIE, **kw)
    tt = tpl.sweep_timeline(tcfg, tpl.V100_PCIE, **kw)
    assert _view(tt) == _view(jt)
    # only the overlapped cut of dirty residents has snapshot D2Hs
    assert bool(tt.transfer_wire()["d2h_ckpt_wire"]) == (
        mode == "overlapped" and policy == "write-back")


@pytest.mark.parametrize("policy", ["retry", "reissue"])
@pytest.mark.parametrize("seed", [1, 7])
def test_faults_equal_reference(seed, policy):
    """A seeded plan of transfer failures, corruptions and stragglers:
    the same attempts, spans and casualties in both models, for the
    sweep and the sharded replays."""
    def plan(mod):
        return mod.FaultPlan(seed=seed, p_transfer=0.05, p_corrupt=0.05,
                             p_straggle=0.05)

    def pol(mod):
        return (mod.RetryPolicy(attempts=3, backoff_s=1e-4)
                if policy == "retry" else mod.ReissuePolicy(factor=3.0))

    jcfg, tcfg = _cfgs(4, 2)
    for kw in (dict(sweeps=3, schedule="depth2", cache_bytes=60_000),
               dict(sweeps=3, schedule="unitgrain")):
        jt = jpl.sweep_timeline(jcfg, jpl.V100_PCIE, retry=pol(jfault),
                                faults=plan(jfault), **kw)
        tt = tpl.sweep_timeline(tcfg, tpl.V100_PCIE, retry=pol(tfault),
                                faults=plan(tfault), **kw)
        assert _view(tt) == _view(jt)
    jt = jpl.sharded_timeline(jcfg, jpl.V100_PCIE, 2, sweeps=3,
                              retry=pol(jfault), faults=plan(jfault))
    tt = tpl.sharded_timeline(tcfg, tpl.V100_PCIE, 2, sweeps=3,
                              retry=pol(tfault), faults=plan(tfault))
    assert _view(tt) == _view(jt)
    assert any(n > 1 for *_, n in tt.attempt_multiset())
    assert any(k[0] == "halo" for k in tt.attempt_multiset())


def test_reissue_and_stragglers_equal_reference():
    jcfg, tcfg = _cfgs(1, 2, shape=(96, 12, 12))
    js, ts = {}, {}
    kw = dict(sweeps=3, schedule="depth2", cache_bytes=100_000)
    jtasks = jpl.build_sweep_tasks(jcfg, stats=js, **kw)
    ttasks = tpl.build_sweep_tasks(tcfg, stats=ts, **kw)
    flush = next(t.tid for t in ttasks if t.flush)
    slow = {flush: 50.0, "s1b2.h2d": 4.0}
    jt = jpl.simulate(jtasks, jpl.V100_PCIE, straggler=slow,
                      reissue=jfault.ReissuePolicy(factor=3.0))
    tt = tpl.simulate(ttasks, tpl.V100_PCIE, straggler=slow,
                      reissue=tfault.ReissuePolicy(factor=3.0))
    assert _view(tt) == _view(jt)
    assert flush in tt.reissued and "spare" in tt.busy_by_resource()


@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("schedule,bt", SCHEDULES[1:])
@pytest.mark.parametrize("nshards", [2, 3, 4])
def test_sharded_timeline_equals_reference(nshards, schedule, bt, budget):
    jcfg, tcfg = _cfgs(4, bt)
    js, ts = {}, {}
    jt = jpl.sharded_timeline(jcfg, jpl.V100_PCIE, nshards, sweeps=3,
                              schedule=schedule, cache_bytes=budget,
                              stats=js)
    tt = tpl.sharded_timeline(tcfg, tpl.V100_PCIE, nshards, sweeps=3,
                              schedule=schedule, cache_bytes=budget,
                              stats=ts)
    assert _view(tt) == _view(jt)
    assert ts == js
    res = tt.busy_by_resource()
    assert tt.transfer_wire()["halo_wire"] > 0
    assert {r.split(":")[0] for r in res} == {f"s{d}"
                                              for d in range(nshards)}


def test_other_profile_and_rates_equal_reference():
    """The reference's TPU profile, rebuilt from its fields as the port's
    ``Hardware``, and an adaptive rate controller's replay."""
    jcfg, tcfg = _cfgs(4, 2)
    jhw, thw = jpl.TPU_V5E_HOST, _port_hw(jpl.TPU_V5E_HOST)
    ctrls = (jrc.RateController(jcfg, mode="adaptive", error_budget=1e-2),
             trc.RateController(tcfg, mode="adaptive", error_budget=1e-2))
    for name in ("p_prev", "vel2"):
        for c in ctrls:
            c.observe(name, "R", 1, 12, 1e-5, 1.0)
            c.observe(name, "C", 0, 12, 5e-2, 1.0)
    for c in ctrls:
        c.decide(1)
    for jr, tr in ((None, None), ctrls):
        jt = jpl.sweep_timeline(jcfg, jhw, sweeps=3, schedule="depth2",
                                rates=jr)
        tt = tpl.sweep_timeline(tcfg, thw, sweeps=3, schedule="depth2",
                                rates=tr)
        assert _view(tt) == _view(jt)


def _paper(code):
    return tooc.OOCConfig((1152, 1152, 1152), 8, 12,
                          tooc.paper_code_fields(code, f32=False),
                          backend="ref", device="cpu", dtype="float64")


def test_paper_fig5_fig6_structure():
    """The reference's checks of its model, on the port's: the paper's
    speedups 1.16×, 1.18×, 1.20× within 5%, codes 1-3 bound by h2d and
    code 4 by compute, on the modelled V100."""
    base = tpl.sweep_timeline(_paper(1), tpl.V100_PCIE, sweeps=4).makespan
    for code, want in ((2, 1.16), (3, 1.18), (4, 1.20)):
        t = tpl.sweep_timeline(_paper(code), tpl.V100_PCIE, sweeps=4)
        assert base / t.makespan == pytest.approx(want, rel=0.05)
    for code in (1, 2, 3):
        tl = tpl.sweep_timeline(_paper(code), tpl.V100_PCIE, sweeps=1)
        assert tl.bounding_resource() == "h2d", code
    assert tpl.sweep_timeline(_paper(4), tpl.V100_PCIE,
                              sweeps=1).bounding_resource() == "compute"


def test_tenant_timeline_raises_naming_its_item():
    """The multi-tenant replay of two tenants on ``V100_PCIE`` equals the
    reference's: the makespan, every span, busy time and the per-tenant
    stats, at every budget."""
    from repro.core import tenancy as jten
    from repro_torch.core import tenancy as tten

    jcfg, tcfg = _cfgs(4, 1)
    jspecs = [jten.TenantSpec("A", jcfg, "depth2", 3, 0, 10),
              jten.TenantSpec("B", jcfg, "temporal2", 2)]
    tspecs = [tten.TenantSpec("A", tcfg, "depth2", 3, 0, 10),
              tten.TenantSpec("B", tcfg, "temporal2", 2)]
    for budget in BUDGETS:
        js, ts = {}, {}
        jt = jpl.tenant_timeline(jspecs, jpl.V100_PCIE, budget_bytes=budget,
                                 stats=js)
        tt = tpl.tenant_timeline(tspecs, tpl.V100_PCIE, budget_bytes=budget,
                                 stats=ts)
        assert _view(tt) == _view(jt)
        assert ts == js and set(ts["per_tenant"]) == {"A", "B"}

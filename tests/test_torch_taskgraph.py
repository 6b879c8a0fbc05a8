"""The port's task graph (``repro_torch.core.taskgraph``) against the
JAX package's, exactly: it is pure Python, so no tolerance applies.

Over codes 1, 2 and 4 at ndiv 3 and 4 × the schedules ``paper``,
``unitgrain``, ``depth2``, ``depth3`` and ``temporal-2`` × residency
budgets (0, one that evicts, one that holds everything) × both write
policies, with and without a ``RateController`` (fixed, and adaptive
after the same observations): every task (tid, resource, kind, amount,
deps, block, versions, flags), the residency counters of ``stats`` and
``wire_totals`` are equal. Also the checkpoint-aware graphs
(``ckpt_every``, both cut modes), schedule parsing and the wire-byte
helpers; the sharded graphs at the reference's own test size ((96, 12,
10), ndiv 4): each shard's graph (``build_sweep_tasks(shard=)``, with
``resource_prefix``) and the merged one (``build_sharded_tasks``) over
schedules unitgrain, depth2 and temporal2 × budgets 0 and 1 << 30, task
for task with their residency counters; and the multi-tenant graph,
which raises naming its ROADMAP item.
"""

import dataclasses

import pytest

from repro.core import outofcore as jooc
from repro.core import ratecontrol as jrc
from repro.core import taskgraph as jtg
from repro.distributed import sharding as jsh
from repro_torch.core import outofcore as tooc
from repro_torch.core import ratecontrol as trc
from repro_torch.core import taskgraph as ttg
from repro_torch.distributed import sharding as tsh

SHAPE = (96, 12, 12)
CONFIGS = [(1, 4), (2, 4), (4, 3)]  # (code, ndiv)
SCHEDULES = ["paper", "unitgrain", "depth2", "depth3", "temporal-2"]
BUDGETS = {"off": 0, "evicting": 60_000, "all": 1 << 30}
POLICIES = ["write-back", "write-through"]
SWEEPS = 3


def _cfgs(code, ndiv, bt):
    return (jooc.OOCConfig(SHAPE, ndiv, bt, jooc.paper_code_fields(code)),
            tooc.OOCConfig(SHAPE, ndiv, bt, tooc.paper_code_fields(code),
                           backend="ref", device="cpu"))


def _observed(jcfg, tcfg, seed=0):
    """An adaptive controller in each package, fed the same observations
    over two sweep boundaries."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ctrls = (jrc.RateController(jcfg, mode="adaptive", error_budget=1e-2),
             trc.RateController(tcfg, mode="adaptive", error_budget=1e-2))
    plan = tcfg.temporal_plan(1)
    for sweep in (1, 2):
        for name, spec in tcfg.fields.items():
            if not spec.compressed or spec.role != "rw":
                continue
            for kind, idx, _ in plan.units():
                planes = [None, 8, 12, 16][int(rng.integers(4))]
                scale = float(rng.uniform(0.01, 2.0))
                err = 0.0 if planes is None else float(
                    scale * rng.uniform(1e-6, 1e-3))
                for c in ctrls:
                    c.observe(name, kind, idx, planes, err, scale)
        for c in ctrls:
            c.decide(sweep)
    return ctrls


def _rows(tasks):
    return [dataclasses.astuple(t) for t in tasks]


def _both(jcfg, tcfg, rates=(None, None), **kw):
    js, ts = {}, {}
    jt = jtg.build_sweep_tasks(jcfg, stats=js, rates=rates[0], **kw)
    tt = ttg.build_sweep_tasks(tcfg, stats=ts, rates=rates[1], **kw)
    return jt, tt, js, ts


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("code,ndiv", CONFIGS)
def test_sweep_tasks_equal_reference(code, ndiv, schedule, budget, policy):
    bt = 1 if schedule.startswith("temporal") else 2
    jcfg, tcfg = _cfgs(code, ndiv, bt)
    rates = [(None, None),
             (jrc.RateController(jcfg), trc.RateController(tcfg))]
    if code != 1:
        rates.append(_observed(jcfg, tcfg))
    for pair in rates:
        jt, tt, js, ts = _both(jcfg, tcfg, pair, sweeps=SWEEPS,
                               schedule=schedule,
                               cache_bytes=BUDGETS[budget], policy=policy)
        assert _rows(tt) == _rows(jt)
        assert ts == js
        assert ttg.wire_totals(tt) == jtg.wire_totals(jt)
        if pair[0] is not None and pair[0].mode == "adaptive":
            # the decision log really changed what crossed the wire
            fixed = ttg.build_sweep_tasks(tcfg, sweeps=SWEEPS,
                                          schedule=schedule,
                                          cache_bytes=BUDGETS[budget],
                                          policy=policy)
            assert _rows(tt) != _rows(fixed)


@pytest.mark.parametrize("mode", ["overlapped", "quiesced"])
@pytest.mark.parametrize("budget", ["evicting", "all"])
def test_checkpoint_aware_graph_equal_reference(mode, budget):
    jcfg, tcfg = _cfgs(2, 4, 2)
    jt, tt, js, ts = _both(jcfg, tcfg, sweeps=4, schedule="depth2",
                           cache_bytes=BUDGETS[budget], ckpt_every=2,
                           ckpt_mode=mode)
    assert _rows(tt) == _rows(jt)
    assert ts == js
    assert any(t.ckpt or t.flush for t in tt)
    with pytest.raises(ValueError, match="ckpt_mode"):
        ttg.build_sweep_tasks(tcfg, ckpt_mode="bogus")


def test_fetch_after_writeback_hazard_versions():
    """Every fetch of a read-write unit after sweep 0 reads the version
    the previous sweep committed and depends on that d2h task."""
    _, cfg = _cfgs(2, 4, 2)
    tasks = ttg.build_sweep_tasks(cfg, sweeps=3, schedule="unitgrain")
    byid = {t.tid: t for t in tasks}
    for t in tasks:
        if t.kind != "h2d" or t.sweep == 0:
            continue
        if cfg.fields[t.field].role == "rw":
            assert t.version == t.sweep
            wb = [byid[d] for d in t.deps if byid[d].kind == "d2h"
                  and (byid[d].field, byid[d].unit) == (t.field, t.unit)]
            assert len(wb) == 1 and wb[0].sweep == t.sweep - 1
            assert wb[0].version == t.version
        else:
            assert t.version == 0


@pytest.mark.parametrize("name,window,temporal,sync", [
    ("paper", None, 1, True), ("unitgrain", None, 1, False),
    ("overlap", None, 1, False), ("depth3", 3, 1, False),
    ("depth-2", 2, 1, False), ("temporal4", None, 4, False),
    ("temporal-2", None, 2, False),
])
def test_get_schedule_parsing(name, window, temporal, sync):
    s = ttg.get_schedule(name)
    assert (s.window, s.temporal, s.codec_sync) == (window, temporal, sync)
    assert dataclasses.astuple(s) == dataclasses.astuple(
        jtg.get_schedule(name))
    assert ttg.get_schedule(s) is s


@pytest.mark.parametrize("bad", ["bogus", "depth0", "temporal0", "depth-"])
def test_get_schedule_rejects(bad):
    with pytest.raises(ValueError):
        ttg.get_schedule(bad)


@pytest.mark.parametrize("planes", [None, 1, 8, 12, 16, 27, 32])
@pytest.mark.parametrize("shape", [(96, 12, 12), (48, 13, 7), (8, 4, 4)])
def test_wire_byte_helpers_equal_reference(planes, shape):
    assert (ttg.rate_wire_bytes(planes, shape, 4)
            == jtg.rate_wire_bytes(planes, shape, 4))
    spec_t = tooc.FieldSpec("rw", planes)
    spec_j = jooc.FieldSpec("rw", planes)
    assert (ttg.unit_wire_bytes(spec_t, shape, 4)
            == jtg.unit_wire_bytes(spec_j, shape, 4))
    assert ttg.wire_ratio(spec_t, 4) == jtg.wire_ratio(spec_j, 4)


SHARD_SHAPE = (96, 12, 10)  # tests/test_sharded.py's size, ndiv 4
SHARD_SCHEDULES = [("unitgrain", 2), ("depth2", 2), ("temporal2", 1)]


def _shard_cfgs(code, bt):
    return (jooc.OOCConfig(SHARD_SHAPE, 4, bt, jooc.paper_code_fields(code)),
            tooc.OOCConfig(SHARD_SHAPE, 4, bt, tooc.paper_code_fields(code),
                           backend="ref", device="cpu"))


@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("schedule,bt", SHARD_SCHEDULES)
@pytest.mark.parametrize("code", [1, 4])
@pytest.mark.parametrize("nshards", [2, 3, 4])
def test_shard_graphs_equal_reference(nshards, code, schedule, bt, budget):
    jcfg, tcfg = _shard_cfgs(code, bt)
    for jspec, tspec in zip(jsh.partition_domain(4, nshards),
                            tsh.partition_domain(4, nshards)):
        prefix = f"s{tspec.index}:"
        js, ts = {}, {}
        jt = jtg.build_sweep_tasks(jcfg, SWEEPS, schedule, budget, js,
                                   shard=jspec, resource_prefix=prefix)
        tt = ttg.build_sweep_tasks(tcfg, SWEEPS, schedule, budget, ts,
                                   shard=tspec, resource_prefix=prefix)
        assert _rows(tt) == _rows(jt)
        assert ts == js
        assert all(t.resource.startswith(prefix) for t in tt)
        assert {t.block for t in tt} == set(tspec.blocks)
        halos = [t for t in tt if t.kind == "halo"]
        assert bool(halos) == (nshards > 1)
    jstats, tstats = {}, {}
    jm = jtg.build_sharded_tasks(jcfg, nshards, sweeps=SWEEPS,
                                 schedule=schedule, cache_bytes=budget,
                                 stats=jstats)
    tm = ttg.build_sharded_tasks(tcfg, nshards, sweeps=SWEEPS,
                                 schedule=schedule, cache_bytes=budget,
                                 stats=tstats)
    assert _rows(tm) == _rows(jm)
    assert tstats == jstats and set(tstats["per_device"]) == set(
        range(nshards))


def test_sharded_graph_hazard_edges():
    """The merged graph's cross-shard edges: each held export gates the
    right neighbour's boundary commit in the same round, and each unit
    halo gates the left neighbour's ghost refetch in the next."""
    _, cfg = _shard_cfgs(4, 2)
    tasks = ttg.build_sharded_tasks(cfg, 2, sweeps=3, schedule="depth2")
    byid = {t.tid: t for t in tasks}
    for s in range(3):
        for name in ("p_prev", "p_cur"):
            held = f"s{s}b1.held.{name}.C1"
            assert held in byid
            gated = [t for t in tasks if held in t.deps]
            assert gated and all(t.block == 2 and t.sweep == s
                                 for t in gated)
            halo = f"s{s}b2.halo.{name}.C1"
            assert byid[halo].resource == "s1:halo"
            refetch = byid.get(f"s{s + 1}b1.h2d.{name}.C1")
            assert (refetch is not None and halo in refetch.deps) == (s < 2)


def test_unported_graphs_raise_naming_their_items():
    _, cfg = _cfgs(2, 4, 2)
    # the multi-tenant graph: empty for no tenants, one tenant's graph
    # its own sweep graph with every task labelled with its name
    from repro_torch.core.tenancy import TenantSpec

    assert ttg.build_tenant_tasks([]) == []
    one = ttg.build_tenant_tasks([TenantSpec("t", cfg, "depth2", 2)])
    assert {t.tenant for t in one} == {"t"}
    assert [(t.kind, t.field, t.unit, t.sweep) for t in one] == [
        (t.kind, t.field, t.unit, t.sweep)
        for t in ttg.build_sweep_tasks(cfg, 2, "depth2")]
    with pytest.raises(ValueError, match="nshards"):
        ttg.build_sharded_tasks(cfg, 5)
    # a shard restricts the graph to its blocks, and ndiv 1 has no halo
    spec = tsh.partition_domain(4, 2)[1]
    assert {t.block for t in ttg.build_sweep_tasks(cfg, shard=spec)} == {
        2, 3}
    assert not [t for t in ttg.build_sharded_tasks(cfg, 1)
                if t.kind == "halo"]

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
helpers, and the sharded and multi-tenant graphs, which raise naming
their ROADMAP items.
"""

import dataclasses

import pytest

from repro.core import outofcore as jooc
from repro.core import ratecontrol as jrc
from repro.core import taskgraph as jtg
from repro_torch.core import outofcore as tooc
from repro_torch.core import ratecontrol as trc
from repro_torch.core import taskgraph as ttg

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


def test_unported_graphs_raise_naming_their_items():
    _, cfg = _cfgs(2, 4, 2)
    with pytest.raises(NotImplementedError, match="item 11"):
        ttg.build_sweep_tasks(cfg, shard=object())
    with pytest.raises(NotImplementedError, match="item 11"):
        ttg.build_sharded_tasks(cfg, 2)
    with pytest.raises(NotImplementedError, match="item 12"):
        ttg.build_tenant_tasks([])

"""Properties (hypothesis) of the port's multi-tenant residency, driven
through ``core.tenancy.TenantView``, each op sequence replayed in lockstep
on the JAX package's arbiter-managed manager (the properties of
``tests/test_tenancy_properties.py``):

* the tenants' byte gauges sum to ``bytes_used``, which never exceeds
  the budget, and every flush, entry, gauge and counter equals the
  reference's after the same ops;
* a tenant's deposit never pulls another tenant below its reserve;
* the order of the quota grants changes nothing;
* pinned entries are not stealable slack: a burst that could only fit
  by evicting them is refused and disturbs nothing;
* a per-tenant checkpoint cut at any global round boundary, taken while
  the other tenant keeps running, restores bit for bit as a solo run.
  The reference's own cut runs in the same test as the oracle, with
  keyword strategies (``tests/test_tenancy_properties.py`` passes its
  strategies by position, so pytest looks for a fixture ``cut_at`` and
  that test never runs its body).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.core.executor import AsyncExecutor as JExecutor  # noqa: E402
from repro.core.outofcore import OOCConfig as JConfig  # noqa: E402
from repro.core.outofcore import paper_code_fields as jfields  # noqa: E402
from repro.core.unitcache import DeviceResidencyManager as JManager  # noqa: E402,E501
from repro.core.unitcache import ResidencyArbiter as JArbiter  # noqa: E402
from repro.serving.ooc import TenantScheduler as JScheduler  # noqa: E402
from repro_torch.core.executor import AsyncExecutor  # noqa: E402
from repro_torch.core.outofcore import OOCConfig, \
    paper_code_fields  # noqa: E402
from repro_torch.core.tenancy import TenantView, interleave_rounds, \
    working_set_bytes  # noqa: E402
from repro_torch.core.unitcache import DeviceResidencyManager, \
    ResidencyArbiter  # noqa: E402
from repro_torch.serving.ooc import TenantScheduler  # noqa: E402
from test_torch_outofcore import GATHER_RTOL  # noqa: E402

OPS = settings(deadline=None, max_examples=60, derandomize=True)

BUDGET = 150
TENANTS = ["lat", "bat"]
QUOTAS = {"lat": (60, 10), "bat": (0, 0)}  # (reserve, priority)
KEYS = ["a", "b", "c"]

_op = st.one_of(
    st.tuples(
        st.just("deposit"),
        st.sampled_from(TENANTS),
        st.sampled_from(KEYS),
        st.integers(0, 3),  # version
        st.integers(1, 70),  # nbytes
        st.booleans(),  # dirty
    ),
    st.tuples(st.just("lookup"), st.sampled_from(TENANTS),
              st.sampled_from(KEYS), st.integers(0, 3)),
    st.tuples(st.just("pin"), st.sampled_from(TENANTS),
              st.sampled_from(KEYS)),
    st.tuples(st.just("release"), st.sampled_from(TENANTS),
              st.sampled_from(KEYS)),
    st.tuples(st.just("drop"), st.sampled_from(TENANTS)),
)


class _Views:
    """The port's shared manager with one ``TenantView`` a tenant; every
    flush handback, own or routed, lands in ``flushed`` as
    ``((tenant, key), version, nbytes)``."""

    def __init__(self, grant_order=TENANTS):
        arb = ResidencyArbiter()
        for t in grant_order:
            arb.grant(t, *QUOTAS[t])
        self.mgr = DeviceResidencyManager(BUDGET, arbiter=arb)
        self.flushed = []
        self.views = {
            t: TenantView(self.mgr, t, router=self._route) for t in TENANTS}

    def _route(self, tenant, key, ent):
        self.flushed.append(((tenant, key), ent.version, ent.nbytes))

    def _own(self, tenant, flushes):
        self.flushed += [((tenant, k), e.version, e.nbytes)
                         for k, e in flushes]

    def apply(self, op):
        kind, t = op[0], op[1]
        v = self.views[t]
        if kind == "deposit":
            _, _, k, ver, nbytes, dirty = op
            res = v.deposit(k, ver, f"{t}/{k}@{ver}", nbytes, dirty=dirty)
            self._own(t, res.flushes)
        elif kind == "lookup":
            v.lookup(op[2], op[3])
        elif kind == "pin":
            if (t, op[2]) not in self.mgr._shadows:
                v.pin(op[2])
        elif kind == "release":
            self._own(t, v.release(op[2]))
        else:  # a crash rollback of this tenant alone
            v.rollback_reset()


def _ref(grant_order=TENANTS):
    arb = JArbiter()
    for t in grant_order:
        arb.grant(t, *QUOTAS[t])
    return JManager(BUDGET, arbiter=arb)


def _ref_apply(mgr, op, flushed):
    """The reference's manager under the same op, its flushes listed as
    a view lists them: those routed to another tenant first, then the
    depositor's own."""
    kind, t = op[0], op[1]
    res = []
    if kind == "deposit":
        _, _, k, ver, nbytes, dirty = op
        res = mgr.deposit((t, k), ver, f"{t}/{k}@{ver}", nbytes,
                          dirty=dirty).flushes
    elif kind == "lookup":
        mgr.lookup((t, op[2]), op[3])
    elif kind == "pin":
        if (t, op[2]) not in mgr._shadows:
            mgr.pin((t, op[2]))
    elif kind == "release":
        res = mgr.release((t, op[2]))
    else:
        mgr.drop_tenant(t)
    rows = [(key, e.version, e.nbytes) for key, e in res]
    flushed += [r for r in rows if r[0][0] != t]
    flushed += [r for r in rows if r[0][0] == t]


def _state(mgr):
    return (
        [(k, dataclasses.astuple(e)) for k, e in mgr._entries.items()],
        {k: dataclasses.astuple(e) for k, e in mgr._shadows.items()},
        mgr.bytes_used, mgr.peak_bytes,
        {t: b for t, b in mgr.tenant_bytes.items()},
        dict(mgr.tenant_peak),
        mgr.stats.as_dict(),
        {t: mgr.tenant_stats_for(t).as_dict() for t in TENANTS},
    )


@OPS
@given(ops=st.lists(_op, max_size=40))
def test_quota_gauges_cohere_and_equal_reference(ops):
    """After every op: the gauges sum to ``bytes_used`` <= budget, none
    negative, peaks running maxima; after the sequence, every flush,
    entry, gauge and counter is the reference's."""
    port, ref, jflushed = _Views(), _ref(), []
    for op in ops:
        port.apply(op)
        _ref_apply(ref, op, jflushed)
        mgr = port.mgr
        assert sum(mgr.tenant_bytes.values()) == mgr.bytes_used
        assert 0 <= mgr.bytes_used <= BUDGET
        for t, b in mgr.tenant_bytes.items():
            assert 0 <= b <= mgr.tenant_peak.get(t, 0)
        for t, v in port.views.items():
            assert v.bytes_used == mgr.tenant_bytes.get(t, 0)
            assert v.dirty_bytes >= 0 and v.stats.pinned_bytes >= 0
    assert port.flushed == jflushed
    assert _state(port.mgr) == _state(ref)


@OPS
@given(ops=st.lists(_op, max_size=40))
def test_foreign_deposits_respect_reserves(ops):
    """No deposit by tenant X pulls tenant Y (!= X) below min(reserve_Y,
    what Y held before the op)."""
    port = _Views()
    for op in ops:
        before = dict(port.mgr.tenant_bytes)
        port.apply(op)
        if op[0] != "deposit":
            continue
        for t in TENANTS:
            if t != op[1]:
                floor = min(QUOTAS[t][0], before.get(t, 0))
                assert port.mgr.tenant_bytes.get(t, 0) >= floor, (op, t)


@OPS
@given(ops=st.lists(_op, max_size=40))
def test_grant_order_does_not_change_policy(ops):
    """Victims, refusals and gauges are functions of the op sequence
    alone: the other grant order changes no entry, gauge or flush."""
    a, b = _Views(["lat", "bat"]), _Views(["bat", "lat"])
    for op in ops:
        a.apply(op)
        b.apply(op)
    assert a.flushed == b.flushed
    assert _state(a.mgr) == _state(b.mgr)


@OPS
@given(ops=st.lists(_op, max_size=30), nbytes=st.integers(1, 70))
def test_pinned_bytes_are_not_stealable(ops, nbytes):
    """With everything "lat" holds pinned, a "bat" burst that only fits
    by evicting pinned bytes is refused and disturbs nothing; one that
    fits leaves every pinned entry resident."""
    port = _Views()
    for op in ops:
        port.apply(op)
    mgr = port.mgr
    for key in list(mgr._entries):
        if key[0] == "lat" and key not in mgr._shadows:
            port.views["lat"].pin(key[1])
    pinned = {k for k, e in mgr._entries.items() if e.pinned}
    pinned_bytes = sum(mgr._entries[k].nbytes for k in pinned)
    entries_before = dict(mgr._entries)
    used_before = mgr.bytes_used
    res = port.views["bat"].deposit("burst", 0, "x",
                                    BUDGET - pinned_bytes + nbytes)
    if not res.stored:
        assert mgr._entries == entries_before
        assert mgr.bytes_used == used_before
    else:
        assert pinned <= set(mgr._entries)
        assert mgr.bytes_used <= BUDGET


# ----------------------------------------------------------------------
# the live engines: a per-tenant cut at any round boundary
# ----------------------------------------------------------------------
SHAPE = (32, 8, 8)


def _initial(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.standard_normal(SHAPE).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32))


def _cut_run(Scheduler, cfg, seed, cut_at, directory):
    """Tenant A (depth2, 3 sweeps, its working set reserved, priority
    10) cut at round ``cut_at`` of the interleave while tenant B
    (temporal2, 4 sweeps, batch) keeps running; returns the scheduler,
    the cut's path and A's sweeps at the cut."""
    ws = working_set_bytes(cfg, "depth2")
    sched = Scheduler(ws + ws // 2)
    sched.submit("A", cfg, *_initial(seed), schedule="depth2", sweeps=3,
                 reserve=ws, priority=10)
    sched.submit("B", cfg, *_initial(seed + 100), schedule="temporal2",
                 sweeps=4, reserve=0)
    rounds = interleave_rounds(sched.specs())
    cut_path = cut_sweeps = None
    for i, (name, start, kr) in enumerate(rounds):
        if i == min(cut_at, len(rounds) - 1):
            cut_path = sched.checkpoint_tenant("A", directory, zstd_level=0)
            cut_sweeps = sched.tenants["A"].executor.sweeps_done
        sched.tenants[name].executor.advance_round(start + kr)
    sched.run()
    return sched, cut_path, cut_sweeps


@settings(deadline=None, max_examples=8, derandomize=True)
@given(cut_at=st.integers(0, 5), seed=st.integers(0, 3))
def test_checkpoint_any_boundary_restores_bit_identical(
    tmp_path_factory, cut_at, seed
):
    """Cut A at an arbitrary global round boundary while B keeps
    running: the restored run finishes bit for bit A's solo run, B is
    bit for bit its solo run, and the transfers of both equal the
    reference's. The reference's cut, run here too, holds as well (the
    oracle)."""
    cfg = OOCConfig(SHAPE, 2, 1, paper_code_fields(2), backend="ref",
                    device="cpu")
    jcfg = JConfig(SHAPE, 2, 1, jfields(2))
    tmp = tmp_path_factory.mktemp("cut")
    sched, path, cut_sweeps = _cut_run(TenantScheduler, cfg, seed, cut_at,
                                       str(tmp / "port"))
    jsched, jpath, jcut = _cut_run(JScheduler, jcfg, seed, cut_at,
                                   str(tmp / "ref"))
    assert cut_sweeps == jcut
    for name in ("A", "B"):
        assert [dataclasses.astuple(t) for t in sched.transfers(name)] == [
            dataclasses.astuple(t) for t in jsched.transfers(name)]
    restored = AsyncExecutor.restore(path, device="cpu")
    restored.run(3 - cut_sweeps)
    jrestored = JExecutor.restore(jpath)
    jrestored.run(3 - jcut)
    solo_a = AsyncExecutor(cfg, *_initial(seed), schedule="depth2")
    solo_a.run(3)
    jsolo_a = JExecutor(jcfg, *_initial(seed), schedule="depth2")
    jsolo_a.run(3)
    np.testing.assert_array_equal(jrestored.gather("p_cur"),
                                  jsolo_a.gather("p_cur"))
    got = restored.gather("p_cur")
    np.testing.assert_array_equal(got, solo_a.gather("p_cur"))
    want = jrestored.gather("p_cur")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GATHER_RTOL[2] * np.abs(want).max())
    solo_b = AsyncExecutor(cfg, *_initial(seed + 100),
                           schedule="temporal2")
    solo_b.run(4)
    np.testing.assert_array_equal(sched.gather("B", "p_cur"),
                                  solo_b.gather("p_cur"))
    for eng in (restored, solo_a, solo_b):
        eng.close()
    sched.close()

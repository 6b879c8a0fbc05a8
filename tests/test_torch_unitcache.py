"""The port's residency manager (``repro_torch.core.unitcache``) against
the JAX package's: the same sequences of deposits, lookups, flushes,
pins and releases give the same answers, the same victims in the same
order and the same ``CacheStats``, step by step. Sequences are drawn
from a seeded numpy generator over a few keys, versions, sizes and rate
labels, for both write policies and budgets that refuse, evict and hold
everything; the multi-tenant arbiter runs the same way with quotas.
"""

import numpy as np
import pytest

from repro.core import unitcache as jcache
from repro_torch.core import unitcache as tcache

KEYS = [("p_prev", ("R", 0)), ("p_prev", ("C", 0)), ("p_cur", ("R", 1)),
        ("p_cur", ("C", 1)), ("vel2", ("R", 2)), ("vel2", ("C", 2))]
RATES = [None, "raw", "p12", "p16"]


def _flushes(res):
    return [(k, e.version, e.nbytes, e.dirty) for k, e in res]


def _step(mgr, op, args):
    """One operation and what it answered, in plain values."""
    if op == "deposit":
        res = mgr.deposit(*args[:4], dirty=args[4], bumps=args[5],
                          rate=args[6])
        return res.stored, _flushes(res.flushes)
    if op == "lookup":
        hit, value = mgr.lookup(*args)
        return hit, value
    if op == "dirty":
        return [(k, e.version, e.nbytes) for k, e in mgr.dirty_entries()]
    if op == "mark":  # a flush's put succeeded
        ent = mgr.peek(args[0])
        if ent is not None and ent.dirty:
            mgr.mark_flushed(args[0])
        return None
    if op == "pin":
        ent = mgr.pin(args[0])
        return None if ent is None else (ent.version, ent.nbytes)
    if op == "release":
        return _flushes(mgr.release(args[0]))
    if op == "elide":
        mgr.note_d2h_elided(args[0])
        return None
    raise AssertionError(op)


def _ops(seed, n, tenants=None):
    rng = np.random.default_rng(seed)
    versions = {}
    pinned = []
    for _ in range(n):
        r = rng.random()
        key = KEYS[int(rng.integers(len(KEYS)))]
        if tenants:
            key = (tenants[int(rng.integers(len(tenants)))], key)
        if r < 0.45:
            ver = versions.get(key, 0) + int(rng.integers(0, 2))
            versions[key] = ver
            yield "deposit", (key, ver, f"v{ver}",
                              int(rng.integers(1, 9)) * 1000,
                              bool(rng.random() < 0.7),
                              int(rng.integers(0, 3)),
                              RATES[int(rng.integers(len(RATES)))])
        elif r < 0.75:
            yield "lookup", (key, versions.get(key, 0))
        elif r < 0.82:
            yield "dirty", ()
        elif r < 0.9:
            yield "mark", (key,)
        elif r < 0.95 and not tenants and key not in pinned:
            pinned.append(key)  # one snapshot pin a key at a time
            yield "pin", (key,)
        elif pinned:
            yield "release", (pinned.pop(0),)
        else:
            yield "elide", (int(rng.integers(1, 5)) * 1000,)


def _same(jmgr, tmgr):
    assert tmgr.stats.as_dict() == jmgr.stats.as_dict()
    assert (tmgr.bytes_used, tmgr.peak_bytes, tmgr.dirty_bytes, len(tmgr)) \
        == (jmgr.bytes_used, jmgr.peak_bytes, jmgr.dirty_bytes, len(jmgr))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("budget", [0, 5_000, 16_000, 1 << 30])
@pytest.mark.parametrize("policy", ["write-back", "write-through"])
def test_sequences_equal_reference(policy, budget, seed):
    jmgr = jcache.DeviceResidencyManager(budget, policy=policy)
    tmgr = tcache.DeviceResidencyManager(budget, policy=policy)
    for op, args in _ops(seed, 300):
        assert _step(tmgr, op, args) == _step(jmgr, op, args), (op, args)
        _same(jmgr, tmgr)
    assert [k for k, _ in tmgr.dirty_entries()] == \
        [k for k, _ in jmgr.dirty_entries()]


@pytest.mark.parametrize("seed", range(3))
def test_arbiter_sequences_equal_reference(seed):
    mgrs = []
    for mod in (jcache, tcache):
        arb = mod.ResidencyArbiter()
        arb.grant("a", 6_000, priority=1)
        arb.grant("b", 3_000)
        mgrs.append(mod.DeviceResidencyManager(20_000, arbiter=arb))
    jmgr, tmgr = mgrs
    for op, args in _ops(seed, 300, tenants=["a", "b", "c"]):
        assert _step(tmgr, op, args) == _step(jmgr, op, args), (op, args)
        _same(jmgr, tmgr)
    for tenant in ("a", "b", "c"):
        assert (tmgr.tenant_stats_for(tenant).as_dict()
                == jmgr.tenant_stats_for(tenant).as_dict())
    assert tmgr.tenant_bytes == jmgr.tenant_bytes


def test_alias_and_policy_validation():
    assert tcache.UnitCache is tcache.DeviceResidencyManager
    with pytest.raises(ValueError, match="policy"):
        tcache.DeviceResidencyManager(10, policy="nope")

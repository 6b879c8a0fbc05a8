"""Self-healing of the port's live engine under injected faults: the
contract of ``tests/test_chaos.py`` on the port, on the CPU.

* every single-fault kind of ``tests/test_chaos.py`` (``SINGLE_FAULTS``)
  and the generated seeds, absorbed by retry or by rollback and replay
  (``run(recovery=RecoveryPolicy(...))``), leave the fields bit for bit
  those of the port's fault-free run, and ``recovery_log`` equals
  ``repro``'s for the same ``FaultPlan``, field for field (the
  checkpoint by its ``step_<k>`` name);
* a fault that outlives the retry budget on every replay propagates;
  corruption never reaches a stencil step;
* a rollback gives every staging slot back to the pool (parked
  writebacks, fetches not yet claimed), aborts a half-written snapshot,
  and the replay runs on the same host threads;
* two tenants on one scheduler (``serving.ooc.TenantScheduler``, the
  band of ``tests/test_chaos.py``): a crash or a generated fault in
  tenant A rolls A back alone, B never restarts, both are bit for bit
  their solo runs, and A's ``recovery_log`` equals ``repro``'s.
"""

import os
import pathlib

import numpy as np
import pytest

from repro.core.executor import AsyncExecutor as JExecutor
from repro.core.executor import CheckpointPolicy as JCheckpointPolicy
from repro.core.executor import RecoveryPolicy as JRecoveryPolicy
from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import paper_code_fields as jfields
from repro.distributed import fault as jfault
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.executor import AsyncExecutor, CheckpointPolicy, \
    RecoveryPolicy
from repro_torch.core.outofcore import OOCConfig, paper_code_fields
from repro_torch.distributed.fault import FaultInjector, FaultPlan, \
    FaultSpec, RetryPolicy, UnrecoverableFault
from repro_torch.kernels.stencil import ref as stencil_ref

SHAPE = (32, 8, 8)
SWEEPS = 4
FIELDS = ("p_cur", "p_prev")
UNITS = ("R0", "R1", "C0")
RETRY = dict(attempts=3, backoff_s=0.001)

_BAND = int(os.environ.get("CHAOS_SEED", "0"))
GEN_SEEDS = list(range(8 * _BAND, 8 * _BAND + 8))

SINGLE_FAULTS = {
    "transfer-h2d": dict(kind="transfer", op="h2d", field="p_cur",
                         unit="R0", attempts=2),
    "transfer-d2h": dict(kind="transfer", op="d2h", field="p_prev",
                         unit="C0", attempts=1),
    "corrupt-h2d": dict(kind="corrupt", op="h2d", field="p_cur",
                        unit="C0", attempts=1),
    "corrupt-d2h": dict(kind="corrupt", op="d2h", field="p_cur",
                        unit="R1", attempts=2),
    "straggle": dict(kind="straggle", op="h2d", unit="C0", factor=6.0),
    "shard": dict(kind="shard", field="p_cur", unit="R0"),
    "crash": dict(kind="crash", sweep=2),
}


def _initial():
    p_cur = stencil_ref.ricker_source(SHAPE).numpy()
    return (0.95 * p_cur).astype(np.float32), p_cur, \
        np.full(SHAPE, 0.07, np.float32)


def _cfg():
    return OOCConfig(SHAPE, 2, 1, paper_code_fields(2), backend="ref",
                     device="cpu")


def _run(specs=None, *, recovery_dir=None, ckpt_every=None,
         plan_kw=None, cache_bytes=0):
    plan = (FaultPlan([FaultSpec(**s) for s in specs or ()],
                      **(plan_kw or {}))
            if specs is not None or plan_kw else None)
    eng = AsyncExecutor(
        _cfg(), *_initial(), schedule="unitgrain", cache_bytes=cache_bytes,
        retry=RetryPolicy(**RETRY),
        injector=FaultInjector(plan) if plan is not None else None,
    )
    eng.run(SWEEPS, ckpt_policy=(
        CheckpointPolicy(recovery_dir, every_sweeps=ckpt_every, zstd_level=0)
        if ckpt_every else None), recovery=(
        RecoveryPolicy(recovery_dir, zstd_level=0)
        if recovery_dir is not None else None))
    return eng


def _jax_run(specs, recovery_dir, ckpt_every):
    plan = jfault.FaultPlan([jfault.FaultSpec(**s) for s in specs])
    eng = JExecutor(
        JConfig(SHAPE, 2, 1, jfields(2)), *_initial(),
        schedule="unitgrain", cache_bytes=0,
        retry=jfault.RetryPolicy(**RETRY),
        injector=jfault.FaultInjector(plan),
    )
    eng.run(SWEEPS, ckpt_policy=JCheckpointPolicy(
        recovery_dir, every_sweeps=ckpt_every, zstd_level=0),
        recovery=JRecoveryPolicy(recovery_dir, zstd_level=0))
    return eng


def _log(eng):
    return [dict(e, checkpoint=pathlib.Path(e["checkpoint"]).name)
            for e in eng.recovery_log]


@pytest.fixture(scope="module")
def fault_free():
    eng = _run()
    return {n: eng.gather(n) for n in FIELDS}


def _assert_healed(eng, fault_free):
    for name in FIELDS:
        np.testing.assert_array_equal(eng.gather(name), fault_free[name])
    assert eng.lanes.free_slots == len(eng.lanes._slots)


def _spec_dicts(plan):
    return [{k: getattr(s, k) for k in ("kind", "op", "field", "unit",
                                        "version", "attempts", "sweep",
                                        "factor")}
            for s in plan.specs]


@pytest.mark.parametrize("name", sorted(SINGLE_FAULTS))
def test_single_fault_heals_like_the_reference(tmp_path, name, fault_free):
    specs = [SINGLE_FAULTS[name]]
    eng = _run(specs, recovery_dir=str(tmp_path / "t"), ckpt_every=2)
    jeng = _jax_run(specs, str(tmp_path / "j"), 2)
    assert _log(eng) == _log(jeng)
    assert dict(eng.injector.counts) == dict(jeng.injector.counts)
    _assert_healed(eng, fault_free)
    assert sum(eng.injector.counts.values()) > 0, "the fault never fired"
    if name == "crash":
        assert eng.cache.stats.recoveries == 1
        assert eng.recovery_log[0]["from_sweep"] == 2
    if name == "shard":
        assert eng.cache.stats.shard_retries > 0
    if name.startswith(("transfer", "corrupt")):
        wire = eng.store.wire_stats
        assert wire["h2d_retries"] + wire["d2h_retries"] > 0


@pytest.mark.parametrize("seed", GEN_SEEDS)
def test_generated_single_fault_survives(tmp_path, seed, fault_free):
    plan = FaultPlan.generate(seed, fields=FIELDS, units=UNITS,
                              sweeps=SWEEPS)
    specs = _spec_dicts(plan)
    eng = _run(specs, recovery_dir=str(tmp_path / "t"), ckpt_every=2)
    _assert_healed(eng, fault_free)
    jplan = jfault.FaultPlan.generate(seed, fields=FIELDS, units=UNITS,
                                      sweeps=SWEEPS)
    assert _spec_dicts(jplan) == specs
    assert _log(eng) == _log(_jax_run(specs, str(tmp_path / "j"), 2))


def test_retry_exhaustion_recovers_or_propagates(tmp_path, fault_free):
    persistent = [dict(kind="corrupt", op="h2d", field="p_cur", unit="R0",
                       version=0, attempts=3)]
    with pytest.raises(UnrecoverableFault):
        _run(persistent, recovery_dir=str(tmp_path / "a"))
    transient = [dict(persistent[0], attempts=2)]
    _assert_healed(_run(transient, recovery_dir=str(tmp_path / "b")),
                   fault_free)


def test_corruption_never_reaches_a_stencil_step(fault_free):
    eng = _run(plan_kw=dict(seed=5, p_corrupt=0.08))
    inj, wire = eng.injector.counts, eng.store.wire_stats
    assert inj["corruptions"] > 0
    assert wire["checksum_failures"] == inj["corruptions"]
    _assert_healed(eng, fault_free)


@pytest.mark.parametrize("budget", [0, 6000])
def test_rollback_gives_every_staging_slot_back(tmp_path, fault_free,
                                                budget):
    """A fetch that fails mid-visit leaves its visit's other fetches
    unclaimed and the window's writebacks parked, each holding a slot,
    and a snapshot half written. The rollback gives all of them back
    (once their host jobs are done), aborts the snapshot, and the replay
    on the same host threads finishes bit for bit."""
    eng = AsyncExecutor(
        _cfg(), *_initial(), schedule="depth2", cache_bytes=budget,
        retry=RetryPolicy(attempts=2),
        injector=FaultInjector(FaultPlan([FaultSpec(
            kind="corrupt", op="h2d", field="p_cur", unit="R0", version=1,
            attempts=2)])),
    )
    lanes = eng.lanes
    base = str(tmp_path / "base")
    eng.checkpoint(base, zstd_level=0)
    eng.sweep()
    eng.begin_checkpoint(str(tmp_path / "cut"), zstd_level=0)
    with pytest.raises(UnrecoverableFault, match="p_cur.R0"):
        eng.sweep()
    assert eng._ckpt_writer is not None  # the snapshot was mid-drain
    assert lanes.free_slots < len(lanes._slots)
    eng.injector = eng.store.injector = None  # the fault has passed
    eng._rollback(base, RuntimeError("lost"))
    assert lanes.free_slots == len(lanes._slots)
    assert eng._ckpt_writer is None
    assert not list((tmp_path / "cut").glob("tmp.*"))
    assert eng.recovery_log[-1]["resumed_at"] == 0
    assert eng.cache.stats.recoveries == 1
    eng.run(SWEEPS)
    for name in FIELDS:
        np.testing.assert_array_equal(eng.gather(name), fault_free[name])
    assert lanes.free_slots == len(lanes._slots)
    eng.close()


def test_recovery_takes_a_baseline_and_bounds_restarts(tmp_path,
                                                       fault_free):
    eng = _run([dict(kind="crash", sweep=1)],
               recovery_dir=str(tmp_path / "a"))
    _assert_healed(eng, fault_free)
    assert ckpt.latest(str(tmp_path / "a")).endswith("step_0000000000")
    assert eng.stats()["recoveries"][0]["resumed_at"] == 0
    assert eng.cache.stats.replayed_sweeps == 1
    eng = AsyncExecutor(_cfg(), *_initial(), schedule="unitgrain",
                        injector=FaultInjector(FaultPlan(
                            [FaultSpec(kind="crash", sweep=1)])))
    with pytest.raises(Exception, match="boundary 1"):
        eng.run(SWEEPS, recovery=RecoveryPolicy(str(tmp_path / "b"),
                                                max_restarts=0))


# ----------------------------------------------------------------------
# two tenants on one device (tests/test_chaos.py's two-tenant band): a
# fault or crash in tenant A neither corrupts nor rolls back tenant B
# ----------------------------------------------------------------------
def _two_tenant_run(specs, directory, *, sweeps_a=4, sweeps_b=3):
    """Tenant A under ``specs`` with a recovery policy, tenant B clean,
    on one scheduler whose budget makes them contend for residency."""
    from repro_torch.core.tenancy import working_set_bytes
    from repro_torch.serving.ooc import TenantScheduler

    cfg_a, cfg_b = _cfg(), _cfg()
    ws_a = working_set_bytes(cfg_a, "depth2")
    ws_b = working_set_bytes(cfg_b, "temporal2")
    sched = TenantScheduler(ws_a + ws_b // 2)
    sched.submit(
        "A", cfg_a, *_initial(), schedule="depth2", sweeps=sweeps_a,
        reserve=ws_a, priority=0, retry=RetryPolicy(**RETRY),
        injector=FaultInjector(FaultPlan([FaultSpec(**s) for s in specs])),
        recovery=RecoveryPolicy(directory, zstd_level=0),
    )
    sched.submit("B", cfg_b, *_initial(), schedule="temporal2",
                 sweeps=sweeps_b, reserve=0, priority=10)
    sched.run()
    return sched


def _jax_two_tenant_run(specs, directory, *, sweeps_a=4, sweeps_b=3):
    from repro.core.tenancy import working_set_bytes
    from repro.serving.ooc import TenantScheduler

    cfg = JConfig(SHAPE, 2, 1, jfields(2))
    ws_a = working_set_bytes(cfg, "depth2")
    ws_b = working_set_bytes(cfg, "temporal2")
    sched = TenantScheduler(ws_a + ws_b // 2)
    sched.submit(
        "A", cfg, *_initial(), schedule="depth2", sweeps=sweeps_a,
        reserve=ws_a, priority=0, retry=jfault.RetryPolicy(**RETRY),
        injector=jfault.FaultInjector(
            jfault.FaultPlan([jfault.FaultSpec(**s) for s in specs])),
        recovery=JRecoveryPolicy(directory, zstd_level=0),
    )
    sched.submit("B", cfg, *_initial(), schedule="temporal2",
                 sweeps=sweeps_b, reserve=0, priority=10)
    sched.run()
    return sched


def _assert_tenants_isolated(sched, jsched, *, sweeps_a=4, sweeps_b=3):
    """Both tenants bit for bit their solo fault-free runs; B saw no
    recovery; A's recovery log is the reference's and its pool is
    whole."""
    a, b = sched.tenants["A"].executor, sched.tenants["B"].executor
    ja = jsched.tenants["A"].executor
    assert b.recovery_log == []
    assert _log(a) == _log(ja)
    assert dict(a.injector.counts) == dict(ja.injector.counts)
    assert a.store.wire_log == ja.store.wire_log
    per = sched.stats()["per_tenant"]
    assert per["A"]["restarts"] == jsched.stats()["per_tenant"]["A"][
        "restarts"]
    assert per["B"]["restarts"] == 0
    assert per["B"]["recoveries"] == 0
    assert per["B"]["replayed_sweeps"] == 0
    solo_a = AsyncExecutor(_cfg(), *_initial(), schedule="depth2")
    solo_a.run(sweeps_a)
    solo_b = AsyncExecutor(_cfg(), *_initial(), schedule="temporal2")
    solo_b.run(sweeps_b)
    for name in FIELDS:
        np.testing.assert_array_equal(sched.gather("A", name),
                                      solo_a.gather(name))
        np.testing.assert_array_equal(sched.gather("B", name),
                                      solo_b.gather(name))
    for eng in (a, b):
        assert eng.lanes.free_slots == len(eng.lanes._slots)
    for eng in (solo_a, solo_b):
        eng.close()
    sched.close()


def test_two_tenant_crash_rolls_back_alone(tmp_path):
    """A corrupted fetch and a crash in tenant A: A rolls back and
    replays once, its view dropping only its own residency; B, mid-run
    on the same device, neither rolls back nor diverges."""
    specs = [dict(kind="corrupt", op="h2d", field="p_cur", unit="C0",
                  attempts=1),
             dict(kind="crash", sweep=2)]
    sched = _two_tenant_run(specs, str(tmp_path / "t"))
    jsched = _jax_two_tenant_run(specs, str(tmp_path / "j"))
    per = sched.stats()["per_tenant"]
    assert per["A"]["restarts"] == 1
    assert per["A"]["recoveries"] == 1
    assert sum(sched.tenants["A"].executor.injector.counts.values()) > 0
    _assert_tenants_isolated(sched, jsched)


@pytest.mark.parametrize("seed", GEN_SEEDS)
def test_two_tenant_generated_fault_isolated(tmp_path, seed):
    """The seeded band (widened by ``CHAOS_SEED``): any generated single
    fault in tenant A leaves both tenants bit for bit their solo runs,
    B untouched by the recovery, A's log the reference's."""
    plan = FaultPlan.generate(seed, fields=FIELDS, units=UNITS, sweeps=4)
    specs = _spec_dicts(plan)
    sched = _two_tenant_run(specs, str(tmp_path / "t"))
    jsched = _jax_two_tenant_run(specs, str(tmp_path / "j"))
    _assert_tenants_isolated(sched, jsched)

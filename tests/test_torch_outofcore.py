"""Port out-of-core engine (``repro_torch.core.outofcore``) against the
JAX package's synchronous engine, on the CPU with the plain versions.

For codes 1-4 and temporal fusion 1 and 2 on (96, 16, 16), ndiv 4:

* the transfer summary equals the reference's exactly (fixed rates make
  wire bytes independent of the data);
* gathered fields agree within ``GATHER_RTOL[code]`` of the field's
  amplitude: the reference's jitted stencil and the port's eager one
  differ by a few ulps, and on a lossy code that drift can move one
  codec rounding, a gap of one quantization step at the code's rate;
* code 1 is lossless, so it equals the port's in-core ``run_steps`` at
  atol 0;
* a reference ``state_dict`` carried over with ``wave_from_reference``
  gathers bit for bit what the reference gathers (same crc32 digests).

Temporal 2 uses bt=1: at bt=2 its halo (16 planes) would not fit the
24-plane blocks of ndiv 4, which both engines reject.

float64 at the paper's rates (32/24, ``paper_code_fields(code,
f32=False)``), against the reference engine under ``jax_enable_x64`` (on
inside ``_x64``, restored in its ``finally``): transfers exact, fields
within ``_f64_tol`` (ulps for a lossless code, the codec's bound at the
field's amplitude for a lossy one), and a float64 code 4 store carried
over from the reference gathers bit for bit.
"""

import numpy as np
import pytest
import torch

from repro.core.outofcore import HostUnitStore as JStore
from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import OutOfCoreWave as JWave
from repro.core.outofcore import paper_code_fields as jfields
from repro.core.outofcore import unit_checksum as jchecksum
from repro.core.ratecontrol import _analytic_bound as janalytic_bound
from repro_torch.convert import wave_from_reference
from repro_torch.core import outofcore as tooc
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave, \
    paper_code_fields
from repro_torch.distributed.fault import ChecksumError
from repro_torch.kernels.stencil import ref as tref
from test_torch_stencil import _x64

SHAPE = (96, 16, 16)
NDIV = 4
RUNS = [(1, 2), (2, 1)]  # (temporal, bt)
GATHER_RTOL = {1: 1e-5, 2: 1e-3, 3: 1e-5, 4: 2e-2}


def _initial(shape=SHAPE):
    p_cur = tref.ricker_source(shape).numpy()
    p_prev = (0.95 * p_cur).astype(np.float32)
    vel2 = np.full(shape, 0.07, dtype=np.float32)
    return p_prev, p_cur, vel2


def _engines(code, temporal, bt, sweeps=2):
    fields = _initial()
    jax_eng = JWave(JConfig(SHAPE, NDIV, bt, jfields(code)), *fields,
                    temporal=temporal)
    cfg = OOCConfig(SHAPE, NDIV, bt, paper_code_fields(code),
                    backend="ref", device="cpu")
    port = OutOfCoreWave(cfg, *fields, temporal=temporal)
    for eng in (jax_eng, port):
        eng.run(sweeps * bt * temporal)
    return jax_eng, port, fields


@pytest.mark.parametrize("temporal,bt", RUNS)
@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_engine_matches_reference(code, temporal, bt):
    jax_eng, port, fields = _engines(code, temporal, bt)
    assert port.transfer_summary() == jax_eng.transfer_summary()
    assert port.sweeps_done == jax_eng.sweeps_done
    for name in ("p_prev", "p_cur", "vel2"):
        want = jax_eng.gather(name)
        got = port.gather(name)
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = GATHER_RTOL[code] * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if code == 1:
        steps = 2 * bt * temporal
        pp, pc = tref.run_steps(*(torch.from_numpy(a) for a in fields), steps)
        np.testing.assert_allclose(port.gather("p_cur"), pc.numpy(),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(port.gather("p_prev"), pp.numpy(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("temporal,bt", RUNS)
@pytest.mark.parametrize("code", [1, 4])
def test_state_carried_over_from_reference(code, temporal, bt):
    jax_eng, _, _ = _engines(code, temporal, bt, sweeps=1)
    leaves, meta = jax_eng.store.state_dict()
    port = wave_from_reference(jax_eng.cfg.to_dict(), leaves, meta,
                               jax_eng.sweeps_done, "cpu", temporal=temporal)
    assert port.sweeps_done == jax_eng.sweeps_done
    assert port.cfg.backend == "ref"
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(port.gather(name),
                                      jax_eng.gather(name))
    for key in jax_eng.store.unit_keys():
        assert port.store.checksum_of(*key) == jax_eng.store.checksum_of(*key)
        assert port.store.version_of(*key) == jax_eng.store.version_of(*key)
    # and the port's own snapshot restores into the reference's store
    tleaves, tmeta = port.store.state_dict()
    back = JStore(jax_eng.cfg, plan=jax_eng.plan)
    back.load_state(tleaves, tmeta)
    for key in jax_eng.store.unit_keys():
        assert back.checksum_of(*key) == jax_eng.store.checksum_of(*key)
    # both continue one more round and stay within the contract
    for eng in (jax_eng, port):
        eng.run(bt * temporal)
    tol = GATHER_RTOL[code] * np.abs(jax_eng.gather("p_cur")).max()
    np.testing.assert_allclose(port.gather("p_cur"), jax_eng.gather("p_cur"),
                               rtol=0, atol=tol)


def test_carried_state_with_wrong_layout_or_digest_refused():
    jax_eng, _, _ = _engines(4, 1, 1, sweeps=1)
    leaves, meta = jax_eng.store.state_dict()
    with pytest.raises(ValueError, match="the plan .temporal=2"):
        wave_from_reference(jax_eng.cfg.to_dict(), leaves, meta, 1, "cpu",
                            temporal=2)
    key = "p_cur.R1"
    bad = dict(leaves)
    bad[key] = leaves[key].copy()
    bad[key].flat[0] += 1.0
    with pytest.raises(ChecksumError, match=key):
        wave_from_reference(jax_eng.cfg.to_dict(), bad, meta, 1, "cpu")


def test_unit_checksum_matches_reference():
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((4, 8, 8)).astype(np.float32)
    assert tooc.unit_checksum(raw, 5) == jchecksum(raw, 5)
    assert tooc.unit_checksum(torch.from_numpy(raw), 5) == jchecksum(raw, 5)


def test_config_round_trip_and_validation():
    cfg = OOCConfig(SHAPE, NDIV, 2, paper_code_fields(4), backend="ref",
                    device="cpu")
    assert OOCConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(ValueError, match="halo-width"):
        cfg.temporal_plan(2)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        OutOfCoreWave(OOCConfig(SHAPE, NDIV, 2, paper_code_fields(1),
                                backend="cuda", device="cpu"), *_initial())
    with pytest.raises(ValueError, match="backend"):
        OutOfCoreWave(OOCConfig(SHAPE, NDIV, 2, paper_code_fields(1),
                                backend="pallas", device="cpu"), *_initial())


def _stores(plan_kwargs, retry_attempts):
    """A reference store and a port store under the same seeded fault
    plan, both seeded from the same fields (code 4, ndiv 4, bt 2)."""
    from repro.distributed.fault import FaultInjector as JInjector
    from repro.distributed.fault import FaultPlan as JPlan
    from repro.distributed.fault import RetryPolicy as JRetry
    from repro_torch.distributed.fault import FaultInjector, FaultPlan, \
        RetryPolicy

    fields = dict(zip(("p_prev", "p_cur", "vel2"), _initial()))
    jcfg = JConfig(SHAPE, NDIV, 2, jfields(4))
    jstore = JStore(jcfg, injector=JInjector(JPlan(**plan_kwargs)),
                    retry=JRetry(attempts=retry_attempts))
    cfg = OOCConfig(SHAPE, NDIV, 2, paper_code_fields(4), backend="ref",
                    device="cpu")
    tstore = tooc.HostUnitStore(
        cfg, injector=FaultInjector(FaultPlan(**plan_kwargs)),
        retry=RetryPolicy(attempts=retry_attempts))
    for store in (jstore, tstore):
        store.seed(fields)
    return jstore, tstore


def test_faulty_wire_retries_like_reference():
    """Seeded transfer failures and in-flight corruption: the port's
    wire retries, counts and logs every crossing as the reference's."""
    plan = dict(seed=11, p_transfer=0.2, p_corrupt=0.3)
    jstore, tstore = _stores(plan, retry_attempts=8)
    for kind, idx, _ in tstore.plan.units():
        for name in ("p_prev", "vel2"):
            jdev, _, _ = jstore.stage(name, kind, idx)
            tdev, _, _ = tstore.stage(name, kind, idx)
            np.testing.assert_array_equal(
                tdev.payload.view(torch.int32).numpy().view(np.uint32),
                np.asarray(jdev.payload))
        value = jstore.get("p_cur", kind, idx)
        jstore.put("p_cur", kind, idx, value)
        tstore.put("p_cur", kind, idx, torch.from_numpy(np.array(value)))
    assert tstore.wire_stats == jstore.wire_stats
    assert tstore.wire_stats["checksum_failures"] > 0
    assert tstore.wire_stats["wire_faults"] > 0
    assert tstore.attempt_multiset() == jstore.attempt_multiset()


def test_exhausted_retries_raise_unrecoverable():
    from repro_torch.distributed.fault import UnrecoverableFault

    _, tstore = _stores(dict(seed=3, p_corrupt=1.0), retry_attempts=2)
    with pytest.raises(UnrecoverableFault, match="h2d of unit vel2.R0"):
        tstore.stage("vel2", "R", 0)
    assert tstore.wire_stats["checksum_failures"] == 2


def _initial64(shape=SHAPE):
    p_cur = tref.ricker_source(shape, dtype=torch.float64).numpy()
    return 0.95 * p_cur, p_cur, np.full(shape, 0.07)


def _f64_tol(code, amplitude):
    """The gather tolerance of a float64 engine pair: the jitted and the
    eager stencil differ by ulps (measured <= 8.2e-16 relative), so 1e-12
    of the amplitude for a lossless code; a lossy code may also move one
    codec rounding, held to the codec's worst-case bound at its coarsest
    rate (the reference's analytic bound, planes 24 or 32)."""
    rates = [sp.planes for sp in jfields(code, f32=False).values()
             if sp.planes is not None]
    if not rates:
        return 1e-12 * amplitude
    return janalytic_bound(amplitude, min(rates), 3, "float64")


def _engines64(code, temporal, bt, sweeps=2):
    """Reference and port float64 engines after ``sweeps`` rounds: the
    reference's gathered fields and summary, and the port engine."""
    fields = _initial64()
    cfg = OOCConfig(SHAPE, NDIV, bt, paper_code_fields(code, f32=False),
                    backend="ref", device="cpu", dtype="float64")
    port = OutOfCoreWave(cfg, *fields, temporal=temporal)
    port.run(sweeps * bt * temporal)
    with _x64():
        jax_eng = JWave(JConfig(SHAPE, NDIV, bt, jfields(code, f32=False),
                                dtype="float64"), *fields, temporal=temporal)
        jax_eng.run(sweeps * bt * temporal)
        want = {n: jax_eng.gather(n) for n in ("p_prev", "p_cur", "vel2")}
    return jax_eng, want, port, fields


@pytest.mark.parametrize("temporal,bt", RUNS)
@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_f64_engine_matches_reference(code, temporal, bt):
    jax_eng, want, port, fields = _engines64(code, temporal, bt)
    assert port.transfer_summary() == jax_eng.transfer_summary()
    for name, w in want.items():
        got = port.gather(name)
        assert got.dtype == w.dtype == np.float64
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=_f64_tol(code, np.abs(w).max()))
    if code == 1:
        steps = 2 * bt * temporal
        pp, pc = tref.run_steps(*(torch.from_numpy(a) for a in fields), steps)
        np.testing.assert_array_equal(port.gather("p_cur"), pc.numpy())
        np.testing.assert_array_equal(port.gather("p_prev"), pp.numpy())


def test_f64_state_carried_over_from_reference():
    """A float64 code 4 store at the paper's rates, built and advanced by
    the reference under x64, carried into the port: the same gathered
    fields bit for bit, the same digests and versions, and back."""
    with _x64():
        jax_eng = JWave(JConfig(SHAPE, NDIV, 2, jfields(4, f32=False),
                                dtype="float64"), *_initial64())
        jax_eng.run(2)
        leaves, meta = jax_eng.store.state_dict()
        want = {n: jax_eng.gather(n) for n in ("p_prev", "p_cur", "vel2")}
    assert {u["dtype"] for u in meta["units"].values()
            if u["codec"] == "zfp"} == {"float64"}
    port = wave_from_reference(jax_eng.cfg.to_dict(), leaves, meta,
                               jax_eng.sweeps_done, "cpu")
    assert port.cfg.dtype == "float64"
    for name, w in want.items():
        np.testing.assert_array_equal(port.gather(name), w)
    for key in jax_eng.store.unit_keys():
        assert port.store.checksum_of(*key) == jax_eng.store.checksum_of(*key)
        assert port.store.version_of(*key) == jax_eng.store.version_of(*key)
    tleaves, tmeta = port.store.state_dict()
    back = JStore(jax_eng.cfg, plan=jax_eng.plan)
    back.load_state(tleaves, tmeta)
    for key in jax_eng.store.unit_keys():
        assert back.checksum_of(*key) == jax_eng.store.checksum_of(*key)
    # both continue one more sweep and stay within the contract
    port.run(2)
    with _x64():
        jax_eng.run(2)
        w = jax_eng.gather("p_cur")
    np.testing.assert_allclose(port.gather("p_cur"), w, rtol=0,
                               atol=_f64_tol(4, np.abs(w).max()))


def _record_cat(monkeypatch):
    """Record the set of piece dtypes of every ``torch.cat``."""
    seen = []
    real = torch.cat

    def cat(pieces, *args, **kwargs):
        seen.append({t.dtype for t in pieces})
        return real(pieces, *args, **kwargs)

    monkeypatch.setattr(torch, "cat", cat)
    return seen


def test_f64_halo_and_seed_take_the_config_dtype(monkeypatch):
    """The float64 engine's halo planes and seeded units are float64:
    float32 halos made the assembly concatenate mixed types (which
    ``torch.cat`` promotes silently). float32 input to a float64 config
    is cast on seeding."""
    seen = _record_cat(monkeypatch)
    cfg = OOCConfig(SHAPE, NDIV, 2, paper_code_fields(4, f32=False),
                    backend="ref", device="cpu", dtype="float64")
    f32 = [a.astype(np.float32) for a in _initial64()]
    eng = OutOfCoreWave(cfg, *f32)
    for key in eng.store.unit_keys():
        stored = eng.store.get(*key)
        assert str(stored.dtype) == "float64", key
    halo = eng._assemble("p_cur", 0, None, 0)
    assert halo.dtype == torch.float64
    assert not halo[:eng.plan.halo].any()
    eng.sweep()
    assert eng.gather("p_cur").dtype == np.float64
    assert seen and all(d == {torch.float64} for d in seen), seen

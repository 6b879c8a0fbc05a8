"""Precision-loss tier of the port (``repro_torch.core.precision``), the
paper's Fig. 7 / §VI-C claim as a test: ``tests/test_precision_loss.py``
on the port, with the same ceilings and the same ``slow`` marker on the
long tier, on the CPU (``device="cpu"``, the plain versions).

Against the reference: on the same float32 initial fields, the port's
curve follows ``repro.core.precision.error_curve`` within
``tests/test_torch_outofcore.py``'s ``GATHER_RTOL`` of the field's scale
(the reference's jitted stencil drifts a few ulps from the port's eager
one, which on a lossy code can move one codec rounding). float64 at the
paper's rates (32/24) against the reference's float64 engine and
in-core run under ``jax_enable_x64`` (on inside ``_x64``, off again in
its ``finally``), within the float64 engine tolerance of
``tests/test_torch_outofcore.py``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import precision as jprecision
from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import OutOfCoreWave as JWave
from repro.core.outofcore import paper_code_fields as jfields
from repro.kernels.stencil import ref as jstencil
from repro_torch.core.precision import assert_bounded_growth, error_curve, \
    initial_fields
from test_torch_outofcore import GATHER_RTOL, _f64_tol

# the reference's calibrated ceilings on max|err| / max|ref|
# (tests/test_precision_loss.py)
REL_TOL_FAST = {2: 0.010, 4: 0.100}
REL_TOL_SLOW = {2: 0.030, 4: 0.350}


def curve(code, **kw):
    return error_curve(code=code, device="cpu", **kw)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("code", [2, 4])
def test_fast_error_curve_is_bounded(code):
    rows = curve(code, sweeps=8)
    assert [r["steps"] for r in rows] == [4, 8, 12, 16, 20, 24, 28, 32]
    assert_bounded_growth(rows, REL_TOL_FAST[code])
    # the error is real (lossy codec actually engaged), not zero
    assert rows[0]["max_abs"] > 0


def test_lossy_rate_orders_the_curves():
    """More aggressive rate -> more error, at every sample: the 2.67:1
    code-4 curve dominates the 2:1 code-2 curve pointwise."""
    c2 = curve(2, sweeps=6)
    c4 = curve(4, sweeps=6)
    for a, b in zip(c2, c4):
        assert a["steps"] == b["steps"]
        assert a["max_abs"] < b["max_abs"]
        assert a["rms"] < b["rms"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uncompressed_code_is_exact(dtype):
    """Code 1 (no compression) pays zero error: the engine and the
    in-core run go through the same stencil."""
    for row in curve(1, sweeps=4, dtype=dtype):
        assert row["max_abs"] == 0.0
        assert row["rms"] == 0.0


def test_bounded_growth_predicate_rejects_explosions():
    good = [
        {"steps": 4, "max_abs": 1e-4, "rms": 1e-5, "ref_scale": 1.0,
         "rel_max": 1e-4},
        {"steps": 8, "max_abs": 2e-4, "rms": 2e-5, "ref_scale": 1.0,
         "rel_max": 2e-4},
    ]
    assert_bounded_growth(good, rel_tol=1e-3)
    over = [dict(good[0], max_abs=0.5, rel_max=0.5)]
    with pytest.raises(AssertionError, match="regression bound"):
        assert_bounded_growth(over, rel_tol=1e-3)
    exploding = [good[0], dict(good[1], max_abs=0.9, rel_max=0.9)]
    with pytest.raises(AssertionError, match="exploded"):
        assert_bounded_growth(exploding, rel_tol=1.0)
    with pytest.raises(AssertionError, match="empty"):
        assert_bounded_growth([], rel_tol=1.0)
    for bad in ([dict(good[0], max_abs=float("nan"))],
                [dict(good[0], rms=1.0)]):
        with pytest.raises(AssertionError):
            assert_bounded_growth(bad, rel_tol=1.0)


@pytest.mark.slow
@pytest.mark.parametrize("code", [2, 4])
def test_long_run_error_saturates(code):
    """The paper's 4,320-step claim, scaled to the test grid: over a
    long run the error curve saturates instead of compounding."""
    rows = curve(code, sweeps=60, sample_every=5)
    assert_bounded_growth(rows, REL_TOL_SLOW[code])
    early = max(r["max_abs"] for r in rows[:3])
    late = max(r["max_abs"] for r in rows)
    assert late <= 12 * early
    # and the tail is flat-ish: the last three samples agree within 3x
    tail = [r["max_abs"] for r in rows[-3:]]
    assert max(tail) <= 3 * min(tail)


def _reference_initial(shape=(64, 24, 24)):
    """The reference curve's own float32 initial fields."""
    p_cur = np.asarray(jstencil.ricker_source(shape), dtype=np.float32)
    return {"p_prev": 0.97 * p_cur, "p_cur": p_cur,
            "vel2": np.full(shape, 0.06, dtype=np.float32)}


@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_float32_curve_matches_reference(code):
    init = _reference_initial()
    want = jprecision.error_curve(code=code, sweeps=6, sample_every=2,
                                  initial=init)
    got = curve(code, sweeps=6, sample_every=2, initial=init)
    assert [r["steps"] for r in got] == [r["steps"] for r in want]
    for g, w in zip(got, want):
        tol = GATHER_RTOL[code] * w["ref_scale"]
        assert g["ref_scale"] == pytest.approx(w["ref_scale"], rel=1e-6)
        assert abs(g["max_abs"] - w["max_abs"]) <= tol, (g, w)
        assert abs(g["rms"] - w["rms"]) <= tol, (g, w)
        assert g["units"].keys() == w["units"].keys()
        for u in g["units"]:
            assert abs(g["units"][u]["max_abs"]
                       - w["units"][u]["max_abs"]) <= tol, u
    if code == 1:
        assert all(r["max_abs"] == 0.0 for r in got)


def test_default_initial_fields_within_float_tolerance():
    """The default initial condition is the reference's (its Ricker
    evaluated in another library: an ulp or so apart)."""
    want = _reference_initial()
    got = initial_fields((64, 24, 24))
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
    assert initial_fields((8, 8, 8), "float64")["vel2"].dtype == np.float64


def _reference_f64_curve(code, shape, ndiv, bt, sweeps, init):
    """The reference's float64 curve, built from its float64 engine at
    the paper's rates and its in-core run under x64 (its
    ``error_curve`` makes float32 configurations only): p_cur's max
    |err| and scale after every sweep."""
    rows = []
    with _x64():
        eng = JWave(JConfig(shape, ndiv, bt, jfields(code, f32=False),
                            dtype="float64"),
                    init["p_prev"], init["p_cur"], init["vel2"])
        rp, rc, rv = (jnp.asarray(init[k])
                      for k in ("p_prev", "p_cur", "vel2"))
        for _ in range(sweeps):
            eng.sweep()
            rp, rc = jstencil.run_steps(rp, rc, rv, bt)
            ref = np.asarray(rc)
            rows.append((float(np.max(np.abs(eng.gather("p_cur") - ref))),
                         float(np.max(np.abs(ref)))))
    return rows


@pytest.mark.parametrize("code", [1, 2, 3, 4])
def test_float64_curve_matches_reference(code):
    """The float64 curve at the paper's rates: against the reference's
    float64 engine on the same initial fields, and far below the float32
    curve at the equivalent rates 16/12."""
    shape, ndiv, bt, sweeps = (64, 16, 16), 2, 4, 4
    init = initial_fields(shape, "float64")
    got = curve(code, shape=shape, ndiv=ndiv, bt=bt, sweeps=sweeps,
                initial=init, dtype="float64")
    want = _reference_f64_curve(code, shape, ndiv, bt, sweeps, init)
    assert [r["steps"] for r in got] == [bt * (s + 1) for s in range(sweeps)]
    for g, (w_err, w_scale) in zip(got, want):
        assert g["ref_scale"] == pytest.approx(w_scale, rel=1e-12)
        assert abs(g["max_abs"] - w_err) <= 2 * _f64_tol(code, w_scale), \
            (code, g["max_abs"], w_err)
    if code == 1:
        assert all(r["max_abs"] == 0.0 for r in got)
    else:
        f32 = curve(code, shape=shape, ndiv=ndiv, bt=bt, sweeps=sweeps)
        assert_bounded_growth(got, REL_TOL_FAST.get(code, REL_TOL_FAST[2]))
        for a, b in zip(got, f32):
            assert a["max_abs"] < b["max_abs"] / 100, (a, b)

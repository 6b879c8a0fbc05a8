"""The port's rate controller (``repro_torch.core.ratecontrol``) against
the JAX package's: the same observations give the same decision logs
(``state_dict`` after every sweep boundary, ``rate_for`` on every unit
and sweep), exactly. Also the analytic error bound, which the port reads
from its codec tables (float32 and float64), and the fixed
mode, which is bit-identical to the sync engine without a controller.
"""

import numpy as np
import pytest

from repro.core import outofcore as jooc
from repro.core import ratecontrol as jrc
from repro_torch.core import outofcore as tooc
from repro_torch.core import ratecontrol as trc
from repro_torch.kernels.stencil import ref as stencil_ref

SHAPE = (96, 12, 12)


def _cfgs(code=4, ndiv=4, bt=2):
    return (jooc.OOCConfig(SHAPE, ndiv, bt, jooc.paper_code_fields(code)),
            tooc.OOCConfig(SHAPE, ndiv, bt, tooc.paper_code_fields(code),
                           backend="ref", device="cpu"))


def _observe_all(ctrls, cfg, rng, lossless_share):
    plan = cfg.plan
    for name, spec in cfg.fields.items():
        for kind, idx, _ in plan.units():
            planes = None if rng.random() < lossless_share else int(
                rng.choice([6, 8, 12, 16, 24]))
            scale = float(10 ** rng.uniform(-4, 1))
            err = 0.0 if planes is None else float(
                scale * 10 ** rng.uniform(-7, -2))
            for c in ctrls:
                c.observe(name, kind, idx, planes, err, scale)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("budget,margin", [(1e-3, 0.25), (1e-2, 0.5),
                                           (1e-5, 1.0)])
@pytest.mark.parametrize("code", [2, 4])
def test_decision_logs_equal_reference(code, budget, margin, seed):
    jcfg, tcfg = _cfgs(code)
    lossless = [("p_prev", "R", 1)]
    ctrls = (jrc.RateController(jcfg, mode="adaptive", error_budget=budget,
                                margin=margin, lossless=lossless),
             trc.RateController(tcfg, mode="adaptive", error_budget=budget,
                                margin=margin, lossless=lossless))
    rng = np.random.default_rng(seed)
    for sweep in range(1, 6):
        _observe_all(ctrls, tcfg, rng, lossless_share=0.2)
        changed = [c.decide(sweep) for c in ctrls]
        assert changed[0] == changed[1]
        assert ctrls[1].state_dict() == ctrls[0].state_dict()
    for name in tcfg.fields:
        for kind, idx, _ in tcfg.plan.units():
            for sweep in range(7):
                assert (ctrls[1].rate_for(name, kind, idx, sweep)
                        == ctrls[0].rate_for(name, kind, idx, sweep))
    assert (ctrls[1].rate_histogram(tcfg.plan, 5)
            == ctrls[0].rate_histogram(jcfg.plan, 5))
    back = trc.RateController.from_state(tcfg, ctrls[0].state_dict())
    assert back.state_dict() == ctrls[0].state_dict()


@pytest.mark.parametrize("planes", [1, 4, 8, 12, 16, 27, 28, 32])
@pytest.mark.parametrize("scale", [0.0, 1e-30, 3e-5, 0.7, 1.0, 1234.5])
def test_analytic_bound_equals_reference(planes, scale):
    assert (trc._analytic_bound(scale, planes, 3, "float32")
            == jrc._analytic_bound(scale, planes, 3, "float32"))


def test_float64_bound_raises_not_guesses():
    """The float64 bound reads the float64 codec's constants (_FRAC 55,
    width 64), so it is the reference's and no guess; a type the codec
    does not take raises."""
    assert (trc._analytic_bound(1.0, 24, 3, "float64")
            == jrc._analytic_bound(1.0, 24, 3, "float64"))
    # the paper's 24/64 against its float32 equivalent 12/32
    assert (trc._analytic_bound(1.0, 24, 3, "float64")
            < trc._analytic_bound(1.0, 12, 3, "float32"))
    with pytest.raises(TypeError, match="float16"):
        trc._analytic_bound(1.0, 12, 3, "float16")


@pytest.mark.parametrize("planes", [1, 4, 12, 24, 32, 40, 59, 60, 64])
@pytest.mark.parametrize("scale", [0.0, 1e-300, 3e-5, 0.7, 1.0, 1234.5])
def test_float64_analytic_bound_equals_reference(planes, scale):
    assert (trc._analytic_bound(scale, planes, 3, "float64")
            == jrc._analytic_bound(scale, planes, 3, "float64"))


def test_labels_and_validation_equal_reference():
    _, tcfg = _cfgs()
    for r in (None, 1, 12, 32):
        assert trc.rate_label(r) == jrc.rate_label(r)
    assert trc.DEFAULT_LADDER == jrc.DEFAULT_LADDER
    assert trc.RateController(tcfg, ladder=[16, 8, 8]).ladder == (8, 16)
    for kw in (dict(mode="nope"), dict(ladder=[0, 8]), dict(margin=0.0)):
        with pytest.raises(ValueError):
            trc.RateController(tcfg, **kw)


def _initial():
    p_cur = stencil_ref.ricker_source(SHAPE).numpy()
    return 0.95 * p_cur, p_cur, np.full(SHAPE, 0.07, np.float32)


def test_fixed_mode_sync_engine_bit_identical():
    _, cfg = _cfgs()
    plain = tooc.OutOfCoreWave(cfg, *_initial())
    fixed = tooc.OutOfCoreWave(cfg, *_initial(),
                               rates=trc.RateController(cfg, mode="fixed"))
    for eng in (plain, fixed):
        eng.run(3 * cfg.bt)
    assert fixed.transfer_summary() == plain.transfer_summary()
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(fixed.gather(name), plain.gather(name))


def test_adaptive_sync_engine_matches_reference_log():
    """The sync engines of both packages, adaptive from the same
    fields: the same decision log and wire bytes (the codec is exact
    between them; the stencil drifts a few ulps, which moves no rate
    decision at these margins)."""
    jcfg, tcfg = _cfgs()
    fields = _initial()
    jeng = jooc.OutOfCoreWave(
        jcfg, *fields,
        rates=jrc.RateController(jcfg, mode="adaptive", error_budget=1e-2))
    teng = tooc.OutOfCoreWave(
        tcfg, *fields,
        rates=trc.RateController(tcfg, mode="adaptive", error_budget=1e-2))
    for eng in (jeng, teng):
        eng.run(4 * tcfg.bt)
    assert teng.rates._maps == jeng.rates._maps
    assert teng.rates._starts == jeng.rates._starts
    assert teng.transfer_summary() == jeng.transfer_summary()

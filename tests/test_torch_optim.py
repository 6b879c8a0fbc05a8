"""The port's AdamW and LR schedule against ``repro.optim`` on the same
numpy inputs.

Tolerances: the schedule within 1e-6 relative (float32 ``cos`` in XLA
and PyTorch may differ by an ulp); an AdamW update within rtol 1e-6 /
atol 2e-8 on parameters and moments and 1e-6 on the gradient norm (the
global norm's float32 sum runs in another order, so a clipped step's
scale may differ by an ulp; that moves a first moment of magnitude ~0.06
by up to two of its ulps, 7.5e-9, which is large relative to the moments
that a step brings near zero; everything else is elementwise in the
reference's order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import schedule as JS
from repro_torch.optim import adamw as TA
from repro_torch.optim import schedule as TS

SCHED = dict(peak_lr=3e-4, warmup=7, total=40)


@pytest.mark.parametrize("step", [0, 1, 3, 6, 7, 8, 20, 39, 40, 55])
def test_warmup_cosine_matches_reference(step):
    want = float(JS.warmup_cosine(jnp.int32(step), **SCHED))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = TS.warmup_cosine(s, **SCHED)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(want, rel=1e-6, abs=0)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal(11) * scale).astype(np.float32)}


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (3.0, True)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = JA.init(jp), TA.init(tp)
    assert int(ts.step) == 0 and ts.ef is None
    for i in range(4):
        g = _tree(10 + i, grad_scale)
        lr = float(JS.warmup_cosine(js.step, **SCHED)) + 1e-4
        jp, js, jn = JA.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp, lr=lr)
        out, ts, tn = TA.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp, lr=lr)
        assert out is tp  # updated in place
        assert (float(jn) > 1.0) == clipped
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        assert int(ts.step) == int(js.step) == i + 1
        for k in params:
            for t, j in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                         (ts.v[k], js.v[k])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-6, atol=2e-8)


def test_adamw_init_error_feedback_buffers():
    tp = {k: torch.from_numpy(v) for k, v in _tree(1).items()}
    st = TA.init(tp, error_feedback=True)
    assert st.step.dtype == torch.int32
    for d in (st.m, st.v, st.ef):
        assert list(d) == list(tp)
        assert all(d[k].dtype == torch.float32 and not d[k].any()
                   for k in d)

"""The port's Mamba-1 mixer against ``repro.models.ssm`` on the same
parameters (the reference's falcon-mamba smoke layer, float32, carried
over by ``convert``) and the same numpy inputs.

Tolerances: float32 sums in another order (PyTorch vs XLA matmuls, the
doubling scan vs ``associative_scan``) move values by ~1e-6 here; the
bound is rtol 1e-4 / atol 1e-5, the selective scan's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import model as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_config, smoke
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def layer():
    """Layer 1 of the reference's smoke model: (config, jax leaves, the
    port's ``Mamba1Layer`` holding them)."""
    jcfg, tcfg = jsmoke(jget_config(ARCH)), smoke(get_config(ARCH))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    return tcfg, jl, tp.layers[1]


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_causal_conv_matches_reference(layer):
    _, jl, tl = layer
    x = np.random.default_rng(0).standard_normal((2, 11, 128)).astype(
        np.float32)
    b = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    want = JS.causal_conv(jnp.asarray(x), jl["conv_w"], jnp.asarray(b))
    got = TS.causal_conv(torch.from_numpy(x), tl.conv_w, torch.from_numpy(b))
    _close(got, want)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba1_seq_matches_reference(layer, carried):
    cfg, jl, tl = layer
    x = _x(cfg, 2, 19, seed=3)
    jstate = tstate = None
    if carried:
        rng = np.random.default_rng(4)
        conv = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner))
        h = 0.1 * rng.standard_normal((2, cfg.d_inner, cfg.ssm_state))
        conv, h = conv.astype(np.float32), h.astype(np.float32)
        jstate = JS.MambaState(jnp.asarray(conv), jnp.asarray(h))
        tstate = TS.MambaState(torch.from_numpy(conv), torch.from_numpy(h))
    jy, jst = JS.mamba1_seq(jl, jnp.asarray(x), chunk=cfg.ssm_chunk,
                            state=jstate)
    with torch.no_grad():
        ty, tst = TS.mamba1_seq(tl, torch.from_numpy(x), chunk=cfg.ssm_chunk,
                                state=tstate)
    _close(ty, jy)
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)


def test_split_sequence_carries_state(layer):
    """Running t < 9 and then t >= 9 from the carried state gives the
    whole sequence's outputs and final state."""
    cfg, _, tl = layer
    x = torch.from_numpy(_x(cfg, 2, 23, seed=5))
    with torch.no_grad():
        y_all, st_all = TS.mamba1_seq(tl, x, chunk=cfg.ssm_chunk)
        y1, st1 = TS.mamba1_seq(tl, x[:, :9], chunk=cfg.ssm_chunk)
        y2, st2 = TS.mamba1_seq(tl, x[:, 9:], chunk=cfg.ssm_chunk, state=st1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, **TOL)
    torch.testing.assert_close(st2.h, st_all.h, **TOL)
    torch.testing.assert_close(st2.conv, st_all.conv, rtol=0, atol=0)


def test_h_out_receives_state_in_place(layer):
    cfg, _, tl = layer
    x = torch.from_numpy(_x(cfg, 2, 1, seed=6))
    st0 = TS.mamba1_init_state(tl, 2, torch.float32)
    assert st0.conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    assert st0.h.shape == (2, cfg.d_inner, cfg.ssm_state)
    with torch.no_grad():
        want_y, want = TS.mamba1_seq(tl, x, chunk=cfg.ssm_chunk, state=st0)
        y, st = TS.mamba1_seq(tl, x, chunk=cfg.ssm_chunk, state=st0,
                              h_out=st0.h)
    assert st.h is st0.h
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st0.h, want.h, rtol=0, atol=0)


# ----------------------------------------------------------------------
# Mamba-2 / SSD (the zamba2 smoke layer, float32)
# ----------------------------------------------------------------------

HYB = "zamba2-2.7b"


@pytest.fixture(scope="module")
def layer2():
    """Layer 1 of the reference's zamba2 smoke model: (config, jax
    leaves, the port's ``Mamba2Layer`` holding them)."""
    jcfg, tcfg = jsmoke(jget_config(HYB)), smoke(get_config(HYB))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(9))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    jl = jax.tree.map(lambda a: a[1], jp["layers"])
    return tcfg, jl, tp.layers[1]


def _ssd_inputs(seed, b=2, s=19, h=4, p=8, g=2, n=4, dt_scale=1.0):
    """Seeded SSD inputs as numpy float32: dt = softplus(normal) (times
    ``dt_scale``), a = -exp(0.3 normal), B, C, x normal, h0 0.1 normal."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = (np.log1p(np.exp(f(b, s, h))) * dt_scale).astype(np.float32)
    a = -np.exp(0.3 * f(h)).astype(np.float32)
    return dt, a, f(b, s, g, n), f(b, s, g, n), f(b, s, h, p), \
        (0.1 * f(b, h, p, n)).astype(np.float32)


@pytest.mark.parametrize("chunk", [1, 8])
def test_ssd_chunked_matches_reference(chunk):
    """S = 19 (ragged against chunk 8), two B/C groups over four heads, a
    carried state."""
    args = _ssd_inputs(0)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, args), chunk)
    ty, th = TS.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(ty, jy)
    _close(th, jh)


def test_ssd_chunk_1_equals_chunk_8():
    """Decode runs the chunked form at chunk 1: the same function."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(1)]
    y1, h1 = TS.ssd_chunked(*args, 1)
    y8, h8 = TS.ssd_chunked(*args, 8)
    torch.testing.assert_close(y1, y8, **TOL)
    torch.testing.assert_close(h1, h8, **TOL)


@pytest.mark.parametrize("chunk", [3, 8])
def test_chunked_linear_scan_matches_reference(chunk):
    """a broadcast against b (the reference's ``broadcast_to``), S = 19
    ragged against the chunk, a carried state."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, (2, 19, 1, 4)).astype(np.float32)
    b = rng.standard_normal((2, 19, 3, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    jh, jl = JS.chunked_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0), chunk)
    th, tl = TS.chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(h0), chunk)
    _close(th, jh)
    _close(tl, jl)


def _state2(cfg, seed):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, cfg.d_inner))
    h = 0.1 * rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state))
    return conv.astype(np.float32), h.astype(np.float32)


@pytest.mark.parametrize("carried", [False, True])
def test_mamba2_seq_matches_reference(layer2, carried):
    cfg, jl, tl = layer2
    x = _x(cfg, 2, 19, seed=13)
    kw = dict(chunk=cfg.ssm_chunk, ngroups=cfg.ssm_groups,
              ssm_state=cfg.ssm_state)
    jstate = tstate = None
    if carried:
        conv, h = _state2(cfg, 14)
        jstate = JS.MambaState(jnp.asarray(conv), jnp.asarray(h))
        tstate = TS.MambaState(torch.from_numpy(conv), torch.from_numpy(h))
    jy, jst = JS.mamba2_seq(jl, jnp.asarray(x), state=jstate, **kw)
    with torch.no_grad():
        ty, tst = TS.mamba2_seq(tl, torch.from_numpy(x), state=tstate, **kw)
    _close(ty, jy)
    _close(tst.conv, jst.conv)
    _close(tst.h, jst.h)


def test_mamba2_split_sequence_and_h_out(layer2):
    """t < 9 then t >= 9 from the carried state gives the whole sequence;
    one token from ``mamba2_init_state`` with ``h_out`` writes the state
    in place, equal to the call without it."""
    cfg, _, tl = layer2
    kw = dict(chunk=cfg.ssm_chunk, ngroups=cfg.ssm_groups,
              ssm_state=cfg.ssm_state)
    x = torch.from_numpy(_x(cfg, 2, 23, seed=15))
    st0 = TS.mamba2_init_state(tl, 2, torch.float32, cfg.ssm_state)
    assert st0.conv.shape == (2, cfg.ssm_conv - 1, cfg.d_inner)
    assert st0.h.shape == (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    with torch.no_grad():
        y_all, st_all = TS.mamba2_seq(tl, x, **kw)
        y1, st1 = TS.mamba2_seq(tl, x[:, :9], **kw)
        y2, st2 = TS.mamba2_seq(tl, x[:, 9:], state=st1, **kw)
        want_y, want = TS.mamba2_seq(tl, x[:, :1], state=st0, **kw)
        y, st = TS.mamba2_seq(tl, x[:, :1], state=st0, h_out=st0.h, **kw)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_all, **TOL)
    torch.testing.assert_close(st2.h, st_all.h, **TOL)
    torch.testing.assert_close(st2.conv, st_all.conv, rtol=0, atol=0)
    assert st.h is st0.h
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(st0.h, want.h, rtol=0, atol=0)


def test_ssd_masked_exponent_keeps_the_gradient_finite():
    """B 2, S 64, H 4, P 16, N 8, one chunk of 64, dt in [0.5, 2] and a
    in [-4, -2]: a chunk decays by hundreds of nats, so above the
    diagonal the reference's ``exp(ldiff)`` overflows. Both forwards are
    finite and equal; ``jax.grad`` of the reference's with respect to dt
    is NaN everywhere, the port's is finite (``models/ssm.py``'s
    docstring)."""
    rng = np.random.default_rng(5)
    b, s, h, p, n = 2, 64, 4, 16, 8
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = rng.uniform(0.5, 2.0, (b, s, h)).astype(np.float32)
    a = rng.uniform(-4.0, -2.0, (h,)).astype(np.float32)
    rest = (f(b, s, 1, n), f(b, s, 1, n), f(b, s, h, p),
            np.zeros((b, h, p, n), np.float32))
    jrest = [jnp.asarray(t) for t in rest]

    def jloss(d):
        y, hl = JS.ssd_chunked(d, jnp.asarray(a), *jrest, s)
        return jnp.sum(y) + jnp.sum(hl)

    jy, jh = JS.ssd_chunked(jnp.asarray(dt), jnp.asarray(a), *jrest, s)
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, th = TS.ssd_chunked(tdt, torch.from_numpy(a),
                            *map(torch.from_numpy, rest), s)
    (tg,) = torch.autograd.grad(ty.sum() + th.sum(), tdt)
    assert np.isfinite(np.asarray(jy)).all() and np.isfinite(
        np.asarray(jh)).all()
    _close(ty, jy)
    _close(th, jh)
    assert jg.size == 512 and np.isnan(jg).all()
    assert torch.isfinite(tg).all() and float(tg.abs().max()) > 0

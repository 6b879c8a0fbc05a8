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

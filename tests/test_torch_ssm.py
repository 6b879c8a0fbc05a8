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


# ----------------------------------------------------------------------
# the selective scan's gradient (training the ssm family)
# ----------------------------------------------------------------------

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # the scan's own bound


def _scan_inputs(b, s, d, n, seed):
    """(dt, a, b_in, c_in, x, h0) and the cotangents (gy, gh), numpy
    float32, dt and a as the model draws them (softplus, -exp)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, d) - 2.0)).astype(np.float32)
    a = -np.exp(0.3 * f(d, n)).astype(np.float32)
    return (dt, a, f(b, s, n), f(b, s, n), f(b, s, d), 0.1 * f(b, d, n)), \
        (f(b, s, d), f(b, d, n))


@pytest.mark.parametrize("n", [16, 8])
def test_selective_scan_gradients_match_reference(n):
    """Every input's gradient of ``y`` and ``h_last`` under cotangents
    (gy, gh) against ``jax.grad`` of ``repro``'s XLA form
    ``chunked_selective_scan``: B 2, S 37 (ragged against the chunk of
    8), D 24, within the scan's rtol 1e-4 / atol 1e-5."""
    from repro_torch.kernels.sscan import ops as sscan_ops

    ins, (gy, gh) = _scan_inputs(2, 37, 24, n, seed=n)

    def jloss(*t):
        y, h = JS.chunked_selective_scan(*t, 8)
        return jnp.sum(y * gy) + jnp.sum(h * gh)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    tins = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y, h = sscan_ops.selective_scan(*tins, chunk=8)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (h * torch.from_numpy(gh)).sum(),
        tins)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_scan_gradcheck_in_float64():
    """``torch.autograd.gradcheck`` of the plain version (the backward
    kernel's oracle) in float64, ragged S 9 against chunk 4."""
    from repro_torch.kernels.sscan import ref as sscan_ref

    ins, _ = _scan_inputs(1, 9, 3, 4, seed=3)
    tins = [torch.from_numpy(t).double().requires_grad_(True) for t in ins]
    assert torch.autograd.gradcheck(
        lambda *t: sscan_ref.selective_scan_ref(*t, 4), tins)


def test_scan_function_runs_its_plain_versions_on_cpu():
    """``SelectiveScan`` (the card's autograd route) on CPU tensors: its
    forward's checkpoints are ``ref.boundary_states`` (the state before
    every ``SAVE_EVERY`` steps, equal to the float64 recurrence's) and
    its backward ``kernel.selective_scan_bwd``'s plain version; both
    give what autograd of the plain scan gives, bit for bit."""
    from repro_torch.kernels.sscan import kernel as sscan_kernel
    from repro_torch.kernels.sscan import ops as sscan_ops
    from repro_torch.kernels.sscan import ref as sscan_ref

    ins, (gy, gh) = _scan_inputs(2, 37, 24, 16, seed=4)
    t = [torch.from_numpy(a) for a in ins]
    states = torch.empty(sscan_kernel.states_shape(2, 37, 24, 16))
    y, h = sscan_kernel.selective_scan(*t, chunk=8, states_out=states)
    every = sscan_kernel.SAVE_EVERY
    assert states.shape == (2, 3, 24, 16)
    assert torch.equal(states[:, 0], t[5])
    for k in (1, 2):
        _, hk = sscan_ref.selective_scan_f64(
            *(a[:, :k * every] if a.dim() == 3 and a.shape[1] == 37 else a
              for a in t))
        np.testing.assert_allclose(states[:, k].numpy(), hk.numpy(), **TOL)
    tins = [a.clone().requires_grad_(True) for a in t]
    y, h = sscan_ops.SelectiveScan.apply(*tins)
    tg, th = torch.from_numpy(gy), torch.from_numpy(gh)
    got = torch.autograd.grad((y * tg).sum() + (h * th).sum(), tins)
    want = sscan_ref.selective_scan_bwd_ref(*t, tg, th, 37)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cuda_constants():
    """The integer ``constexpr``s of ``csrc/sscan.cu`` that are literals or
    products, sums and quotients of earlier ones (by name)."""
    import ast
    import re
    from pathlib import Path

    from repro_torch.kernels.sscan import kernel as sscan_kernel

    src = Path(sscan_kernel.__file__).resolve().parents[2] / "csrc" / \
        "sscan.cu"
    ops = {ast.Mult: lambda a, b: a * b, ast.Add: lambda a, b: a + b,
           ast.Sub: lambda a, b: a - b, ast.FloorDiv: lambda a, b: a // b,
           ast.Div: lambda a, b: a // b}
    known = {}

    def value(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return known[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in ops:
            return ops[type(node.op)](value(node.left), value(node.right))
        raise KeyError(ast.dump(node))

    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 src.read_text()):
        try:
            known[name] = value(ast.parse(expr, mode="eval").body)
        except (KeyError, SyntaxError):
            pass  # a template's own constant
    return known


def test_scan_wrapper_constants_are_the_cuda_sources():
    """The wrapper sizes the checkpoints and the backward's scratch from
    ``MAX_STATE``, ``SAVE_EVERY`` and ``BWD_CHANNELS``: each is its
    ``constexpr`` in ``csrc/sscan.cu`` (``kMaxN``, ``kStage``,
    ``kBwdGroup``), so a redesign that changes one there and not here
    fails on the CPU too (on the card the wrapper also checks the built
    library's getters at first bind)."""
    from repro_torch.kernels.sscan import kernel as sscan_kernel

    consts = _cuda_constants()
    assert consts["kMaxN"] == sscan_kernel.MAX_STATE
    assert consts["kStage"] == sscan_kernel.SAVE_EVERY
    assert consts["kBwdGroup"] == sscan_kernel.BWD_CHANNELS
    # one partial a CTA of the backward: 8 channels a warp
    assert consts["kBwdGroup"] == 8 * consts["kBwdWarps"]


@pytest.mark.parametrize("getter", ["sscan_max_state", "sscan_save_every",
                                    "sscan_bwd_channels"])
def test_scan_wrapper_refuses_a_library_of_other_extents(monkeypatch,
                                                         getter):
    """At first bind the wrapper asks the library for each extent it sizes
    scratch by and raises ``KernelError`` on a mismatch, before any
    launch (here a stand-in library whose ``getter`` is off by one)."""
    from repro_torch import _build
    from repro_torch.kernels.sscan import kernel as sscan_kernel

    class Getter:
        def __init__(self, value):
            self.value = value

        def __call__(self):
            return self.value

    class Library:
        pass

    lib = Library()
    for const, name in sscan_kernel._GETTERS:
        value = getattr(sscan_kernel, const)
        setattr(lib, name, Getter(value + (name == getter)))
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(sscan_kernel, "_checked", [])
    with pytest.raises(_build.KernelError, match=getter):
        sscan_kernel._bind("sscan_backward", sscan_kernel._BWD_ARGS)


def test_h_out_takes_no_gradient():
    """The serving cache's in-place ``h_out`` refuses a scan that needs
    a gradient; without one it is written as before."""
    from repro_torch.kernels.sscan import ops as sscan_ops

    ins, _ = _scan_inputs(1, 5, 4, 8, seed=6)
    t = [torch.from_numpy(a) for a in ins]
    h_out = torch.zeros_like(t[5])
    with pytest.raises(ValueError, match="no gradient"):
        sscan_ops.selective_scan(t[0].requires_grad_(True), *t[1:],
                                 chunk=4, h_out=h_out)
    t[0].requires_grad_(False)
    _, h = sscan_ops.selective_scan(*t, chunk=4, h_out=h_out)
    assert h is h_out and float(h_out.abs().max()) > 0


def test_mamba1_seq_gradients_match_reference(layer):
    """The whole Mamba-1 mixer's gradients (every weight it reads, ``A_log``
    through ``a = -exp(A_log)`` outside the scan, and the input) against
    ``jax.grad`` of ``repro``'s ``mamba1_seq``, S 37, chunk 8."""
    cfg, jl, tl = layer
    x = _x(cfg, 2, 37, seed=9)
    gy = np.random.default_rng(10).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = JS.mamba1_seq(p, xx, chunk=8)
        return jnp.sum(y * gy)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(x))
    names = [n for n, _ in tl.named_parameters() if n != "ln1"]
    params = [getattr(tl, n).detach().clone().requires_grad_(True)
              for n in names]
    lp = dict(zip(names, params))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = TS.mamba1_seq(type("P", (), lp), tx, chunk=8)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum(),
                              params + [tx])
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]),
                                   err_msg=name, **GRAD_TOL)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(jgx), **GRAD_TOL)

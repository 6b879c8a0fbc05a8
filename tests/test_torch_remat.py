"""The port's compressed activation checkpointing against
``repro.core.remat``.

``compress_tree``'s payloads and exponents are bit for bit the
reference's on the same inputs (the codec is exact integer arithmetic).
``compressed_checkpoint``'s gradients are held to the reference's within
1e-5 of their norm (both differentiate the same decoded residuals; XLA
and PyTorch sum the float32 products in another order) and to the exact
gradients below 5e-3 relative at 16 planes, the bound of
``tests/test_substrate.py::test_compressed_remat_close_to_exact``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import remat as JR
from repro_torch.core import remat as TR

N = 64


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, N)).astype(np.float32)
    w = (rng.standard_normal((N, N)) * 0.1).astype(np.float32)
    return x, w


def _jf(x, w):
    return jnp.sum(jnp.sin(jnp.tanh(x @ w)) ** 2)


def _tf(x, w):
    return torch.sum(torch.sin(torch.tanh(x @ w)) ** 2)


def _u32(a):
    return np.asarray(a).view(np.uint32) if isinstance(a, np.ndarray) else \
        a.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("planes", [8, 12, 16])
def test_compress_tree_bitwise(planes):
    rng = np.random.default_rng(planes)
    tree = (rng.standard_normal((2, 7, 9)).astype(np.float32),
            {"w": rng.standard_normal(130).astype(np.float32),
             "small": rng.standard_normal(63).astype(np.float32)},
            np.arange(100, dtype=np.int32))
    jt = JR.compress_tree(jax.tree.map(jnp.asarray, tree), planes)
    tt = TR.compress_tree((torch.from_numpy(tree[0]),
                           {k: torch.from_numpy(v) for k, v in
                            tree[1].items()},
                           torch.from_numpy(tree[2])), planes)
    pairs = [(jt[0], tt[0]), (jt[1]["w"], tt[1]["w"])]
    for j, t in pairs:
        assert isinstance(t, TR.ZfpResidual) and t.shape == tuple(j.shape)
        np.testing.assert_array_equal(_u32(t.comp.payload),
                                      np.asarray(j.comp.payload))
        np.testing.assert_array_equal(t.comp.emax.numpy(),
                                      np.asarray(j.comp.emax))
        np.testing.assert_array_equal(t.restore().numpy(),
                                      np.asarray(j.restore()))
    # leaves under 64 values and integer leaves stay raw
    assert isinstance(tt[1]["small"], torch.Tensor)
    assert isinstance(tt[2], torch.Tensor)
    back = TR.decompress_tree(tt)
    assert back[0].shape == (2, 7, 9) and back[2] is tt[2]


def test_compressed_checkpoint_gradients():
    x, w = map(jnp.asarray, _inputs())
    fc = JR.compressed_checkpoint(_jf, planes=16)
    g_exact = jax.grad(_jf, argnums=(0, 1))(x, w)
    g_ref = jax.grad(lambda a, b: fc(a, b), argnums=(0, 1))(x, w)
    tx = torch.from_numpy(np.array(x)).requires_grad_()
    tw = torch.from_numpy(np.array(w)).requires_grad_()
    out = TR.compressed_checkpoint(_tf, planes=16)(tx, tw)
    assert float(out.detach()) == float(_tf(tx, tw).detach())  # the forward runs fn exactly
    g = torch.autograd.grad(out, (tx, tw))
    for gt, gr, ge in zip(g, g_ref, g_exact):
        gt, gr, ge = gt.numpy(), np.asarray(gr), np.asarray(ge)
        assert np.linalg.norm(gt - gr) / np.linalg.norm(gr) < 1e-5
        assert np.linalg.norm(gt - ge) / np.linalg.norm(ge) < 5e-3


def test_compressed_checkpoint_tuple_outputs_and_raw_inputs():
    """A function of several outputs, one input too small to code and
    one that needs no gradient: gradients flow to what asks for them."""
    x, w = _inputs(4)
    b = torch.from_numpy(x[0, :8].copy()).requires_grad_()  # 8 values, raw
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()

    def fn(x, w, b):
        h = torch.tanh(x @ w)
        return h + b.sum(), (h * h).sum()

    a, s = TR.compressed_checkpoint(fn, planes=32)(tx, tw, b)
    ga = torch.autograd.grad(a.sum() + s, (tw, b))
    qx = TR.decompress_tree(TR.compress_tree(tx, 32))
    qw = TR.decompress_tree(TR.compress_tree(tw.detach(), 32))
    qw.requires_grad_()
    b2 = b.detach().clone().requires_grad_()
    a2, s2 = fn(qx, qw, b2)
    want = torch.autograd.grad(a2.sum() + s2, (qw, b2))
    for got, exp in zip(ga, want):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)


def test_reference_compressed_remat_saves_compressed_weights():
    """Reference caveat (ROADMAP.md §3): ``compressed_checkpoint`` codes
    every argument, the weights too, so the backward pass differentiates
    at the weights' round trip, not at the weights. The reference's
    gradient is exactly the one taken at (q(x), q(w)), and not the one at
    (q(x), w); the port keeps that behaviour."""
    x, w = map(jnp.asarray, _inputs(5))
    planes = 8
    q = lambda a: np.array(JR.decompress_tree(
        JR.compress_tree(jnp.asarray(a), planes)))
    fc = JR.compressed_checkpoint(_jf, planes=planes)
    g_ref = jax.grad(lambda a, b: fc(a, b), argnums=1)(x, w)
    at_both = jax.grad(_jf, argnums=1)(q(x), q(w))
    at_x_only = jax.grad(_jf, argnums=1)(q(x), w)
    np.testing.assert_array_equal(np.asarray(g_ref), np.asarray(at_both))
    assert not np.array_equal(np.asarray(g_ref), np.asarray(at_x_only))
    tw = torch.from_numpy(np.array(w)).requires_grad_()
    g_port = torch.autograd.grad(TR.compressed_checkpoint(
        _tf, planes=planes)(torch.from_numpy(np.array(x)), tw), tw)[0]
    qw = torch.from_numpy(q(w)).requires_grad_()
    want = torch.autograd.grad(_tf(torch.from_numpy(q(x)), qw), qw)[0]
    torch.testing.assert_close(g_port, want, rtol=0, atol=0)

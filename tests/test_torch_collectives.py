"""The port's compressed gradients against
``repro.distributed.collectives``, bit for bit, on the same numpy
gradients: the codec at ndim 1 is exact integer arithmetic on both
sides, and the error-feedback sums are single float32 additions.

The reference quantizes its stacked ``(L, ...)`` leaves; the port's
gradients come per layer (``Model.named_parameters()`` names) and must
give the stack's numbers (including a stack that reaches 64 values only
with both layers, and pieces whose length is not a multiple of 4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro.optim import adamw as JA
from repro_torch.distributed import collectives as TC
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.optim import adamw as TA

# per-layer shapes; two layers stack each into (2, ...)
LAYER_SHAPES = {"wq": (8, 12), "bk": (32,), "odd": (5, 7), "tiny": (5,)}
TOP_SHAPES = {"embed": (20, 8), "final_norm": (8,)}


def _grads(seed, scale=1.0):
    """(reference tree, port mapping) of the same gradients."""
    rng = np.random.default_rng(seed)
    stack = {k: (rng.standard_normal((2,) + s) * scale).astype(np.float32)
             for k, s in LAYER_SHAPES.items()}
    top = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in TOP_SHAPES.items()}
    tree = {"layers": stack, **top}
    flat = {}
    for k in top:
        flat[k] = torch.from_numpy(top[k].copy())
    for i in range(2):
        for k in stack:
            flat[f"layers.{i}.{k}"] = torch.from_numpy(stack[k][i].copy())
    return tree, flat


def _check(tree, flat):
    for k, v in flat.items():
        if k.startswith("layers."):
            _, i, leaf = k.split(".")
            want = np.asarray(tree["layers"][leaf])[int(i)]
        else:
            want = np.asarray(tree[k])
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)


@pytest.mark.parametrize("shape", [(64,), (4097,), (3, 5, 7), (63,)])
@pytest.mark.parametrize("planes", [8, 12, 16])
def test_quantize_leaf_bitwise(shape, planes):
    g = (np.random.default_rng(len(shape)).standard_normal(shape)
         * 1e-3).astype(np.float32)
    want = np.asarray(JC.quantize_leaf(jnp.asarray(g), planes))
    got = TC.quantize_leaf(torch.from_numpy(g), planes)
    assert got.shape == g.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if g.size < 64:
        np.testing.assert_array_equal(got.numpy(), g)


def test_quantize_leaf_passes_integers():
    t = torch.arange(100, dtype=torch.int32)
    assert TC.quantize_leaf(t, 8) is t


@pytest.mark.parametrize("error_feedback", [False, True])
def test_compress_grads_eight_steps_bitwise(error_feedback):
    jtree, tflat = _grads(0)
    jstate = JA.init(jax_tree(jtree), error_feedback=error_feedback)
    tstate = TA.init(tflat, error_feedback=error_feedback)
    for step in range(8):
        jg, tg = _grads(step + 1, scale=10.0 ** (-step % 4))
        jq, jstate = JC.compress_grads(jax_tree(jg), jstate, planes=8)
        tq, tstate = TC.compress_grads(tg, tstate, planes=8)
        assert list(tq) == list(tg)
        _check(jq, tq)
        if error_feedback:
            _check(jstate.ef, tstate.ef)
        else:
            assert tstate.ef is None


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("planes", [4, 8, 12, 16, 32])
def test_wire_ratio_matches_reference(planes):
    assert TC.wire_ratio(planes) == JC.wire_ratio(planes)
    assert TC.wire_ratio(planes, 16) == JC.wire_ratio(planes, 16)


@pytest.mark.parametrize("ndim,shape", [(1, (4097,)), (2, (9, 13)),
                                        (3, (6, 7, 9))])
def test_quantize_backends(ndim, shape):
    """``quantize`` is ``decode(encode(x))``; ``backend="cuda"`` refuses
    a CPU tensor rather than running the plain codec."""
    x = torch.from_numpy((np.random.default_rng(ndim).standard_normal(shape)
                          * 5).astype(np.float32))
    q = zfp_ops.quantize(x, planes=12, ndim=ndim)
    rt = zfp_ops.decompress(zfp_ops.compress(x, planes=12, ndim=ndim))
    np.testing.assert_array_equal(q.numpy(), rt.numpy())
    with pytest.raises(ValueError, match="CUDA tensors"):
        zfp_ops.quantize(x, planes=12, ndim=ndim, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        zfp_ops.quantize(x, planes=12, ndim=ndim, backend="pallas")

"""Port stencil (``repro_torch.kernels.stencil``) against the JAX
reference.

Contract: the port's plain version is bit for bit equal to the JAX
eager reference (``laplacian8``, ``wave_step``, ``ladder_steps``,
``run_steps``) on the same float32 input. Against the JAX jitted path
the engines call (``ops.fused_temporal_steps``) it agrees within
``JIT_ATOL``: XLA fuses and re-rounds, so the two differ by a few ulps.

float64, the TPU kernels' other type (their outputs take ``p_cur``'s
dtype): the plain version is bit for bit the JAX eager reference under
``jax_enable_x64`` (on inside ``_x64``, restored in its ``finally``).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil import kernel as jkernel
from repro.kernels.stencil import ops as jops
from repro.kernels.stencil import ref as jref
from repro_torch.kernels.stencil import kernel as tkernel
from repro_torch.kernels.stencil import ops as tops
from repro_torch.kernels.stencil import ref as tref

# measured max |diff| between jitted and eager 4-step ladders on
# unit-normal fields is ~1.4e-6; 1e-5 leaves margin, a real fault
# (wrong coefficient, neighbour or order) shows as O(1e-2) or more
JIT_ATOL = 1e-5


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    pp = rng.standard_normal(shape).astype(np.float32)
    pc = rng.standard_normal(shape).astype(np.float32)
    v2 = (0.05 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return pp, pc, v2


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_constants_equal():
    assert tref.HALO == jref.HALO
    assert tref.C0 == jref.C0 and tref.C == jref.C


@pytest.mark.parametrize("shape", [(8, 8, 8), (13, 21, 37), (6, 40, 9)])
def test_laplacian_and_wave_step_bitwise(shape):
    pp, pc, v2 = _fields(shape, sum(shape))
    ppp, pcp = np.pad(pp, 4), np.pad(pc, 4)
    np.testing.assert_array_equal(
        tref.laplacian8(torch.from_numpy(pcp)).numpy(),
        np.asarray(jref.laplacian8(jnp.asarray(pcp))))
    tn, tl = tref.wave_step(*_t(ppp, pcp, v2))
    jn, jl = jref.wave_step(*_j(ppp, pcp, v2))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        tref.pad_bc(torch.from_numpy(pp)).numpy(), ppp)


@pytest.mark.parametrize("steps", [1, 2, 4])
def test_ladder_and_run_steps_bitwise(steps):
    pp, pc, v2 = _fields((12, 16, 10), steps)
    tp, tc = tref.ladder_steps(*_t(pp, pc, v2), steps)
    jp, jc = jref.ladder_steps(*_j(pp, pc, v2), steps)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    rp, rc = tref.run_steps(*_t(pp, pc, v2), steps)
    np.testing.assert_array_equal(rp.numpy(), tp.numpy())
    np.testing.assert_array_equal(rc.numpy(), tc.numpy())


@pytest.mark.parametrize("steps", [2, 4])
def test_fused_temporal_steps_within_jit_bound(steps):
    shape = (16, 8 * steps, 8)
    pp, pc, v2 = _fields(shape, 10 + steps)
    tp, tc = tops.fused_temporal_steps(*_t(pp, pc, v2), steps=steps)
    jp, jc = jops.fused_temporal_steps(*_j(pp, pc, v2), steps=steps)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=JIT_ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=JIT_ATOL)


def test_multistep_plain_version_matches_pallas_interpret():
    """The JAX multistep kernel (interpret mode) on a y-tiled volume
    against the port's multistep wrapper, which on a CPU tensor runs
    the plain ladder. The JAX kernel is bitwise equal to its per-tile
    ladder; against the untiled ladder it agrees within JIT_ATOL."""
    steps = 2
    pp, pc, v2 = _fields((16, 16, 8), 3)
    jp, jc = jkernel.wave_multistep_pallas(*_j(pp, pc, v2), steps=steps,
                                           interpret=True)
    tp, tc = tkernel.wave_multistep(*_t(pp, pc, v2), steps)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=JIT_ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=JIT_ATOL)


def test_single_step_plain_version_matches_pallas_interpret():
    pp, pc, v2 = _fields((8, 8, 12), 4)
    ppp, pcp = np.pad(pp, 4), np.pad(pc, 4)
    jn, jl = jkernel.wave_step_pallas(*_j(ppp, pcp, v2), interpret=True)
    tn, tl = tkernel.wave_step(*_t(ppp, pcp, v2))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                               atol=JIT_ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=JIT_ATOL)


def test_dispatch_rule():
    """The reference's rule (ops.py:105-113) without its interpret
    clause: multistep on the CUDA backend for steps > 1 when
    steps * HALO divides Y."""
    assert tops.uses_multistep("cuda", 12, 1152)
    assert tops.uses_multistep("cuda", 2, 16)
    assert not tops.uses_multistep("cuda", 1, 1152)
    assert not tops.uses_multistep("cuda", 12, 1150)
    assert not tops.uses_multistep("cuda", 5, 16)
    assert not tops.uses_multistep("ref", 12, 1152)


def test_ladder_fallback_equals_temporal_steps():
    pp, pc, v2 = _fields((16, 16, 8), 7)
    a = tops.fused_temporal_steps(*_t(pp, pc, v2), steps=2)
    b = tops.temporal_steps(*_t(pp, pc, v2), steps=2)
    c = tref.ladder_steps(*_t(pp, pc, v2), 2)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(x.numpy(), z.numpy())


@pytest.mark.parametrize("steps", [0, 1, 5])
def test_multistep_on_cpu_is_the_ladder(steps):
    """On a CPU tensor the multistep wrapper is the plain ladder and
    leaves its inputs as they were."""
    arrays = _fields((9, 10, 11), 5)
    pp, pc, v2 = _t(*arrays)
    got = tkernel.wave_multistep(pp, pc, v2, steps)
    for g, w in zip(got, tref.ladder_steps(pp, pc, v2, steps)):
        assert torch.equal(g, w)
    for t, a in zip((pp, pc, v2), _fields((9, 10, 11), 5)):
        np.testing.assert_array_equal(t.numpy(), a)


def test_ricker_source_within_float_tolerance():
    shape = (20, 24, 28)
    t = tref.ricker_source(shape).numpy()
    j = np.asarray(jref.ricker_source(shape))
    # exp differs by an ulp or so between the two libraries
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_cuda_backend_on_cpu_tensors_raises():
    pp, pc, v2 = _t(*_fields((8, 8, 8), 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.fused_temporal_steps(pp, pc, v2, steps=2, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tops.wave_step(tref.pad_bc(pp), tref.pad_bc(pc), v2,
                       backend="pallas")


@contextlib.contextmanager
def _x64():
    """``jax_enable_x64`` on inside, and back to the value it had."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _fields64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape), rng.standard_normal(shape),
            0.05 + 0.01 * rng.standard_normal(shape))


def _bits64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("shape", [(8, 8, 8), (13, 21, 37)])
def test_f64_wave_step_bitwise(shape):
    pp, pc, v2 = _fields64(shape, sum(shape))
    ppp, pcp = np.pad(pp, 4), np.pad(pc, 4)
    tn, tl = tref.wave_step(*_t(ppp, pcp, v2))
    with _x64():
        jn, jl = jref.wave_step(*_j(ppp, pcp, v2))
        assert jn.dtype == jnp.float64
        jn, jl = np.asarray(jn), np.asarray(jl)
    assert tn.dtype == tl.dtype == torch.float64
    np.testing.assert_array_equal(_bits64(tn), _bits64(jn))
    np.testing.assert_array_equal(_bits64(tl), _bits64(jl))
    # the single-step wrapper on CPU tensors is the plain version
    kn, kl = tkernel.wave_step(*_t(ppp, pcp, v2))
    assert torch.equal(kn, tn) and torch.equal(kl, tl)


@pytest.mark.parametrize("steps", [1, 3])
def test_f64_ladder_bitwise(steps):
    pp, pc, v2 = _fields64((12, 16, 10), 40 + steps)
    tp, tc = tref.ladder_steps(*_t(pp, pc, v2), steps)
    with _x64():
        jp, jc = (np.asarray(a)
                  for a in jref.ladder_steps(*_j(pp, pc, v2), steps))
    np.testing.assert_array_equal(_bits64(tp), _bits64(jp))
    np.testing.assert_array_equal(_bits64(tc), _bits64(jc))
    kp, kc = tkernel.wave_multistep(*_t(pp, pc, v2), steps)
    assert torch.equal(kp, tp) and torch.equal(kc, tc)
    # the engines' entry point on the plain backend
    fp, fc = tops.fused_temporal_steps(*_t(pp, pc, v2), steps=steps)
    assert torch.equal(fp, tp) and torch.equal(fc, tc)


def test_f64_ricker_source_within_float_tolerance():
    shape = (20, 24, 28)
    t = tref.ricker_source(shape, dtype=torch.float64).numpy()
    with _x64():
        j = np.asarray(jref.ricker_source(shape, dtype=jnp.float64))
    assert t.dtype == j.dtype == np.float64
    # exp differs by an ulp or so between the two libraries
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-14)

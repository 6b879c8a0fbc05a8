"""The float64 stencil kernels' launch geometry and CPU route
(``repro_torch.kernels.stencil.kernel``), without a card.

The float64 kernels (``csrc/stencil64.cu``) split Z into chunks of
``z_chunk`` planes, one CTA a (tile, chunk); the C entry points take the
chunk length and launch ``ceil(Z / zlen)`` chunks, the chunk ``i``
covering ``[i * zlen, min(Z, (i + 1) * zlen))``. These tests hold the
choice to that contract: every plane in exactly one chunk, one chunk
where the tiles alone fill the card, and at the precision tier's small
volume every SM busy in one wave of the CTAs the card holds at once (an
H100's 132 SMs x the 2 CTAs an SM that the kernels' registers and shared
memory allow). On a CPU tensor the wrappers are the plain version
and launch nothing; that version is held against ``repro``'s multistep
Pallas kernel in interpret mode under ``jax_enable_x64``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stencil import kernel as jkernel
from repro_torch.kernels.stencil import kernel as tkernel
from repro_torch.kernels.stencil import ref as tref
from test_torch_stencil import _x64

H100_SMS = 132
H100_SLOTS = 2 * H100_SMS  # stencil64_ctas_per_sm on the H100: 2
PAPER_BLOCK = (240, 1152, 1152)  # the bt 12 engine's fetched block
PREC_SHAPE = (192, 96, 96)  # the precision tier's blocks (chip_smoke.py 5p)


def _chunks(z, zlen):
    """The chunks the C entry points launch for ``zlen``."""
    n = -(-z // zlen)
    return [(i * zlen, min(z, (i + 1) * zlen)) for i in range(n)]


def _ctas(shape, slots):
    z, y, x = shape
    ty, tx = tkernel.TILE64
    return -(-y // ty) * -(-x // tx) * len(
        _chunks(z, tkernel.z_chunk(z, y, x, slots)))


@pytest.mark.parametrize("y,x,slots", [(96, 96, H100_SLOTS),
                                       (1152, 1152, H100_SLOTS),
                                       (16, 32, H100_SLOTS), (5, 6, 1),
                                       (48, 24, 3 * 114), (576, 576, 132)])
def test_z_chunk_covers_every_plane_once(y, x, slots):
    for z in range(1, 301):
        zlen = tkernel.z_chunk(z, y, x, slots)
        chunks = _chunks(z, zlen)
        planes = [p for z0, z1 in chunks for p in range(z0, z1)]
        assert planes == list(range(z)), (z, zlen)
        assert all(z1 > z0 for z0, z1 in chunks), (z, zlen)
        # no chunk length below MIN_ZLEN unless Z itself is shorter
        assert zlen >= min(z, tkernel.MIN_ZLEN), (z, zlen)


def test_z_chunk_one_chunk_at_the_paper_block():
    z, y, x = PAPER_BLOCK
    assert tkernel.z_chunk(z, y, x, H100_SLOTS) == z
    # the float64 paper cell's other block depths keep one chunk too
    for depth in (96, 144, 288):
        assert tkernel.z_chunk(depth, y, x, H100_SLOTS) == depth


@pytest.mark.parametrize("slots", [H100_SLOTS, 3 * H100_SMS])
def test_z_chunk_fills_the_card_in_one_wave_at_the_precision_shape(slots):
    """At (192, 96, 96) (18 tiles) the chunks give every SM a CTA and
    fill at least 90% of the card's slots in one wave: a CTA left for a
    second wave runs a whole chunk alone (on an H100, 270 CTAs on 264
    slots took 0.0328 ms a rung, 216 in one wave 0.0265;
    ``tools/kernel_shapes.py --f64-zlens``)."""
    z, y, x = PREC_SHAPE
    zlen = tkernel.z_chunk(z, y, x, slots)
    assert 8 <= len(_chunks(z, zlen)) <= 24
    ctas = _ctas(PREC_SHAPE, slots)
    assert H100_SMS < ctas <= slots
    assert ctas >= 0.9 * slots


def _fields64(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape)),
            torch.from_numpy(rng.standard_normal(shape)),
            torch.from_numpy(0.05 + 0.01 * rng.standard_normal(shape)))


def test_f64_wrappers_on_cpu_route_to_ref_and_count_no_launch(monkeypatch):
    """On CPU tensors both float64 wrappers are the plain version: no
    chunk choice (no device to ask for its slots), no launch counted."""
    def no_chunk(*args):
        raise AssertionError("launch_zlen called on the CPU route")

    monkeypatch.setattr(tkernel, "launch_zlen", no_chunk)
    before = dict(tkernel.launches)
    pp, pc, v2 = _fields64((9, 10, 11), 3)
    kp, kc = tkernel.wave_multistep(pp, pc, v2, 3)
    rp, rc = tref.ladder_steps(pp, pc, v2, 3)
    assert torch.equal(kp, rp) and torch.equal(kc, rc)
    qp, qc = tref.pad_bc(pp), tref.pad_bc(pc)
    kn, kl = tkernel.wave_step(qp, qc, v2)
    rn, rl = tref.wave_step(qp, qc, v2)
    assert torch.equal(kn, rn) and torch.equal(kl, rl)
    assert kn.dtype == kc.dtype == torch.float64
    assert tkernel.launches == before


@pytest.mark.parametrize("steps", [1, 2])
def test_f64_multistep_plain_version_matches_pallas_interpret(steps):
    """``repro``'s multistep kernel in float64 (interpret mode, y-tiled)
    against the port's multistep wrapper on CPU tensors (the plain
    ladder). In float64 the tiled and untiled ladders differ only by
    XLA's re-rounding, far below 1e-12 on unit-normal fields."""
    shape = (12, 8 * steps, 10)
    pp, pc, v2 = _fields64(shape, 20 + steps)
    tp, tc = tkernel.wave_multistep(pp, pc, v2, steps)
    with _x64():
        jp, jc = jkernel.wave_multistep_pallas(
            *(jnp.asarray(t.numpy()) for t in (pp, pc, v2)), steps=steps,
            interpret=True)
        assert jc.dtype == jnp.float64
        jp, jc = np.asarray(jp), np.asarray(jc)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=1e-12)

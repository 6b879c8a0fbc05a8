"""The port's plain selective scan against ``repro``'s: the XLA form
``chunked_selective_scan`` (the oracle ``repro.kernels.sscan.ref``
re-exports) and the Pallas kernel ``selective_scan_pallas`` in interpret
mode, on the same numpy inputs, within rtol 1e-4 / atol 1e-5 (the bound
of ``tests/test_sscan_kernel.py``: the scans multiply in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sscan import kernel as JK
from repro.kernels.sscan import ops as JO
from repro.kernels.sscan import ref as JR
from repro.models.ssm import chunked_selective_scan
from repro_torch.kernels.sscan import kernel as K
from repro_torch.kernels.sscan import ops as O
from repro_torch.kernels.sscan import ref as R

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, S, D, N, seed=0):
    """(dt, a, b_in, c_in, x, h0) as numpy float32, distributed as
    ``tests/test_sscan_kernel.py`` draws them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D))))
    a = -np.exp(0.3 * rng.standard_normal((D, N)))
    b_in = rng.standard_normal((B, S, N))
    c_in = rng.standard_normal((B, S, N))
    x = rng.standard_normal((B, S, D))
    h0 = 0.1 * rng.standard_normal((B, D, N))
    return tuple(t.astype(np.float32) for t in (dt, a, b_in, c_in, x, h0))


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# (B, S, D, N, chunk of the port and the XLA form, chunk and d_tile of
# the Pallas kernel, which needs S % chunk == 0 and D % d_tile == 0)
CASES = [
    (2, 64, 16, 4, 16, 16, 8),
    (1, 128, 32, 8, 32, 32, 32),
    (2, 32, 8, 16, 32, 32, 8),  # single chunk
    (2, 1, 16, 8, 8, 1, 8),  # one decode step
    (2, 21, 16, 8, 8, 7, 16),  # ragged: the port pads 21 to 24
]


@pytest.mark.parametrize("B,S,D,N,chunk,p_chunk,d_tile", CASES)
def test_plain_scan_matches_reference(B, S, D, N, chunk, p_chunk, d_tile):
    arrays = _inputs(B, S, D, N, seed=S + D)
    yt, ht = R.selective_scan_ref(*_torch(arrays), chunk)
    assert yt.shape == (B, S, D) and ht.shape == (B, D, N)
    yx, hx = JR.reference(*(jnp.asarray(a) for a in arrays), chunk)
    yp, hp = JK.selective_scan_pallas(*(jnp.asarray(a) for a in arrays),
                                      chunk=p_chunk, d_tile=d_tile)
    for y, h in ((yx, hx), (yp, hp)):
        np.testing.assert_allclose(yt.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(h), **TOL)


def test_chunk_does_not_change_the_scan():
    arrays = _torch(_inputs(2, 40, 16, 8, seed=3))
    y1, h1 = R.selective_scan_ref(*arrays, 40)
    for chunk in (1, 3, 16):
        y, h = R.selective_scan_ref(*arrays, chunk)
        torch.testing.assert_close(y, y1, **TOL)
        torch.testing.assert_close(h, h1, **TOL)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_ops_dispatch_on_cpu(backend):
    """``backend="ref"`` writes ``h_last`` in place into ``h_out`` (here
    ``h0`` itself, as the serving cache does); ``backend="cuda"`` on CPU
    tensors raises and leaves the launch count alone."""
    arrays = _torch(_inputs(2, 9, 16, 4, seed=5))
    want_y, want_h = R.selective_scan_ref(*arrays, 4)
    h0 = arrays[-1].clone()
    args = arrays[:-1] + (h0,)
    if backend == "cuda":
        before = K.launches["sscan"]
        with pytest.raises(ValueError, match="CUDA tensors"):
            O.selective_scan(*args, chunk=4, backend="cuda", h_out=h0)
        assert K.launches["sscan"] == before
        return
    y, h = O.selective_scan(*args, chunk=4, backend="ref", h_out=h0)
    assert h is h0
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h0, want_h, rtol=0, atol=0)


def test_kernel_wrapper_runs_plain_version_on_cpu():
    arrays = _torch(_inputs(1, 5, 8, 16, seed=7))
    before = K.launches["sscan"]
    y, h = K.selective_scan(*arrays)
    want_y, want_h = R.selective_scan_ref(*arrays, 5)
    assert K.launches["sscan"] == before
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shape", [(16, 4096, 8192, 16), (8, 1, 8192, 16),
                                   (2, 21, 16, 8)])
def test_traffic_model_is_the_reference(shape, fused):
    assert O.hbm_traffic_bytes(*shape, fused=fused) == \
        JO.hbm_traffic_bytes(*shape, fused=fused)


@pytest.mark.parametrize("B,S,D,N,chunk", [(2, 48, 16, 16, 16),
                                           (1, 37, 8, 5, 8)])
def test_float64_recurrence_matches_reference(B, S, D, N, chunk):
    """``selective_scan_f64``, the yardstick of the kernel's float64
    witness, against ``repro.models.ssm.chunked_selective_scan`` on the
    same inputs, within the scan's tolerance (float32 against float64)."""
    arrays = _inputs(B, S, D, N, seed=11 + S)
    y64, h64 = R.selective_scan_f64(*_torch(arrays))
    assert y64.dtype == h64.dtype == torch.float64
    yj, hj = chunked_selective_scan(*(jnp.asarray(a) for a in arrays), chunk)
    np.testing.assert_allclose(y64.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(h64.numpy(), np.asarray(hj), **TOL)

"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and ``nvcc``; without them the
``cuda_device`` fixture skips it. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Contract: every kernel is bit for bit equal to its plain version
(``-fmad=false`` and the reference's order of operations).
"""

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave, \
    paper_code_fields
from repro_torch.kernels.stencil import kernel as stencil_kernel
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.stencil import ref as stencil_ref
from repro_torch.kernels.zfp import kernel as zfp_kernel
from repro_torch.kernels.zfp import ops as zfp_ops

pytestmark = pytest.mark.cuda

SHAPES = {
    1: [(4,), (1000,), (3, 4097)],
    2: [(4, 4), (30, 50), (2, 9, 13)],
    3: [(4, 4, 4), (10, 11, 12), (50, 34, 33), (2, 5, 6, 7)],
}
PLANES = [32, 24, 16, 12, 8, 4, 1]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except _build.KernelError as exc:
        pytest.skip(str(exc))
    _build.build_all()
    return torch.device("cuda")


def _u32(t):
    return t.view(torch.int32).cpu().numpy()


def _normal(shape, seed, scale=7.3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("planes", PLANES)
def test_zfp_kernels_bitwise(cuda_device, ndim, planes):
    for i, shape in enumerate(SHAPES[ndim]):
        x = _normal(shape, 10 * ndim + i).to(cuda_device)
        cr = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="ref")
        ck = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="cuda")
        np.testing.assert_array_equal(_u32(ck.payload), _u32(cr.payload))
        np.testing.assert_array_equal(ck.emax.cpu(), cr.emax.cpu())
        yr = zfp_ops.decompress(cr, backend="ref")
        yk = zfp_ops.decompress(ck, backend="cuda")
        assert yk.shape == x.shape and yk.dtype == torch.float32
        np.testing.assert_array_equal(yk.cpu().numpy(), yr.cpu().numpy())


def test_zfp_special_values(cuda_device):
    n = 64
    rows = np.stack([
        np.zeros(n), np.full(n, 1e-40), np.full(n, 3e38),
        np.linspace(-1e-3, 1e3, n),
        np.where(np.arange(n) % 2 == 0, 1.0, -1.0) * 0.125,
    ]).astype(np.float32)
    x = torch.from_numpy(rows.reshape(20, 4, 4)).to(cuda_device)
    for planes in (32, 8):
        cr = zfp_ops.compress(x, planes=planes, backend="ref")
        ck = zfp_ops.compress(x, planes=planes, backend="cuda")
        np.testing.assert_array_equal(_u32(ck.payload), _u32(cr.payload))
        np.testing.assert_array_equal(ck.emax.cpu(), cr.emax.cpu())
        np.testing.assert_array_equal(
            zfp_ops.decompress(ck, backend="cuda").cpu(),
            zfp_ops.decompress(cr, backend="ref").cpu())


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    pp = rng.standard_normal(shape).astype(np.float32)
    pc = rng.standard_normal(shape).astype(np.float32)
    v2 = (0.05 + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    return pp, pc, v2


@pytest.mark.parametrize("shape", [(8, 8, 8), (13, 21, 37), (6, 40, 33)])
def test_wave_step_kernel_bitwise(cuda_device, shape):
    pp, pc, v2 = (torch.from_numpy(a).to(cuda_device)
                  for a in _fields(shape, sum(shape)))
    args = (stencil_ref.pad_bc(pp), stencil_ref.pad_bc(pc), v2)
    before = stencil_kernel.launches["wave_step"]
    kn, kl = stencil_ops.wave_step(*args, backend="cuda")
    rn, rl = stencil_ref.wave_step(*args)
    assert stencil_kernel.launches["wave_step"] == before + 1
    np.testing.assert_array_equal(kn.cpu().numpy(), rn.cpu().numpy())
    np.testing.assert_array_equal(kl.cpu().numpy(), rl.cpu().numpy())


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_multistep_kernel_bitwise(cuda_device, steps):
    shape = (16, 4 * steps * 2, 19)
    pp, pc, v2 = (torch.from_numpy(a).to(cuda_device)
                  for a in _fields(shape, steps))
    before = stencil_kernel.launches["wave_multistep"]
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, steps)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, steps)
    assert stencil_kernel.launches["wave_multistep"] == before + steps
    np.testing.assert_array_equal(kp.cpu().numpy(), rp.cpu().numpy())
    np.testing.assert_array_equal(kc.cpu().numpy(), rc.cpu().numpy())


@pytest.mark.parametrize("temporal,bt", [(1, 2), (2, 1)])
def test_engine_cuda_equals_ref_on_card(cuda_device, temporal, bt):
    shape = (96, 16, 16)
    p_cur = stencil_ref.ricker_source(shape).numpy()
    p_prev = 0.95 * p_cur
    vel2 = np.full(shape, 0.07, np.float32)
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()
    runs = {}
    for backend in ("cuda", "ref"):
        cfg = OOCConfig(shape, 4, bt, paper_code_fields(4), backend=backend)
        eng = OutOfCoreWave(cfg, p_prev, p_cur, vel2, temporal=temporal)
        eng.run(2 * bt * temporal)
        runs[backend] = eng
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(runs["cuda"].gather(name),
                                      runs["ref"].gather(name))
    assert (runs["cuda"].transfer_summary()
            == runs["ref"].transfer_summary())
    assert zfp_kernel.launches["encode"] > 0
    assert zfp_kernel.launches["decode"] > 0
    # Y=16 is divisible by bt*temporal*HALO = 8, so the engine takes the
    # multistep kernel for its 2-step visits
    assert stencil_kernel.launches["wave_multistep"] > 0

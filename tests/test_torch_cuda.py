"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and ``nvcc``; without them the
``cuda_device`` fixture skips it. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The live engine (``AsyncExecutor``) is held bit for bit to the
synchronous engine on the card, on three streams of its own with pinned
staging, against reuse of freed memory across its streams (the
``record_stream`` hazard) and under injected in-flight corruption.

Contract: the codec and stencil kernels are bit for bit equal to their
plain versions (``-fmad=false`` and the reference's order of
operations); the fused ZFP-decode attention kernel decodes bit for bit
(its decoded tiles are checked) and sums in another order, with FMA, so
it is held within rtol = atol = 2e-5; the
selective-scan kernel runs the recurrence step by step where its plain
version scans chunks associatively, held within rtol 1e-4 / atol 1e-5
(the bound of ``tests/test_sscan_kernel.py``). The float64 codec and
stencil kernels (``csrc/zfp64.cu``, ``csrc/stencil64.cu``) are held bit
for bit too, alone, through the float64 engines, and through the
precision curve, whose lossless code must be exactly 0 on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.configs import get_config, smoke
from repro_torch.core.executor import AsyncExecutor
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave, \
    paper_code_fields
from repro_torch.core.streams import Lanes
from repro_torch.distributed.fault import FaultInjector, FaultPlan, \
    FaultSpec, RetryPolicy, UnrecoverableFault
from repro_torch.kernels.stencil import kernel as stencil_kernel
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.stencil import ref as stencil_ref
from repro_torch.kernels.zfp import kernel as zfp_kernel
from repro_torch.kernels.cdecode import kernel as cdecode_kernel
from repro_torch.kernels.cdecode import ops as cdecode_ops
from repro_torch.kernels.cdecode import ref as cdecode_ref
from repro_torch.kernels.sscan import kernel as sscan_kernel
from repro_torch.kernels.sscan import ops as sscan_ops
from repro_torch.kernels.sscan import ref as sscan_ref
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.models import kvcache, model
from repro_torch.serving.engine import ServeEngine

pytestmark = pytest.mark.cuda

# X % 4 == 0 (whole rows, the decoder's float4 stores) beside X % 4 != 0
# (the cropped edge); the larger 3-D shapes span several CTAs and a
# partial last warp
SHAPES = {
    1: [(4,), (1000,), (3, 4097)],
    2: [(4, 4), (30, 50), (2, 9, 13)],
    3: [(4, 4, 4), (10, 11, 12), (50, 34, 33), (2, 5, 6, 7), (20, 36, 64),
        (9, 130, 131)],
}
# both stream orders: the identity (1-3 and 28-32 planes) and the subband
# order (4-27), with the edges of each
PLANES = [32, 28, 27, 24, 16, 12, 8, 4, 3, 2, 1]


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


@pytest.mark.parametrize("ndim,shape", [(2, (30, 52)), (2, (3, 9, 16)),
                                        (3, (10, 12, 16)), (3, (9, 13, 11))])
@pytest.mark.parametrize("planes", [16, 12, 32])
def test_zfp_encode_unaligned_input(cuda_device, ndim, shape, planes):
    """A contiguous view at a 1-float offset: rows not 16-byte aligned, so
    the encoder takes its 4-byte loads, bit for bit the plain codec."""
    n = int(np.prod(shape))
    buf = _normal((n + 1,), 7 * ndim + planes).to(cuda_device)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    payload, emax = zfp_kernel.encode(x, planes, ndim)
    rp, re = zfp_kernel.encode(x.cpu(), planes, ndim)
    np.testing.assert_array_equal(_u32(payload), rp.view(torch.int32).numpy())
    np.testing.assert_array_equal(emax.cpu().numpy(), re.numpy())


@pytest.mark.parametrize("which", ["encode", "decode"])
@pytest.mark.parametrize("planes", [12, 32])
def test_zfp_refuses_perm_not_in_stream_order(cuda_device, monkeypatch,
                                              which, planes):
    """Each C entry checks that its perm table is in the stream order it
    is passed: the subband order's tables (12 planes) passed as the
    identity, and the identity's (32 planes) passed as the subband order,
    are refused."""
    x = _normal((8, 8, 8), planes).to(cuda_device)
    payload, emax = zfp_kernel.encode(x, planes)
    real = zfp_kernel.stream_order
    monkeypatch.setattr(zfp_kernel, "stream_order",
                        lambda p, nd, width=32: 1 - real(p, nd, width))
    with pytest.raises(_build.KernelError, match=f"zfp_{which}"):
        if which == "encode":
            zfp_kernel.encode(x, planes)
        else:
            zfp_kernel.decode(payload, emax, x.shape, planes)
        torch.cuda.synchronize()


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


@pytest.mark.parametrize("shape", [(13, 21, 37), (7, 37, 68), (20, 40, 36)])
def test_wave_step_kernel_random_halo(cuda_device, shape):
    """Padded fields whose halo is random data, not pad_bc's zeros: the
    kernel reads the shell as the reference does. X % 4 != 0 (4-byte
    copies), a tile cut in y and x on aligned rows, and a short Z as the
    bt 1 engine's blocks."""
    rng = np.random.default_rng(sum(shape))
    pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
    pp, pc = (torch.from_numpy(rng.standard_normal(pad).astype(np.float32))
              .to(cuda_device) for _ in range(2))
    v2 = torch.from_numpy((0.05 + 0.01 * rng.standard_normal(shape))
                          .astype(np.float32)).to(cuda_device)
    kn, kl = stencil_kernel.wave_step(pp, pc, v2)
    rn, rl = stencil_ref.wave_step(pp, pc, v2)
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


# (37, 45, 70) and (20, 33, 65) cross the 16 x 32 tiles in y and x; (9, 3,
# 5) and (6, 7, 2) are narrower than the halo in y and x
@pytest.mark.parametrize("shape", [(37, 45, 70), (20, 33, 65), (9, 3, 5),
                                   (6, 7, 2)])
@pytest.mark.parametrize("steps", [1, 2, 3, 5, 12])
def test_multistep_ragged_bitwise(cuda_device, shape, steps):
    """Bit for bit the ladder on tiles cut in y and x and on fields
    thinner than the halo; the inputs are left as they were."""
    arrays = _fields(shape, 100 * steps + sum(shape))
    pp, pc, v2 = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, steps)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, steps)
    np.testing.assert_array_equal(kp.cpu().numpy(), rp.cpu().numpy())
    np.testing.assert_array_equal(kc.cpu().numpy(), rc.cpu().numpy())
    for t, a in zip((pp, pc, v2), arrays):
        np.testing.assert_array_equal(t.cpu().numpy(), a)


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


# ----------------------------------------------------------------------
# fused ZFP-decode attention (csrc/cdecode.cu)
# ----------------------------------------------------------------------

CDECODE_LENGTHS = [0, 7, 64, 75, 197]


def _ckv(tokens, *, b, kvh, d, planes, max_len, seed, backend):
    """A compressed cache filled token by token through append_token on
    the card; inputs from numpy."""
    rng = np.random.default_rng(seed)
    ckv = kvcache.init_compressed_kv(b, max_len, kvh, d, planes,
                                     dtype=torch.float32, device="cuda")
    for _ in range(tokens):
        k, v = (torch.from_numpy(
            (0.5 * rng.standard_normal((b, 1, kvh, d))).astype(np.float32)
        ).cuda() for _ in range(2))
        ckv = kvcache.append_token(ckv, k, v, planes=planes, backend=backend)
    return ckv


@pytest.mark.parametrize("planes", [8, 12, 16, 20])
@pytest.mark.parametrize("qpk", [1, 6, 8])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_cdecode_kernel_against_plain(cuda_device, d, qpk, planes):
    """Kernel partials within rtol = atol = 2e-5 of the plain version
    (the decoded values are the codec's bit for bit; only the order of
    the float32 sums differs), and the ops wrapper within the same bound
    of the compositional oracle."""
    b, kvh, max_len = 2, 2, 4 * kvcache.CHUNK
    ckv = _ckv(max(CDECODE_LENGTHS), b=b, kvh=kvh, d=d, planes=planes,
               max_len=max_len, seed=d + qpk + planes, backend="cuda")
    rng = np.random.default_rng(planes)
    for tokens in CDECODE_LENGTHS:
        hist = (tokens // kvcache.CHUNK) * kvcache.CHUNK
        q = torch.from_numpy(
            rng.standard_normal((b * kvh, qpk, d)).astype(np.float32)).cuda()
        args = (ckv.payload_k.reshape(b * kvh, -1, ckv.payload_k.shape[-1]),
                ckv.emax_k.reshape(b * kvh, -1),
                ckv.payload_v.reshape(b * kvh, -1, ckv.payload_v.shape[-1]),
                ckv.emax_v.reshape(b * kvh, -1), q, hist)
        kw = dict(planes=planes, head_dim=d, qpk=qpk)
        before = cdecode_kernel.launches["cdecode"]
        got = cdecode_kernel.fused_cdecode_attention(*args, **kw)
        assert cdecode_kernel.launches["cdecode"] == before + 1
        want = cdecode_ref.fused_cdecode_attention_ref(*args, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=2e-5, atol=2e-5)
    # the ops wrapper over the 197-token cache (tail + history)
    qf = torch.from_numpy(
        rng.standard_normal((b, 1, kvh * qpk, d)).astype(np.float32)).cuda()
    kw = dict(planes=planes, max_len=max_len)
    out = cdecode_ops.fused_compressed_decode_attention(qf, ckv, backend="cuda",
                                                        **kw)
    oracle = cdecode_ref.reference(qf, ckv, **kw)
    np.testing.assert_allclose(out.cpu().numpy(), oracle.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def _encoded_rows(rows, tokens, d, planes, seed):
    """K and V of ``rows`` rows of ``tokens`` tokens encoded by the
    codec kernel in the cache's layout: (rows, nb, W) payload and
    (rows, nb) emax each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = torch.from_numpy((0.5 * rng.standard_normal(
            (rows, tokens, d))).astype(np.float32)).cuda()
        p, e = zfp_kernel.encode(x, planes, 2)
        out += [p.view(rows, -1, p.shape[-1]), e.view(rows, -1)]
    return out


# hist_len 16 and 48 end mid-chunk, 64 k + 16 one band into a chunk
@pytest.mark.parametrize("hist_len", [0, 16, 48, 3 * kvcache.CHUNK + 16])
@pytest.mark.parametrize("rows", [1, 5, 16, 32])
def test_cdecode_bands_against_plain(cuda_device, rows, hist_len):
    """Split into 16-token bands: partials within 2e-5 of the plain
    version for histories that end inside a chunk, at 1 to 32 rows."""
    d, qpk, planes = 128, 6, 16
    pk, ek, pv, ev = _encoded_rows(rows, 4 * kvcache.CHUNK, d, planes,
                                   rows + hist_len)
    rng = np.random.default_rng(hist_len)
    q = torch.from_numpy((rng.standard_normal((rows, qpk, d))
                          / np.sqrt(d)).astype(np.float32)).cuda()
    args = (pk, ek, pv, ev, q, hist_len)
    kw = dict(planes=planes, head_dim=d, qpk=qpk)
    nsplit, per = cdecode_kernel.split_plan(
        rows, cdecode_kernel.live_bands(hist_len, pk.shape[1] // d))
    m, _, _ = cdecode_kernel.cdecode_partials(*args, **kw)
    assert m.shape == (rows, nsplit, qpk)
    got = cdecode_kernel.fused_cdecode_attention(*args, **kw)
    want = cdecode_ref.fused_cdecode_attention_ref(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("planes", [1, 4, 12, 16, 27, 28, 32])
@pytest.mark.parametrize("d", [16, 128])
def test_cdecode_decoded_tiles_bitwise(cuda_device, d, planes):
    """The K and V the attention kernel decodes in shared memory are the
    codec's decode bit for bit, under both stream orders (planes 4..27
    and the rest)."""
    pk, ek, pv, ev = _encoded_rows(3, 2 * kvcache.CHUNK, d, planes, planes)
    for band0, nbands in ((0, 8), (3, 2), (5, 1)):
        kt, vt = cdecode_kernel.decoded_tiles(
            pk, ek, pv, ev, planes=planes, head_dim=d, band0=band0,
            nbands=nbands)
        rk, rv = cdecode_kernel.decoded_tiles(
            *(t.cpu() for t in (pk, ek, pv, ev)), planes=planes, head_dim=d,
            band0=band0, nbands=nbands)
        for g, w in ((kt, rk), (vt, rv)):
            assert g.shape == (3, nbands * 16, d)
            np.testing.assert_array_equal(g.view(torch.int32).cpu().numpy(),
                                          w.view(torch.int32).numpy())


def test_compressed_cache_encode_kernel_bitwise(cuda_device):
    """append_token flushes through the encode kernel bit for bit as
    through the plain codec."""
    runs = {be: _ckv(130, b=2, kvh=2, d=16, planes=16, max_len=256, seed=3,
                     backend=be) for be in ("cuda", "ref")}
    for name in ("payload_k", "emax_k", "payload_v", "emax_v", "tail_k"):
        a, r = (getattr(runs[be], name) for be in ("cuda", "ref"))
        np.testing.assert_array_equal(a.view(torch.int32).cpu(),
                                      r.view(torch.int32).cpu())


def test_serving_cuda_equals_ref_on_card(cuda_device):
    """The engine over the compressed cache with the kernels against the
    same engine with their plain versions, both on the card, lockstep
    prompts: greedy streams equal."""
    import dataclasses

    cfg = dataclasses.replace(smoke(get_config("qwen2-1.5b")),
                              kv_compress_planes=16)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab_size, size=(2, 70)).tolist()
    outs = {}
    cdecode_kernel.reset_launches()
    for be in ("cuda", "ref"):
        eng = ServeEngine(cfg, params, slots=2, max_len=256, device="cuda",
                          backend=be)
        rids = [eng.submit(p, max_new=6) for p in prompts]
        done = eng.run_all()
        outs[be] = [done[r] for r in rids]
        if be == "cuda":
            assert cdecode_kernel.launches["cdecode"] == 75 * cfg.num_layers
    assert outs["cuda"] == outs["ref"]


# ----------------------------------------------------------------------
# Mamba-1 selective scan (csrc/sscan.cu)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 4, 5, 16])
@pytest.mark.parametrize("d", [8, 200, 256])
@pytest.mark.parametrize("s", [1, 7, 33, 64, 130])
@pytest.mark.parametrize("b", [1, 2])
def test_sscan_kernel_against_plain(cuda_device, b, s, d, n):
    """y and h_last within rtol 1e-4 / atol 1e-5 of the plain version;
    ``h_out`` is written in place (here ``h0`` itself, as the serving
    cache passes it). N of 1 and 5 mask lanes of the 4-lane split (and 5
    takes the scalar state path), D = 200 ends in a partial CTA of 64
    channels, S = 33 and 130 in a partial stage of 16 steps."""
    rng = np.random.default_rng(1000 * b + 10 * s + d + n)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, d)))
    a = -np.exp(0.3 * f(d, n))
    arrays = (dt, a, f(b, s, n), f(b, s, n), f(b, s, d), 0.1 * f(b, d, n))
    dt, a, b_in, c_in, x, h0 = (torch.from_numpy(np.ascontiguousarray(t))
                                .to(cuda_device) for t in arrays)
    want_y, want_h = sscan_ref.selective_scan_ref(dt, a, b_in, c_in, x, h0, 64)
    h_io = h0.clone()
    before = sscan_kernel.launches["sscan"]
    y, h = sscan_ops.selective_scan(dt, a, b_in, c_in, x, h_io, chunk=64,
                                    backend="cuda", h_out=h_io)
    torch.cuda.synchronize()
    assert sscan_kernel.launches["sscan"] == before + 1
    assert h is h_io
    np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_io.cpu().numpy(), want_h.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)


def test_ssm_serving_cuda_equals_ref_on_card(cuda_device):
    """falcon-mamba smoke through the engine with the scan kernel against
    the same engine with its plain version, both on the card: greedy
    streams equal, one launch per layer and step, logits within 1e-4."""
    cfg = smoke(get_config("falcon-mamba-7b"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = model.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, cfg.vocab_size, size=(2, 12)).tolist()
    outs, logs = {}, {}
    for be in ("cuda", "ref"):
        eng = ServeEngine(cfg, params, slots=2, max_len=64, device="cuda",
                          backend=be)
        step, seen = eng._step, []

        def record(*args, step=step, seen=seen):
            logits, cache = step(*args)
            seen.append(logits.float().cpu().numpy())
            return logits, cache

        eng._step = record
        sscan_kernel.reset_launches()
        rids = [eng.submit(p, max_new=6) for p in prompts]
        done = eng.run_all()
        outs[be], logs[be] = [done[r] for r in rids], np.stack(seen)
        if be == "cuda":
            assert sscan_kernel.launches["sscan"] == 17 * cfg.num_layers
        else:
            assert sscan_kernel.launches["sscan"] == 0
    assert outs["cuda"] == outs["ref"]
    np.testing.assert_allclose(logs["cuda"], logs["ref"], rtol=0, atol=1e-4)


# ----------------------------------------------------------------------
# the live engine: AsyncExecutor on its H2D, compute and D2H streams
# ----------------------------------------------------------------------

LIVE_SHAPE = (96, 16, 16)


def _live_fields():
    p_cur = stencil_ref.ricker_source(LIVE_SHAPE).numpy()
    return 0.95 * p_cur, p_cur, np.full(LIVE_SHAPE, 0.07, np.float32)


@pytest.mark.parametrize("schedule,budget", [
    ("depth2", 0), ("depth3", 100_000), ("temporal-2", 1 << 30),
    ("paper", 100_000),
])
def test_live_engine_equals_sync_on_card(cuda_device, monkeypatch,
                                         schedule, budget):
    """Bit for bit the synchronous engine on the card; three streams of
    its own, pinned staging, and every codec and stencil call on the
    compute stream."""
    temporal = 2 if schedule.startswith("temporal") else 1
    bt = 1 if temporal == 2 else 2
    cfg = OOCConfig(LIVE_SHAPE, 4, bt, paper_code_fields(4))
    sync = OutOfCoreWave(cfg, *_live_fields(), temporal=temporal)
    sync.run(4 * bt)
    streams = []
    for mod, name in ((zfp_ops, "compress"), (zfp_ops, "decompress"),
                      (stencil_ops, "fused_temporal_steps")):
        fn = getattr(mod, name)

        def seen(*a, fn=fn, **kw):
            streams.append(torch.cuda.current_stream().cuda_stream)
            return fn(*a, **kw)

        monkeypatch.setattr(mod, name, seen)
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()
    live = AsyncExecutor(cfg, *_live_fields(), schedule=schedule,
                         cache_bytes=budget)
    streams.clear()  # seeding encodes on the caller's stream
    live.run(4 * bt)
    lanes = live.lanes
    compute = lanes.streams["compute"].cuda_stream
    assert streams and set(streams) == {compute}
    ids = {s.cuda_stream for s in lanes.streams.values()}
    assert len(ids) == 3
    assert torch.cuda.current_stream().cuda_stream not in ids
    assert all(slot.tensor.is_pinned() for slot in lanes._slots)
    assert live.stats()["lanes"]["pinned_bytes"] > 0
    busy = lanes.busy_s()
    assert busy["h2d"] > 0 and busy["compute"] > 0
    assert zfp_kernel.launches["encode"] > 0
    assert zfp_kernel.launches["decode"] > 0
    assert stencil_kernel.launches["wave_multistep"] > 0
    monkeypatch.undo()
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))
    live.close()


def test_live_engine_adaptive_rates_on_card(cuda_device):
    """Adaptive rates on the card: the live engine and the sync engine,
    each with its own controller, decide the same rates and end bit for
    bit equal, with units moving at more than one rate."""
    from repro_torch.core.ratecontrol import RateController

    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4))
    sync = OutOfCoreWave(cfg, *_live_fields(), rates=RateController(
        cfg, mode="adaptive", error_budget=1e-2))
    sync.run(8)
    rates = RateController(cfg, mode="adaptive", error_budget=1e-2)
    live = AsyncExecutor(cfg, *_live_fields(), cache_bytes=100_000,
                         rates=rates)
    live.run(8)
    assert rates.state_dict() == sync.rates.state_dict()
    assert len({t.wire_bytes for t in live.transfers
                if t.field == "p_prev" and t.unit == ("R", 1)}) > 1
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))


def test_staged_unit_survives_reuse_of_its_memory(cuda_device):
    """A staged unit is allocated on the h2d stream and read on the
    compute stream. Freed while the compute stream is still behind, its
    block must not go to a new h2d allocation until that read is done:
    the junk written there would reach the result otherwise."""
    host = np.random.default_rng(0).standard_normal(1 << 22).astype(
        np.float32)
    lanes = Lanes(cuda_device, slot_bytes=host.nbytes, slots=2, threads=2)
    fetch = lanes.fetch(host, 0)
    fetch.send()
    dev = fetch.value()
    with lanes.on("compute"):
        torch.cuda._sleep(400_000_000)  # hold the compute stream back
        out = dev * 2.0
    del dev, fetch
    with lanes.on("h2d"):
        junk = torch.empty(host.nbytes, dtype=torch.uint8,
                           device=cuda_device)
        junk.fill_(255)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(out.cpu().numpy(), host * 2.0)
    lanes.close()


def test_parked_payload_survives_reuse_of_its_memory(cuda_device):
    """A writeback's payload is allocated on the compute stream and read
    by the d2h stream. Freed while that copy still waits, its block must
    not go to a new compute allocation until the copy is done."""
    host = np.random.default_rng(1).standard_normal(1 << 22).astype(
        np.float32)
    lanes = Lanes(cuda_device, slot_bytes=host.nbytes, slots=2, threads=2)
    with lanes.on("compute"):
        val = torch.from_numpy(host).to(cuda_device) * 1.0
    with lanes.on("d2h"):
        torch.cuda._sleep(400_000_000)  # hold the d2h stream back
    wb = lanes.writeback(val, 3, lanes.mark("compute"))
    del val
    with lanes.on("compute"):
        junk = torch.empty(host.nbytes, dtype=torch.uint8,
                           device=cuda_device)
        junk.fill_(255)
    back, crc = wb.result()
    wb.release()
    np.testing.assert_array_equal(back, host)
    from repro_torch.core.outofcore import unit_checksum
    assert crc == unit_checksum(host, 3)
    lanes.close()


def test_live_engine_with_allocator_churn_on_card(cuda_device, monkeypatch):
    """After every visit, blocks of every size the engine frees are
    handed out again on the h2d and compute streams and overwritten
    with NaN: no unit is corrupted."""
    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4))
    sync = OutOfCoreWave(cfg, *_live_fields())
    sync.run(8)
    park = AsyncExecutor._park_writebacks

    def churn(self, *a, **kw):
        park(self, *a, **kw)
        for lane in ("h2d", "compute"):
            with self.lanes.on(lane):
                for n in (1 << 12, 1 << 14, 1 << 16, 1 << 18):
                    torch.empty(n, device=cuda_device).fill_(float("nan"))

    monkeypatch.setattr(AsyncExecutor, "_park_writebacks", churn)
    live = AsyncExecutor(cfg, *_live_fields(), cache_bytes=100_000)
    live.run(8)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))


def test_live_engine_crc_mismatch_on_card(cuda_device):
    """Injected in-flight corruption on the card: retried and bit for bit
    with a retry; without one, a corrupt writeback raises before it is
    committed."""
    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4))
    sync = OutOfCoreWave(cfg, *_live_fields())
    sync.run(4)
    specs = [FaultSpec("corrupt", op="h2d", field="p_prev", unit="R1"),
             FaultSpec("corrupt", op="d2h", field="p_cur", unit="C0")]
    live = AsyncExecutor(cfg, *_live_fields(),
                         injector=FaultInjector(FaultPlan(specs)),
                         retry=RetryPolicy(attempts=2))
    live.run(4)
    assert live.store.wire_stats["checksum_failures"] > 0
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))
    live = AsyncExecutor(cfg, *_live_fields(), injector=FaultInjector(
        FaultPlan([FaultSpec("corrupt", op="d2h", field="p_prev",
                             unit="R0", version=1)])))
    crc0 = live.store.checksum_of("p_prev", "R", 0)
    with pytest.raises(UnrecoverableFault, match="d2h of unit p_prev.R0"):
        live.run(4)
    assert live.store.version_of("p_prev", "R", 0) == 0
    assert live.store.checksum_of("p_prev", "R", 0) == crc0


# ----------------------------------------------------------------------
# float64: the paper's configuration (csrc/zfp64.cu, csrc/stencil64.cu)
# ----------------------------------------------------------------------

# both stream orders at width 64: the identity (1-3 and 60-64 planes) and
# the subband order (4-59), with the paper's 24 and 32
F64_PLANES = [64, 60, 59, 40, 32, 24, 12, 4, 3, 1]


def _normal64(shape, seed, scale=7.3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape) * scale)


def _bits64(t):
    return t.cpu().numpy().view(np.int64)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("planes", F64_PLANES)
def test_zfp64_kernels_bitwise(cuda_device, ndim, planes):
    for i, shape in enumerate(SHAPES[ndim]):
        x = _normal64(shape, 30 * ndim + i).to(cuda_device)
        before = dict(zfp_kernel.launches)
        cr = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="ref")
        ck = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="cuda")
        np.testing.assert_array_equal(_u32(ck.payload), _u32(cr.payload))
        np.testing.assert_array_equal(ck.emax.cpu(), cr.emax.cpu())
        yr = zfp_ops.decompress(cr, backend="ref")
        yk = zfp_ops.decompress(ck, backend="cuda")
        assert yk.shape == x.shape and yk.dtype == torch.float64
        np.testing.assert_array_equal(_bits64(yk), _bits64(yr))
        assert zfp_kernel.launches["encode_f64"] == before["encode_f64"] + 1
        assert zfp_kernel.launches["decode_f64"] == before["decode_f64"] + 1
        assert zfp_kernel.launches["encode"] == before["encode"]


def test_zfp64_special_values(cuda_device):
    """Zeros, denormals, huge values, the emax floor and the most negative
    lifted coefficients, at 64, 32 and 24 planes."""
    n = 64
    near = np.nextafter(2.0, 0.0)
    rows = np.stack([
        np.zeros(n), np.full(n, 5e-324), np.full(n, 1e-310),
        np.full(n, 1e300), np.linspace(-1e-3, 1e3, n),
        np.where(np.arange(n) % 2 == 0, -near, near), np.full(n, -near),
        np.full(n, 3 * 2.0 ** -900),
    ])
    x = torch.from_numpy(rows.reshape(32, 4, 4)).to(cuda_device)
    for planes in (64, 32, 24):
        cr = zfp_ops.compress(x, planes=planes, backend="ref")
        ck = zfp_ops.compress(x, planes=planes, backend="cuda")
        np.testing.assert_array_equal(_u32(ck.payload), _u32(cr.payload))
        np.testing.assert_array_equal(ck.emax.cpu(), cr.emax.cpu())
        np.testing.assert_array_equal(
            _bits64(zfp_ops.decompress(ck, backend="cuda")),
            _bits64(zfp_ops.decompress(cr, backend="ref")))


def test_zfp64_random_payload_decodes_like_plain(cuda_device):
    """Arbitrary payload words (every plane, bit 63 included, and int64
    wrap-around in the inverse lift) decode as the plain version."""
    rng = np.random.default_rng(64)
    shape = (9, 13, 17)
    for planes in (64, 32, 24):
        _, _, nb = zfp_kernel._geometry(shape, 3)
        nw = zfp_kernel.ref.payload_words(3, planes, 64)
        p = torch.from_numpy(rng.integers(0, 2**32, (nb, nw), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(
            cuda_device).view(torch.uint32)
        e = torch.from_numpy(rng.integers(-900, 900, nb).astype(np.int32)).to(
            cuda_device)
        k = zfp_kernel.decode(p, e, shape, planes, dtype="float64")
        r = zfp_kernel.ref.unblockify(zfp_kernel.ref.decode_blocks(
            p, e, planes, 3, "float64"), shape, 3)
        np.testing.assert_array_equal(_bits64(k), _bits64(r))


def _fields64(shape, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape)),
            torch.from_numpy(rng.standard_normal(shape)),
            torch.from_numpy(0.05 + 0.01 * rng.standard_normal(shape)))


@pytest.mark.parametrize("shape", [(8, 8, 8), (13, 21, 37), (7, 37, 68)])
def test_wave_step64_kernel_bitwise(cuda_device, shape):
    """The float64 single step on padded fields with a random halo."""
    rng = np.random.default_rng(sum(shape))
    pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
    pp, pc = (torch.from_numpy(rng.standard_normal(pad)).to(cuda_device)
              for _ in range(2))
    v2 = torch.from_numpy(0.05 + 0.01 * rng.standard_normal(shape)).to(
        cuda_device)
    before = stencil_kernel.launches["wave_step_f64"]
    kn, kl = stencil_kernel.wave_step(pp, pc, v2)
    rn, rl = stencil_ref.wave_step(pp, pc, v2)
    assert stencil_kernel.launches["wave_step_f64"] == before + 1
    assert kn.dtype == torch.float64
    np.testing.assert_array_equal(_bits64(kn), _bits64(rn))
    np.testing.assert_array_equal(_bits64(kl), _bits64(rl))


@pytest.mark.parametrize("shape", [(16, 48, 19), (37, 45, 70), (9, 3, 5)])
@pytest.mark.parametrize("steps", [1, 2, 12])
def test_multistep64_kernel_bitwise(cuda_device, shape, steps):
    arrays = _fields64(shape, 7 * steps + sum(shape))
    pp, pc, v2 = (a.to(cuda_device) for a in arrays)
    before = stencil_kernel.launches["wave_multistep_f64"]
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, steps)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, steps)
    assert stencil_kernel.launches["wave_multistep_f64"] == before + steps
    np.testing.assert_array_equal(_bits64(kp), _bits64(rp))
    np.testing.assert_array_equal(_bits64(kc), _bits64(rc))
    for t, a in zip((pp, pc, v2), arrays):
        assert torch.equal(t.cpu(), a)


def test_stencil_refuses_mixed_types(cuda_device):
    pp, pc, v2 = (a.to(cuda_device) for a in _fields64((8, 8, 8), 1))
    with pytest.raises(TypeError, match="float64"):
        stencil_kernel.wave_multistep(pp, pc.float(), v2, 2)


def _fields64_engine(shape):
    p_cur = stencil_ref.ricker_source(shape, dtype=torch.float64).numpy()
    return 0.95 * p_cur, p_cur, np.full(shape, 0.07)


@pytest.mark.parametrize("temporal,bt", [(1, 2), (2, 1)])
def test_f64_engine_cuda_equals_ref_on_card(cuda_device, temporal, bt):
    """The float64 engine at the paper's rates through the float64
    kernels, bit for bit the same engine on the plain versions."""
    shape = (96, 16, 16)
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()
    runs = {}
    for backend in ("cuda", "ref"):
        cfg = OOCConfig(shape, 4, bt, paper_code_fields(4, f32=False),
                        backend=backend, dtype="float64")
        eng = OutOfCoreWave(cfg, *_fields64_engine(shape), temporal=temporal)
        eng.run(2 * bt * temporal)
        runs[backend] = eng
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(runs["cuda"].gather(name),
                                      runs["ref"].gather(name))
    assert (runs["cuda"].transfer_summary()
            == runs["ref"].transfer_summary())
    assert zfp_kernel.launches["encode_f64"] > 0
    assert zfp_kernel.launches["decode_f64"] > 0
    assert stencil_kernel.launches["wave_multistep_f64"] > 0
    assert zfp_kernel.launches["encode"] == 0


def test_f64_live_engine_equals_sync_on_card(cuda_device):
    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4, f32=False),
                    dtype="float64")
    sync = OutOfCoreWave(cfg, *_fields64_engine(LIVE_SHAPE))
    sync.run(8)
    live = AsyncExecutor(cfg, *_fields64_engine(LIVE_SHAPE),
                         schedule="depth2", cache_bytes=100_000)
    live.run(8)
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))
    live.close()


def test_f64_precision_curve_on_card(cuda_device):
    """The precision tier on the card in float64: code 1 exactly 0 (the
    multistep engine against the single-step in-core run), code 4 within
    the fast ceiling and equal to the plain versions' curve."""
    from repro_torch.core.precision import assert_bounded_growth, \
        error_curve

    kw = dict(shape=(192, 48, 24), ndiv=2, bt=12, sweeps=4, dtype="float64")
    stencil_kernel.reset_launches()
    assert all(r["max_abs"] == 0.0 for r in error_curve(1, **kw))
    assert stencil_kernel.launches["wave_multistep_f64"] > 0
    assert stencil_kernel.launches["wave_step_f64"] > 0
    card = error_curve(4, **kw)
    plain = error_curve(4, backend="ref", **kw)
    assert_bounded_growth(card, 0.100)
    assert [r["max_abs"] for r in card] == [r["max_abs"] for r in plain]


@pytest.mark.parametrize("which", ["encode", "decode"])
@pytest.mark.parametrize("planes", [24, 64])
def test_zfp64_refuses_perm_not_in_stream_order(cuda_device, monkeypatch,
                                                which, planes):
    """The float64 entries check their perm table too: the subband order
    (24 planes at width 64) passed as the identity, and the identity (64
    planes) passed as the subband order, are refused."""
    x = _normal64((8, 8, 8), planes).to(cuda_device)
    payload, emax = zfp_kernel.encode(x, planes)
    real = zfp_kernel.stream_order
    monkeypatch.setattr(zfp_kernel, "stream_order",
                        lambda p, nd, width=32: 1 - real(p, nd, width))
    with pytest.raises(_build.KernelError, match=f"zfp_{which}_f64"):
        if which == "encode":
            zfp_kernel.encode(x, planes)
        else:
            zfp_kernel.decode(payload, emax, x.shape, planes,
                              dtype="float64")
        torch.cuda.synchronize()

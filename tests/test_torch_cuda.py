"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and ``nvcc``; without them the
``cuda_device`` fixture skips it. Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The live engine (``AsyncExecutor``) is held bit for bit to the
synchronous engine on the card, on three streams of its own with pinned
staging, against reuse of freed memory across its streams (the
``record_stream`` hazard) and under injected in-flight corruption; its
overlapped checkpoint cut keeps the pre-cut device bytes, lossy
checkpoint leaves coded by the kernels are the plain codec's byte for
byte, and a rollback gives every pinned slot back. The sharded engine
(``ShardedExecutor``, 2 and 4 shards on one device, each with streams of
its own) is bit for bit the single-device engine on the card, also with
one shard's compute stream held back and freed memory refilled with NaN
(a held slice read before its exporter wrote it, or a payload whose
memory went to another tensor, would show), across a sharded checkpoint
and restore, and under a corrupted halo put that is retried.

Contract: the codec and stencil kernels are bit for bit equal to their
plain versions (``-fmad=false`` and the reference's order of
operations); the fused ZFP-decode attention kernel decodes bit for bit
(its decoded tiles are checked) and sums in another order, with FMA, so
it is held within rtol = atol = 2e-5; the
selective-scan kernel runs the recurrence step by step in float32,
held within rtol 1e-4 / atol 1e-5 (the bound of
``tests/test_sscan_kernel.py``) of the same recurrence in float64. The float64 codec and
stencil kernels (``csrc/zfp64.cu``, ``csrc/stencil64.cu``) are held bit
for bit too, alone, through the float64 engines, and through the
precision curve, whose lossless code must be exactly 0 on the card.
The MoE FFN (``models/moe.py``, plain PyTorch) at full width:
llama4-scout's layer against a float64 oracle and its decode over the
compressed cache with the kernels against the plain versions, and the
combine bit for bit across two calls at Qwen3-MoE's expert shapes.
"""

import dataclasses
import pathlib

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
    """y and h_last within rtol 1e-4 / atol 1e-5 of the plain float64
    recurrence (``selective_scan_f64``, the yardstick of the float32
    versions); ``h_out`` is written in place (here ``h0`` itself, as the serving
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
    want_y, want_h = sscan_ref.selective_scan_f64(dt, a, b_in, c_in, x, h0)
    h_io = h0.clone()
    before = sscan_kernel.launches["sscan"]
    y, h = sscan_ops.selective_scan(dt, a, b_in, c_in, x, h_io, chunk=64,
                                    backend="cuda", h_out=h_io)
    torch.cuda.synchronize()
    assert sscan_kernel.launches["sscan"] == before + 1
    assert h is h_io
    np.testing.assert_allclose(y.double().cpu().numpy(),
                               want_y.cpu().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h_io.double().cpu().numpy(),
                               want_h.cpu().numpy(), rtol=1e-4, atol=1e-5)


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
# checkpoints of the live engine on the card
# ----------------------------------------------------------------------
def _payload_bytes(value):
    """The host bytes of a device unit (a raw tensor or a Compressed)."""
    if hasattr(value, "payload"):
        return (value.payload.view(torch.int32).cpu().numpy().tobytes()
                + value.emax.cpu().numpy().tobytes())
    return value.cpu().numpy().tobytes()


@pytest.mark.parametrize("budget", [100_000, 1 << 30])
def test_overlapped_cut_on_card_keeps_precut_bytes(cuda_device, tmp_path,
                                                   budget):
    """The overlapped cut with write-back residency on the card: the
    pinned residents' snapshot D2H runs on the d2h stream after the next
    sweep overwrote half of them (copy-on-write shadows), the shards hold
    the pre-cut device bytes, and the run, the snapshot and its restore
    are bit for bit the port's CPU run."""
    from repro_torch.checkpoint import checkpoint as ckpt

    def run(cfg, root):
        live = AsyncExecutor(cfg, *_live_fields(), cache_bytes=budget)
        live.sweep()
        live.sweep()
        live.begin_checkpoint(str(root), zstd_level=0)
        pinned = {key: _payload_bytes(live.cache.pinned_entry(key).value)
                  for key, _ in live._ckpt_queue}
        live._ckpt_queue.rotate(-(len(live._ckpt_queue) // 2))
        live.sweep()
        live.finish()
        return live, pinned

    cpu_cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4),
                        backend="ref", device="cpu")
    cpu, _ = run(cpu_cfg, tmp_path / "cpu")
    live, pinned = run(OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4)),
                       tmp_path / "card")
    assert pinned and live.stats()["cache"]["cow_shadows"] > 0
    assert sum(t.ckpt for t in live.transfers) == len(pinned)
    _, leaves, _ = ckpt.load(live.last_checkpoint_path)
    for (field, (kind, idx)), want in pinned.items():
        ukey = f"{field}.{kind}{idx}"
        got = (leaves[ukey].tobytes() if ukey in leaves else
               leaves[ukey + ".payload"].tobytes()
               + leaves[ukey + ".emax"].tobytes())
        assert got == want, ukey
    _, cpu_leaves, _ = ckpt.load(cpu.last_checkpoint_path)
    assert list(leaves) == list(cpu_leaves)
    for key in leaves:
        assert leaves[key].tobytes() == cpu_leaves[key].tobytes(), key
    assert live.lanes.free_slots == len(live.lanes._slots)
    back = AsyncExecutor.restore(str(tmp_path / "card"))
    back.run(2)
    for name in ("p_prev", "p_cur", "vel2"):
        want = cpu.gather(name)
        np.testing.assert_array_equal(live.gather(name), want)
        np.testing.assert_array_equal(back.gather(name), want)
    live.close()
    back.close()


def test_lossy_leaf_shards_from_kernel_equal_plain(cuda_device, tmp_path):
    """Lossy float32 leaves coded by the ``zfp.cu`` kernels at ndim 1 give
    shards byte for byte those of the plain codec, and the kernels'
    decode is bit for bit the plain one."""
    from repro_torch.checkpoint import checkpoint as ckpt

    rng = np.random.default_rng(11)
    tree = {"a": (rng.standard_normal(1024) * 7.3).astype(np.float32),
            "b": (rng.standard_normal((37, 129)) * 1e-3).astype(np.float32),
            "c": torch.from_numpy(rng.standard_normal(5003).astype(
                np.float32)).to(cuda_device)}
    zfp_kernel.reset_launches()
    for planes in (16, 12, 32):
        card = ckpt.save(str(tmp_path / f"k{planes}"), 1, tree,
                         zstd_level=0, lossy_planes=planes)
        plain = ckpt.save(str(tmp_path / f"p{planes}"), 1, tree,
                          zstd_level=0, lossy_planes=planes, device="cpu")
        for f in sorted(pathlib.Path(card).iterdir()):
            assert f.read_bytes() == (pathlib.Path(plain) / f.name
                                      ).read_bytes(), (planes, f.name)
        _, got, _ = ckpt.load(card)
        _, want, _ = ckpt.load(card, device="cpu")
        for key in want:
            assert got[key].tobytes() == want[key].tobytes(), key
    assert zfp_kernel.f32_ndims["encode ndim1"] == 9
    assert zfp_kernel.f32_ndims["decode ndim1"] == 9


def test_rollback_on_card_gives_every_slot_back(cuda_device, tmp_path):
    """A fetch that fails mid-visit on the card, with writebacks parked
    and a snapshot half written: the rollback gives every pinned slot
    back, and the replay is bit for bit the synchronous engine's."""
    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4))
    sync = OutOfCoreWave(cfg, *_live_fields())
    sync.run(8)
    live = AsyncExecutor(cfg, *_live_fields(), retry=RetryPolicy(attempts=2),
                         injector=FaultInjector(FaultPlan([FaultSpec(
                             "corrupt", op="h2d", field="p_cur", unit="R0",
                             version=1, attempts=2)])))
    lanes = live.lanes
    live.checkpoint(str(tmp_path / "base"), zstd_level=0)
    live.sweep()
    live.begin_checkpoint(str(tmp_path / "cut"), zstd_level=0)
    with pytest.raises(UnrecoverableFault, match="p_cur.R0"):
        live.sweep()
    assert lanes.free_slots < len(lanes._slots)
    live.injector = live.store.injector = None
    live._rollback(str(tmp_path / "base"), RuntimeError("lost"))
    assert lanes.free_slots == len(lanes._slots)
    assert all(slot.tensor.is_pinned() for slot in lanes._slots)
    live.run(8)
    assert lanes.free_slots == len(lanes._slots)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(live.gather(name), sync.gather(name))
    live.close()


# ----------------------------------------------------------------------
# float64: the paper's configuration (csrc/zfp64.cu, csrc/stencil64.cu)
# ----------------------------------------------------------------------

# both stream orders at width 64: the identity (1-3 and 60-64 planes) and
# the subband order (4-59), with the paper's 24 and 32; and every route of
# csrc/zfp64.cu (kernel.f64_route) with the edges of each: at ndim 3 route
# 0 to 27 planes, route 1 at 28-32, route 2 from 33 (ndim 2: 0 to 29,
# ndim 1: 0 to 30, then route 1)
F64_PLANES = [64, 60, 59, 48, 40, 33, 32, 31, 30, 28, 27, 24, 12, 4, 3, 1]
# one or more plane counts of each route at each ndim
F64_ROUTE_PLANES = (64, 48, 33, 32, 28, 27, 24, 12)


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
    lifted coefficients, on every route at ndim 1-3."""
    n = 64
    near = np.nextafter(2.0, 0.0)
    rows = np.stack([
        np.zeros(n), np.full(n, 5e-324), np.full(n, 1e-310),
        np.full(n, 1e300), np.linspace(-1e-3, 1e3, n),
        np.where(np.arange(n) % 2 == 0, -near, near), np.full(n, -near),
        np.full(n, 3 * 2.0 ** -900),
    ])
    x = torch.from_numpy(rows.reshape(32, 4, 4)).to(cuda_device)
    for planes in F64_ROUTE_PLANES:
        for ndim in (3, 2, 1):
            cr = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="ref")
            ck = zfp_ops.compress(x, planes=planes, ndim=ndim, backend="cuda")
            np.testing.assert_array_equal(_u32(ck.payload), _u32(cr.payload))
            np.testing.assert_array_equal(ck.emax.cpu(), cr.emax.cpu())
            np.testing.assert_array_equal(
                _bits64(zfp_ops.decompress(ck, backend="cuda")),
                _bits64(zfp_ops.decompress(cr, backend="ref")))


def test_zfp64_random_payload_decodes_like_plain(cuda_device):
    """Arbitrary payload words (every plane, bit 63 included, and int64
    wrap-around in the inverse lift) decode as the plain version, on every
    route at ndim 1-3."""
    rng = np.random.default_rng(64)
    shape = (9, 13, 17)
    for planes in F64_ROUTE_PLANES:
        for ndim in (3, 2, 1):
            _, _, nb = zfp_kernel._geometry(shape, ndim)
            nw = zfp_kernel.ref.payload_words(ndim, planes, 64)
            p = torch.from_numpy(rng.integers(0, 2**32, (nb, nw),
                                              dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).to(
                cuda_device).view(torch.uint32)
            e = torch.from_numpy(rng.integers(-900, 900, nb).astype(
                np.int32)).to(cuda_device)
            k = zfp_kernel.decode(p, e, shape, planes, ndim, dtype="float64")
            r = zfp_kernel.ref.unblockify(zfp_kernel.ref.decode_blocks(
                p, e, planes, ndim, "float64"), shape, ndim)
            np.testing.assert_array_equal(_bits64(k), _bits64(r))


def _zfp64_round_trip(x, planes, ndim=3):
    """The kernels against the plain codec on ``x``, bit for bit."""
    payload, emax = zfp_kernel.encode(x, planes, ndim)
    rp, re = zfp_kernel.encode(x.cpu(), planes, ndim)
    np.testing.assert_array_equal(_u32(payload), rp.view(torch.int32).numpy())
    np.testing.assert_array_equal(emax.cpu().numpy(), re.numpy())
    y = zfp_kernel.decode(payload, emax, x.shape, planes, ndim,
                          dtype="float64")
    ry = zfp_kernel.decode(rp, re, x.shape, planes, ndim, dtype="float64")
    np.testing.assert_array_equal(_bits64(y), _bits64(ry))


@pytest.mark.parametrize("shape,threads", [((48, 96, 96), 32),
                                           ((96, 96, 96), 64)])
@pytest.mark.parametrize("planes", [24, 32])
def test_zfp64_precision_units_bitwise(cuda_device, shape, threads, planes):
    """The precision tier's units at the paper's rates, with the threads a
    CTA the wrapper picks there (every SM a CTA); each launch is tallied
    under its unit and planes."""
    nb = zfp_kernel._geometry(shape, 3)[2]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms == 132:
        assert zfp_kernel.f64_threads(nb, sms) == threads
    keys = [f"{k} {list(shape)} {planes}" for k in ("encode_f64",
                                                    "decode_f64")]
    before = [zfp_kernel.f64_shapes[k] for k in keys]
    _zfp64_round_trip(_normal64(shape, planes).to(cuda_device), planes)
    assert [zfp_kernel.f64_shapes[k] - b for k, b in zip(keys, before)] == [
        1, 1]


@pytest.mark.parametrize("planes", [24, 32, 48])
def test_zfp64_unaligned_odd_and_small_units(cuda_device, planes):
    """Rows not 16-byte aligned (a view at a one-double offset, d2 even),
    an odd d2, d2 = 2 mod 4 (the last block in x not whole), a unit of
    fewer than 32 blocks and one whose last warp is short: the scalar
    loads and the cropped stores, bit for bit."""
    shape = (10, 12, 16)
    n = int(np.prod(shape))
    buf = _normal64((n + 1,), planes).to(cuda_device)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _zfp64_round_trip(x, planes)
    for i, shape in enumerate([(9, 13, 11), (6, 8, 10), (4, 8, 8),
                               (12, 12, 140)]):
        _zfp64_round_trip(_normal64(shape, 10 * planes + i).to(cuda_device),
                          planes)


@pytest.mark.parametrize("threads", [32, 64, 128])
def test_zfp64_threads_bitwise(cuda_device, monkeypatch, threads):
    """Every threads a CTA the kernels take, forced, on every route: the
    warps of a CTA work alone, so the result is the same."""
    monkeypatch.setattr(zfp_kernel, "f64_threads", lambda nb, sms: threads)
    for planes in (24, 32, 64):
        _zfp64_round_trip(_normal64((20, 36, 64), planes).to(cuda_device),
                          planes)


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


# The float64 streaming kernels split Z into chunks (kernel.z_chunk): the
# wrapper's own choice (None) or a forced chunk length, on Z of 1, 5, 9 and
# 40 (chunks of 3, 7 and 13 leave a short last one), X odd (8-byte copies,
# unpaired stores), Y and X that cut the 16 x 32 tile, fields thinner than
# the halo.
STENCIL64_CHUNKS = [((1, 20, 37), None), ((5, 33, 65), None),
                    ((9, 17, 34), None), ((9, 17, 34), 4), ((40, 20, 36), 3),
                    ((40, 21, 37), 7), ((40, 20, 36), 13), ((40, 16, 32), 40),
                    ((40, 16, 32), None), ((6, 7, 2), 5)]


@pytest.mark.parametrize("shape,zlen", STENCIL64_CHUNKS)
def test_rung64_z_chunks_bitwise(cuda_device, monkeypatch, shape, zlen):
    """The float64 rung, 3 steps, bit for bit the ladder on every chunk
    split; the inputs are left as they were."""
    if zlen is not None:
        monkeypatch.setattr(stencil_kernel, "z_chunk", lambda *a: zlen)
    arrays = _fields64(shape, sum(shape) + (zlen or 0))
    pp, pc, v2 = (a.to(cuda_device) for a in arrays)
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, 3)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, 3)
    np.testing.assert_array_equal(_bits64(kp), _bits64(rp))
    np.testing.assert_array_equal(_bits64(kc), _bits64(rc))
    for t, a in zip((pp, pc, v2), arrays):
        assert torch.equal(t.cpu(), a)


@pytest.mark.parametrize("shape,zlen", STENCIL64_CHUNKS)
def test_wave_step64_z_chunks_random_shell(cuda_device, monkeypatch, shape,
                                           zlen):
    """The float64 single step on padded fields whose shell is random
    data, bit for bit ``ref.wave_step`` (p_next and lap) on every chunk
    split."""
    if zlen is not None:
        monkeypatch.setattr(stencil_kernel, "z_chunk", lambda *a: zlen)
    rng = np.random.default_rng(2 * sum(shape) + (zlen or 0))
    pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
    pp, pc = (torch.from_numpy(rng.standard_normal(pad)).to(cuda_device)
              for _ in range(2))
    v2 = torch.from_numpy(0.05 + 0.01 * rng.standard_normal(shape)).to(
        cuda_device)
    kn, kl = stencil_kernel.wave_step(pp, pc, v2)
    rn, rl = stencil_ref.wave_step(pp, pc, v2)
    np.testing.assert_array_equal(_bits64(kn), _bits64(rn))
    np.testing.assert_array_equal(_bits64(kl), _bits64(rl))


def test_stencil64_precision_shape_bitwise(cuda_device):
    """Both float64 kernels at the precision tier's (192, 96, 96), split
    into several chunks on the card: the rung over 12 steps, the single
    step on a random shell."""
    shape = (192, 96, 96)
    for step in (False, True):
        assert stencil_kernel.launch_zlen(cuda_device, shape, step) < shape[0]
    arrays = _fields64(shape, 192)
    pp, pc, v2 = (a.to(cuda_device) for a in arrays)
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, 12)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, 12)
    np.testing.assert_array_equal(_bits64(kp), _bits64(rp))
    np.testing.assert_array_equal(_bits64(kc), _bits64(rc))
    for t, a in zip((pp, pc, v2), arrays):
        assert torch.equal(t.cpu(), a)
    rng = np.random.default_rng(96)
    pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
    qp, qc = (torch.from_numpy(rng.standard_normal(pad)).to(cuda_device)
              for _ in range(2))
    kn, kl = stencil_kernel.wave_step(qp, qc, v2)
    rn, rl = stencil_ref.wave_step(qp, qc, v2)
    np.testing.assert_array_equal(_bits64(kn), _bits64(rn))
    np.testing.assert_array_equal(_bits64(kl), _bits64(rl))


def test_rung64_unaligned_storage_bitwise(cuda_device):
    """Fields at an 8-byte offset into their storage (contiguous, not
    16-byte aligned) with an even X: the 8-byte copies and unpaired
    loads, bit for bit; the inputs are left as they were."""
    shape = (20, 33, 66)
    arrays = _fields64(shape, 66)
    n = int(np.prod(shape))
    views = []
    for a in arrays:
        buf = torch.zeros(n + 1, dtype=torch.float64, device=cuda_device)
        buf[1:] = a.reshape(-1).to(cuda_device)
        views.append(buf[1:].view(shape))
    pp, pc, v2 = views
    assert pc.data_ptr() % 16 == 8
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, 2)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, 2)
    np.testing.assert_array_equal(_bits64(kp), _bits64(rp))
    np.testing.assert_array_equal(_bits64(kc), _bits64(rc))
    for t, a in zip(views, arrays):
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


@pytest.mark.parametrize("which", ["encode", "decode"])
@pytest.mark.parametrize("planes", [24, 32, 64])
def test_zfp64_refuses_tables_not_of_route(cuda_device, monkeypatch, which,
                                           planes):
    """The float64 entries check that their plane counts take the route
    they are passed: the tables of each route (24, 32 and 64 planes:
    routes 0, 1, 2) launched as the next route are refused."""
    x = _normal64((8, 8, 8), planes).to(cuda_device)
    payload, emax = zfp_kernel.encode(x, planes)
    real = zfp_kernel.f64_route
    monkeypatch.setattr(zfp_kernel, "f64_route",
                        lambda p, nd: (real(p, nd) + 1) % 3)
    with pytest.raises(_build.KernelError, match=f"zfp_{which}_f64"):
        if which == "encode":
            zfp_kernel.encode(x, planes)
        else:
            zfp_kernel.decode(payload, emax, x.shape, planes,
                              dtype="float64")
        torch.cuda.synchronize()


# ----------------------------------------------------------------------
# the sharded engine on the card: shards on one device, each with its
# own streams, the held slice crossing them and the halo leaving the
# exporter's card after its encode
# ----------------------------------------------------------------------
def _sharded_pair(nshards, schedule, budget, **kw):
    """The single-device live engine and the sharded one after three
    sweeps from the same fields, on the card."""
    from repro_torch.core.sharded import ShardedExecutor

    bt = 1 if schedule.startswith("temporal") else 2
    cfg = OOCConfig(LIVE_SHAPE, 4, bt, paper_code_fields(4))
    single = AsyncExecutor(cfg, *_live_fields(), schedule=schedule,
                           cache_bytes=budget)
    single.run(3 * bt)
    sh = ShardedExecutor(cfg, *_live_fields(), nshards=nshards,
                         schedule=schedule, cache_bytes=budget, **kw)
    return single, sh


@pytest.mark.parametrize("budget", [0, 1 << 30])
@pytest.mark.parametrize("schedule", ["depth2", "temporal2"])
@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_engine_equals_single_on_card(cuda_device, nshards, schedule,
                                              budget):
    """Bit for bit the single-device engine on the card, every shard on
    the same device with three streams of its own, the kernels launched
    through the shards."""
    single, sh = _sharded_pair(nshards, schedule, budget)
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()
    sh.run_sweeps(3)
    computes = {ex.lanes.streams["compute"].cuda_stream for ex in sh.shards}
    assert len(computes) == nshards
    assert all(ex.device.type == "cuda" for ex in sh.shards)
    assert zfp_kernel.launches["encode"] > 0
    assert zfp_kernel.launches["decode"] > 0
    assert stencil_kernel.launches["wave_multistep"] > 0
    assert sh.transfer_summary()["halo_count"] > 0
    for name in ("p_prev", "p_cur", "vel2"):
        np.testing.assert_array_equal(sh.gather(name), single.gather(name))
    single.close()
    sh.close()


@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_engine_with_allocator_churn_on_card(cuda_device,
                                                     monkeypatch, nshards):
    """Shard 0's compute stream held back before each of its stencils,
    and after every visit of every shard freed blocks handed out again
    on its streams and overwritten with NaN: a held slice read before
    its exporter wrote it, or a payload whose memory went to another
    tensor, would reach the result."""
    single, sh = _sharded_pair(nshards, "depth2", 100_000)
    park = AsyncExecutor._park_writebacks

    def churn(self, *a, **kw):
        park(self, *a, **kw)
        for lane in ("h2d", "compute", "d2h"):
            with self.lanes.on(lane):
                for n in (1 << 12, 1 << 14, 1 << 16, 1 << 18):
                    torch.empty(n, device=cuda_device).fill_(float("nan"))

    monkeypatch.setattr(AsyncExecutor, "_park_writebacks", churn)
    first = sh.shards[0]
    stencil = first._exec_stencil

    def late(*a, **kw):
        torch.cuda._sleep(50_000_000)  # on shard 0's compute stream
        return stencil(*a, **kw)

    first._exec_stencil = late
    sh.run_sweeps(3)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(sh.gather(name), single.gather(name))
    single.close()
    sh.close()


def test_sharded_checkpoint_restore_on_card(cuda_device, tmp_path):
    from repro_torch.core.sharded import ShardedExecutor

    single, sh = _sharded_pair(2, "depth2", 1 << 30)
    single.close()
    d = str(tmp_path)
    sh.run_sweeps(2)
    sh.checkpoint(d, zstd_level=0)
    sh.run_sweeps(1)
    want = {n: sh.gather(n) for n in ("p_prev", "p_cur")}
    rest = ShardedExecutor.restore(d)
    assert rest.sweeps_done == 2
    assert all(ex.device.type == "cuda" for ex in rest.shards)
    rest.run_sweeps(1)
    for n, arr in want.items():
        np.testing.assert_array_equal(rest.gather(n), arr)
    sh.close()
    rest.close()


def test_sharded_halo_put_corrupted_and_retried_on_card(cuda_device):
    """A halo put corrupted in flight: its digest, taken as the payload
    left the exporter's card, fails, the crossing is retried and lands
    as op ``"halo"`` at two attempts, and the run stays bit for bit."""
    plan = FaultPlan([FaultSpec("corrupt", op="halo", field="p_prev")])
    single, sh = _sharded_pair(2, "depth2", 0,
                               injector=FaultInjector(plan),
                               retry=RetryPolicy(attempts=2))
    sh.run_sweeps(3)
    store = sh.shards[0].store
    halos = [e for e in store.wire_log if e[0] == "halo"]
    assert halos and all(e[-1] == 2 for e in halos if e[1] == "p_prev")
    assert all(e[-1] == 1 for e in halos if e[1] == "p_cur")
    assert store.wire_stats["checksum_failures"] == 3
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(sh.gather(name), single.gather(name))
    single.close()
    sh.close()


# ----------------------------------------------------------------------
# tenancy on the card: tenants' live engines, each with its own streams,
# pool and host threads, under one shared residency budget
# ----------------------------------------------------------------------
def _tenant_fields(shape, seed):
    p_cur = stencil_ref.ricker_source(shape).numpy()
    return (0.95 * p_cur, p_cur,
            np.full(shape, 0.07 + 0.01 * seed, np.float32))


def _tenants_on_card():
    """A latency tenant (96, 16, 16), ndiv 4, bt 2, half its working set
    reserved, priority 10, and a batch tenant (48, 16, 16), ndiv 4, bt 1,
    both code 4, depth2, 2 sweeps, under half their working sets: the
    merged graph routes flushes both ways at this budget."""
    from repro_torch.core.tenancy import working_set_bytes
    from repro_torch.serving.ooc import TenantScheduler

    cfg_a = OOCConfig((96, 16, 16), 4, 2, paper_code_fields(4))
    cfg_b = OOCConfig((48, 16, 16), 4, 1, paper_code_fields(4))
    ws_a = working_set_bytes(cfg_a, "depth2")
    ws_b = working_set_bytes(cfg_b, "depth2")
    budget = (ws_a + ws_b) // 2
    sched = TenantScheduler(budget)
    sched.submit("A", cfg_a, *_tenant_fields(cfg_a.shape, 0), sweeps=2,
                 reserve=ws_a // 2, priority=10)
    sched.submit("B", cfg_b, *_tenant_fields(cfg_b.shape, 1), sweeps=2,
                 reserve=0, priority=0)
    return sched, budget


@pytest.mark.parametrize("churn", [False, True])
def test_tenants_equal_solo_runs_on_card(cuda_device, monkeypatch, churn):
    """Two tenants contending for one budget on the card: each bit for
    bit its solo live engine, its transfers those of the merged graph,
    flushes routed in both directions (each on the victim's own d2h
    stream and pool), every pool whole after the run, the kernels
    launched through the tenants. With ``churn`` freed memory is handed
    out again on every stream after each visit and filled with NaN: a
    routed flush reading a payload whose memory went elsewhere would
    show."""
    from repro_torch.core.taskgraph import build_tenant_tasks

    if churn:
        park = AsyncExecutor._park_writebacks

        def churned(self, *a, **kw):
            park(self, *a, **kw)
            for lane in ("h2d", "compute", "d2h"):
                with self.lanes.on(lane):
                    for n in (1 << 12, 1 << 14, 1 << 16):
                        torch.empty(n, device=cuda_device).fill_(
                            float("nan"))

        monkeypatch.setattr(AsyncExecutor, "_park_writebacks", churned)
    sched, budget = _tenants_on_card()
    routed = []
    route = sched._route_flush

    def counting(tenant, key, ent):
        routed.append(tenant)
        route(tenant, key, ent)

    for run in sched.tenants.values():
        run.executor.cache.router = counting
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()
    sched.run()
    assert set(routed) == {"A", "B"}
    assert zfp_kernel.launches["encode"] > 0
    assert zfp_kernel.launches["decode"] > 0
    assert stencil_kernel.launches["wave_step"] > 0
    tasks = build_tenant_tasks(sched.specs(), budget_bytes=budget)
    streams = set()
    for i, spec in enumerate(sched.specs()):
        ex = sched.tenants[spec.name].executor
        streams.add(ex.lanes.streams["compute"].cuda_stream)
        assert ex.lanes.free_slots == len(ex.lanes._slots)
        live = sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                       t.wire_bytes if t.flush else None)
                      for t in ex.transfers)
        graph = sorted((t.kind, t.field, t.unit, t.sweep, t.flush,
                        int(t.amount) if t.flush else None)
                       for t in tasks if t.tenant == spec.name
                       and t.kind in ("h2d", "d2h"))
        assert live == graph, spec.name
        solo = AsyncExecutor(spec.cfg, *_tenant_fields(spec.cfg.shape, i),
                             schedule=spec.schedule)
        solo.run(spec.sweeps * spec.cfg.bt)
        for name in ("p_prev", "p_cur", "vel2"):
            np.testing.assert_array_equal(sched.gather(spec.name, name),
                                          solo.gather(name))
        solo.close()
    assert len(streams) == 2
    sched.close()


def test_tenant_checkpoint_restores_on_card(cuda_device, tmp_path):
    """A per-tenant cut taken mid-run on the card (the other tenant
    keeps its residency and runs on) restores on the card as a solo run
    with the shared budget, and finishes bit for bit."""
    from repro_torch.core.tenancy import interleave_rounds

    sched, budget = _tenants_on_card()
    path = None
    for name, start, kr in interleave_rounds(sched.specs()):
        if name == "A" and start == 1:
            path = sched.checkpoint_tenant("A", str(tmp_path), zstd_level=0)
        sched.tenants[name].executor.advance_round(start + kr)
    sched.run()
    assert path is not None
    rest = AsyncExecutor.restore(path)
    assert rest.device.type == "cuda" and rest.cfg.backend == "cuda"
    assert rest.sweeps_done == 1 and rest.cache.budget_bytes == budget
    rest.run(rest.cfg.bt)
    for name in ("p_prev", "p_cur"):
        np.testing.assert_array_equal(rest.gather(name),
                                      sched.gather("A", name))
    rest.close()
    sched.close()


# ----------------------------------------------------------------------
# training: quantize on the card, compressed remat, a train step
# ----------------------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("planes", [32, 16, 12, 8, 4])
def test_quantize_kernels_bitwise(cuda_device, ndim, planes):
    """``quantize(backend="cuda")`` (encode then decode kernels) is bit
    for bit the plain codec's fused ``ref.quantize``."""
    from repro_torch.kernels.zfp import ref as zfp_ref

    for i, shape in enumerate(SHAPES[ndim]):
        x = _normal(shape, 40 * ndim + i).to(cuda_device)
        before = dict(zfp_kernel.launches)
        got = zfp_ops.quantize(x, planes=planes, ndim=ndim, backend="cuda")
        assert zfp_kernel.launches["encode"] == before["encode"] + 1
        assert zfp_kernel.launches["decode"] == before["decode"] + 1
        want = zfp_ref.quantize(x, planes, ndim)
        assert got.shape == x.shape and got.device == x.device
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def _no_plain_codec(monkeypatch):
    """Make every plain codec entry raise on a CUDA tensor."""
    from repro_torch.kernels.zfp import ref as zfp_ref

    for name in ("encode_blocks", "decode_blocks", "quantize_blocks",
                 "quantize"):
        real = getattr(zfp_ref, name)

        def guard(x, *a, _real=real, _name=name, **kw):
            assert x.device.type != "cuda", f"plain {_name} on the card"
            return _real(x, *a, **kw)

        monkeypatch.setattr(zfp_ref, name, guard)


def test_rate_controlled_engines_observe_through_kernels(cuda_device,
                                                         monkeypatch):
    """With a ``RateController`` attached, both engines' observations
    decode the payload the encode kernel just made: no plain codec call
    on the card, the same decisions as the plain codec on the CPU."""
    from repro_torch.core.ratecontrol import RateController

    cfg = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4))
    cpu = OOCConfig(LIVE_SHAPE, 4, 2, paper_code_fields(4), backend="ref",
                    device="cpu")
    want = RateController(cpu, mode="adaptive", error_budget=1e-2)
    OutOfCoreWave(cpu, *_live_fields(), rates=want).run(8)
    _no_plain_codec(monkeypatch)
    zfp_kernel.reset_launches()
    sync = OutOfCoreWave(cfg, *_live_fields(), rates=RateController(
        cfg, mode="adaptive", error_budget=1e-2))
    sync.run(8)
    live = AsyncExecutor(cfg, *_live_fields(), cache_bytes=100_000,
                         rates=RateController(cfg, mode="adaptive",
                                              error_budget=1e-2))
    live.run(8)
    assert zfp_kernel.launches["encode"] > 0
    assert zfp_kernel.launches["decode"] > 0
    assert sync.rates.state_dict() == want.state_dict()
    assert live.rates.state_dict() == want.state_dict()
    live.close()


def test_compressed_checkpoint_on_card(cuda_device, monkeypatch):
    """The residuals are coded by the kernels at ndim 1, their payloads
    bit for bit the plain codec's on the same leaves, and the gradients
    equal those the plain codec's residuals give."""
    from repro_torch.core import remat
    from repro_torch.kernels.zfp import ref as zfp_ref

    saved = []
    real = remat.compress_tree

    def record(tree, planes, **kw):
        out = real(tree, planes, **kw)
        saved.append((tree, out, planes))
        return out

    monkeypatch.setattr(remat, "compress_tree", record)
    x = _normal((257, 96), 1, scale=1.0).to(cuda_device)
    w = (_normal((96, 80), 2, scale=0.1)).to(cuda_device)

    def f(x, w):
        return torch.sum(torch.sin(torch.tanh(x @ w)) ** 2)

    grads = {}
    for backend in ("cuda", "ref"):
        zfp_kernel.reset_launches()
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = remat.compressed_checkpoint(f, planes=12, backend=backend)(
            tx, tw)
        grads[backend] = torch.autograd.grad(out, (tx, tw))
        n = 2 if backend == "cuda" else 0
        assert zfp_kernel.f32_ndims["encode ndim1"] == n
        assert zfp_kernel.f32_ndims["decode ndim1"] == n
    args, res, planes = saved[0]
    for a, r in zip(args, res):
        pay, emax = zfp_ref.encode_blocks(
            zfp_ref.blockify(a.detach().reshape(-1), 1), planes, 1)
        assert torch.equal(r.comp.payload.view(torch.int32),
                           pay.view(torch.int32))
        assert torch.equal(r.comp.emax, emax)
    for a, b in zip(grads["cuda"], grads["ref"]):
        assert torch.equal(a, b)


def test_train_step_on_card_against_plain(cuda_device):
    """One lm-tiny step with compressed remat and 8-plane gradients on
    the card: the kernels' step against the plain codec's from the same
    weights, the loss bit for bit (the forward runs the same operations),
    the gradient norm within 1e-5 relative and the weights within 1e-6
    (a residual or gradient a few ulps apart, from the backward's
    atomics, may flip one kept bit plane of a block)."""
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
    from repro_torch.launch import steps, train
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(train.PRESETS["lm-tiny"], remat="compressed",
                              grad_compress_planes=8)
    batch = {k: torch.from_numpy(v.copy()).to(cuda_device) for k, v in
             SyntheticLM(PipelineConfig(cfg.vocab_size, 4, 64)).batch_at(
                 0).items()}
    out = {}
    for backend in ("cuda", "ref"):
        zfp_kernel.reset_launches()
        m = model.init_params(cfg, torch.Generator(
            device=cuda_device).manual_seed(0), device=cuda_device)
        opt = adamw.init(dict(m.named_parameters()), error_feedback=True)
        step = steps.make_train_step(cfg, peak_lr=3e-4, warmup=0,
                                     total_steps=2, backend=backend)
        opt, met = step(m, opt, batch)
        torch.cuda.synchronize()
        out[backend] = (m, met, dict(zfp_kernel.f32_ndims))
    km, kmet, kl = out["cuda"]
    pm, pmet, pl = out["ref"]
    # residuals: h and each weight of 64 values or more, a layer; the
    # gradients: each stacked leaf of 64 values or more
    n = sum(1 + sum(p.numel() >= 64 for p in lp.parameters())
            for lp in km.layers)
    sizes = dict((k, p.numel()) for k, p in km.named_parameters())
    n += sum(sum(sizes[k] for k in names) >= 64 for names in
             model.stacked_leaves(sizes).values())
    assert kl["encode ndim1"] == kl["decode ndim1"] == n and not pl
    assert torch.equal(kmet["loss"], pmet["loss"])
    assert float(kmet["gnorm"]) == pytest.approx(float(pmet["gnorm"]),
                                                 rel=1e-5)
    for (name, a), (_, b) in zip(km.named_parameters(),
                                 pm.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def test_zfp_ndim1_flat_leaf_over_2_27_values(cuda_device):
    """The training path's launch sizes: one flat leaf of 2^27 + 5
    values (an embedding's gradient is 233M at Qwen2-1.5B width) at ndim
    1, encode and decode bit for bit the plain codec."""
    from repro_torch.kernels.zfp import ref as zfp_ref

    n = (1 << 27) + 5
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(n, generator=gen, device=cuda_device) * 3e-3
    for planes in (8, 12):
        payload, emax = zfp_kernel.encode(x, planes, 1)
        rp, re = zfp_ref.encode_blocks(zfp_ref.blockify(x, 1), planes, 1)
        assert torch.equal(payload.view(torch.int32), rp.view(torch.int32))
        assert torch.equal(emax, re)
        del rp, re
        y = zfp_kernel.decode(payload, emax, (n,), planes, 1)
        assert torch.equal(y, zfp_ref.quantize(x, planes, 1))
        del payload, emax, y
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the MoE family (models/moe.py) at full width
# ----------------------------------------------------------------------

SERVE_TOL = 5e-2  # the serving slice's bound against the plain engine
BF16_SCORE_ROUNDING = 2.0 ** -8


def _moe_oracle(x, top_w, top_i, wg, wu, wd, capacity):
    """Σ over kept assignments of weight · the expert's GLU, in float64;
    the kept set by a host loop (each expert's first ``capacity``
    assignments in flat (t, k) order). Returns (y, kept (T, k))."""
    t, k = top_i.shape
    seen, kept = {}, []
    for ex in top_i.reshape(-1).tolist():
        kept.append(seen.get(ex, 0) < capacity)
        seen[ex] = seen.get(ex, 0) + 1
    kept = torch.tensor(kept).reshape(t, k)
    y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for ex in range(wg.shape[0]):
        tok, j = torch.nonzero((top_i.cpu() == ex) & kept, as_tuple=True)
        if not len(tok):
            continue
        tok, j = tok.to(x.device), j.to(x.device)
        xe = x[tok].double()
        h = torch.nn.functional.silu(xe @ wg[ex].double()) * (
            xe @ wu[ex].double())
        y.index_add_(0, tok, (h @ wd[ex].double())
                     * top_w[tok, j].double()[:, None])
    return y, kept


def test_llama4_scout_full_width_one_layer_on_card(cuda_device,
                                                   monkeypatch):
    """llama4-scout at full width (d 5120, 16 experts of 8192, top-1 and
    the shared expert), 1 of its 48 layers, bf16: ``moe_ffn`` in float32
    on the layer's weights against the float64 oracle (kept set exact,
    ``y`` within 1e-4 of its largest) at 8 and 1024 tokens; then 72
    lockstep decode steps over the compressed cache (the last 8 over 64
    tokens of compressed history) with the kernels against the plain
    versions: logits within 5e-2 of their largest on every step whose
    routings agree, and no routing flip whose score gap exceeds bf16
    rounding."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              num_layers=1, kv_compress_planes=16)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    params = model.init_params(cfg, gen, device=cuda_device)
    lp = params.layers[0]
    w32 = [getattr(lp, n).float() for n in ("wg_e", "wu_e", "wd_e")]
    for t in (8, 1024):
        x = torch.randn(t, cfg.d_model, generator=gen, device=cuda_device)
        cap = moe._capacity(t, 1, cfg.num_experts, cfg.capacity_factor)
        with torch.inference_mode():
            y, _ = moe.moe_ffn(x[None], lp.router.float(), *w32, k=1,
                               capacity_factor=cfg.capacity_factor)
            top_w, top_i, _ = moe.route(x, lp.router.float(), 1)
            keep = moe.dispatch(top_i, cfg.num_experts, cap).keep
            want, kept = _moe_oracle(x, top_w, top_i, *w32, cap)
        assert torch.equal(keep.reshape(t, 1).cpu(), kept)
        err = (y[0].double() - want).abs().max() / want.abs().max()
        assert float(err) < 1e-4, (t, float(err))
    del w32
    torch.cuda.empty_cache()

    routes = {}
    inner = moe.top_k

    def record(scores, k):
        vals, idx = inner(scores, k + 1)
        routes.setdefault(backend, []).append((idx[:, :k], vals))
        return vals[:, :k], idx[:, :k]

    monkeypatch.setattr(moe, "top_k", record)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        1, cfg.vocab_size, size=(8, 72)).astype(np.int32))
    logs = {}
    for backend in ("cuda", "ref"):
        cdecode_kernel.reset_launches()
        cache = model.init_cache(cfg, 8, 128, cuda_device)
        out = []
        for i in range(72):
            pos = torch.full((8, 1), i, dtype=torch.int32)
            logits, cache = model.decode_step(cfg, params, cache,
                                              toks[:, i:i + 1], pos,
                                              backend=backend)
            out.append(logits.float())
        logs[backend] = torch.stack(out)
        launched = cdecode_kernel.launches["cdecode"]
        assert (launched > 0) == (backend == "cuda")
    sets = {b: torch.stack([i for i, _ in r]).sort(-1).values
            for b, r in routes.items()}
    agree = (sets["cuda"] == sets["ref"]).all(-1)  # (steps, slots)
    for b, r in routes.items():
        v = torch.stack([v for _, v in r]).double()
        gap = ((v[..., 0] - v[..., 1]) / v[..., 0])[~agree]
        assert not len(gap) or float(gap.max()) <= BF16_SCORE_ROUNDING, b
    ratio = ((logs["cuda"] - logs["ref"]).abs().amax(dim=(1, 2))
             / logs["ref"].abs().amax(dim=(1, 2)))
    steady = agree.all(-1)
    assert int(steady[64:].sum()) > 0
    assert float(ratio[steady].max()) < SERVE_TOL


def test_moe_combine_is_deterministic_on_card(cuda_device):
    """``moe_ffn`` at Qwen3-MoE's expert shapes (128 experts of 1536 over
    d 4096, top-8), bf16, 1024 tokens (t·k 8192 > 4096: capacity 80, a
    skewed router so assignments drop): two calls bit for bit equal,
    the same routing and kept set."""
    from repro_torch.models import moe

    gen = torch.Generator(device=cuda_device).manual_seed(13)
    e, d, f, t, k = 128, 4096, 1536, 1024, 8
    rnd = lambda *shape, scale: (torch.randn(
        *shape, generator=gen, device=cuda_device) * scale).bfloat16()
    x = rnd(1, t, d, scale=1.0)
    router = rnd(d, e, scale=d ** -0.5)
    router[:, :4] += 0.02
    wg, wu = rnd(e, d, f, scale=d ** -0.5), rnd(e, d, f, scale=d ** -0.5)
    wd = rnd(e, f, d, scale=f ** -0.5)
    with torch.inference_mode():
        ys = [moe.moe_ffn(x, router, wg, wu, wd, k=k, capacity_factor=1.25)
              for _ in range(2)]
        top_w, top_i, _ = moe.route(x[0], router, k)
        keep = moe.dispatch(top_i, e, moe._capacity(t, k, e, 1.25)).keep
    assert int((~keep).sum()) > 0
    assert torch.equal(ys[0][0].view(torch.int16), ys[1][0].view(torch.int16))
    assert torch.equal(ys[0][1], ys[1][1])


def test_hybrid_prefill_against_decode_on_card(cuda_device):
    """zamba2 at smoke width in float32 on the card: ``prefill`` (SSD at
    chunk 8 over 40 positions) against 40 decode steps (chunk 1) from
    zero state: the last logits, every layer's ``h`` and ``conv`` and
    every group's K/V within 1e-3 of their largest; the decode launches
    no hand-written kernel (the reference's hybrid runs none)."""
    cfg = smoke(get_config("zamba2-2.7b"))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    params = model.init_params(cfg, gen, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, size=(4, 40)).astype(np.int32))
    pos = torch.arange(40, dtype=torch.int32).expand(4, -1)
    want, (st, (k, v)) = model.prefill(cfg, params, toks, pos)
    cache = model.init_cache(cfg, 4, 64, cuda_device)
    for n in (zfp_kernel, cdecode_kernel, sscan_kernel):
        n.reset_launches()
    for i in range(40):
        logits, cache = model.decode_step(cfg, params, cache,
                                          toks[:, i:i + 1], pos[:, i:i + 1])
    assert sum(zfp_kernel.launches.values()) == 0
    assert cdecode_kernel.launches["cdecode"] == sscan_kernel.launches[
        "sscan"] == 0
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    assert rel(logits, want) < 1e-3
    assert rel(cache.h, st.h.flatten(0, 1)) < 1e-3
    assert rel(cache.conv, st.conv.flatten(0, 1)) < 1e-3
    assert rel(cache.k[:, :, :40], k) < 1e-3
    assert rel(cache.v[:, :, :40], v) < 1e-3


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_embeds_compressed_decode_kernels_against_plain(cuda_device, arch):
    """The audio and vision-language front ends over the 16-plane
    compressed cache, smoke width in float32: 72 decode steps fed
    seeded embeddings (qwen2-vl's (3, B, 1) positions with three
    different streams), through the kernels and through the plain
    versions: the logits within 1e-3 of their largest at every step, and
    the kernels launched (cdecode once a layer a step)."""
    cfg = dataclasses.replace(smoke(get_config(arch)), kv_compress_planes=16)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    params = model.init_params(cfg, gen, device=cuda_device)
    emb = torch.randn(4, 72, cfg.d_model, generator=gen, device=cuda_device)
    logs = {}
    for backend in ("cuda", "ref"):
        cdecode_kernel.reset_launches()
        cache = model.init_cache(cfg, 4, 128, cuda_device)
        out = []
        for i in range(72):
            pos = torch.full((4, 1), i, dtype=torch.int32)
            if cfg.mrope_sections:
                pos = torch.stack([pos, pos // 4, pos % 4])
            logits, cache = model.decode_step(cfg, params, cache,
                                              emb[:, i:i + 1], pos,
                                              backend=backend)
            out.append(logits.float())
        logs[backend] = torch.stack(out)
        assert cdecode_kernel.launches["cdecode"] == (
            72 * cfg.num_layers if backend == "cuda" else 0)
    ratio = ((logs["cuda"] - logs["ref"]).abs().amax(dim=(1, 2))
             / logs["ref"].abs().amax(dim=(1, 2)))
    assert float(ratio.max()) < 1e-3

"""Port codec (``repro_torch.kernels.zfp``) against the JAX reference.

Contract: the port's plain version is bit for bit equal to
``repro.kernels.zfp.ref`` on the same float32 input: static tables,
``payload``, ``emax`` and the decoded values. Inputs come from numpy
``default_rng``; the JAX side runs its ``ref`` backend (one jitted
encode/decode per rate over all shapes of a dimensionality) and, for one
small case, its Pallas kernel in interpret mode.

float64 (the paper's type) is held to the same contract against the JAX
reference under ``jax_enable_x64`` (switched on inside ``_x64`` and off
again in its ``finally``), eagerly: ``payload``, ``emax``, the decoded
values and the negabinary words, with bit 63 and the most negative
coefficients. Only the error bound differs, by XLA's float64 ``exp2``,
which is not exact for integer exponents: within ``F64_BOUND_RTOL``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.zfp import ops as jops
from repro.kernels.zfp import ref as jref
from repro_torch.kernels.zfp import kernel as tkernel
from repro_torch.kernels.zfp import ops as tops
from repro_torch.kernels.zfp import ref as tref

SHAPES = {
    1: [(4,), (64,), (1000,), (4096,)],
    2: [(4, 4), (16, 128), (30, 50), (128, 128)],
    3: [(4, 4, 4), (8, 16, 32), (10, 11, 12), (32, 32, 32)],
}
PLANES = [32, 24, 16, 12, 8, 4, 1]


def _data(shape, seed, scale=7.3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _u32(payload) -> np.ndarray:
    if isinstance(payload, torch.Tensor):
        return payload.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(payload)


def _jax_round_trip(xb, planes, ndim):
    """One JAX program: encode, then decode its own payload."""
    payload, emax = jref.encode_blocks(xb, planes, ndim)
    return payload, emax, jref.decode_blocks(payload, emax, planes, ndim,
                                             jnp.float32)


# integer codec arithmetic: the backend's optimization level cannot
# change its result, and level 0 compiles the 21 rate/dimension
# programs of the grid several times faster
_jax_codec = jax.jit(_jax_round_trip, static_argnums=(1, 2),
                     compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_static_tables_equal(ndim):
    assert tref.coeff_levels(ndim) == jref.coeff_levels(ndim)
    for planes in PLANES + [0, 2, 27, 28, 40, 59, 60]:
        for width in (32, 64):
            assert (tref.subband_planes(planes, ndim, width)
                    == jref.subband_planes(planes, ndim, width))
            assert (tref.level_order(planes, ndim, width)
                    == jref.level_order(planes, ndim, width))
            assert (tref.plane_masks(planes, ndim, width)
                    == jref.plane_masks(planes, ndim, width))
            assert (tref.payload_words(ndim, planes, width)
                    == jref.payload_words(ndim, planes, width))
            assert (tref.bits_per_value(ndim, planes, width)
                    == jref.bits_per_value(ndim, planes, width))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_blockify_round_trip_equal(ndim):
    for i, shape in enumerate(SHAPES[ndim] + [(3,) + SHAPES[ndim][2]]):
        x = _data(shape, 7 * i + ndim)
        tb = tref.blockify(torch.from_numpy(x), ndim)
        jb = np.asarray(jref.blockify(jnp.asarray(x), ndim))
        np.testing.assert_array_equal(tb.numpy(), jb)
        back = tref.unblockify(tb, shape, ndim)
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("planes", PLANES)
def test_encode_decode_bitwise_over_grid(planes):
    for ndim, shapes in SHAPES.items():
        xs = [_data(s, 100 * ndim + i) for i, s in enumerate(shapes)]
        tblocks = [tref.blockify(torch.from_numpy(x), ndim) for x in xs]
        xb = torch.cat(tblocks)  # every shape of this ndim in one batch
        tp, te = tref.encode_blocks(xb, planes, ndim)
        jp, je, jd = _jax_codec(jnp.asarray(xb.numpy()), planes, ndim)
        np.testing.assert_array_equal(_u32(tp), np.asarray(jp))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        td = tref.decode_blocks(tp, te, planes, ndim)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        # the fused numerics path equals decode(encode(x))
        np.testing.assert_array_equal(
            tref.quantize_blocks(xb, planes, ndim).numpy(), td.numpy())


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_special_values_bitwise(ndim):
    """Zero blocks, denormal, near-max, mixed-sign rows."""
    n = tref.block_size(ndim)
    rows = np.stack([
        np.zeros(n), np.full(n, 1e-40), np.full(n, 3e38),
        np.linspace(-1e-3, 1e3, n),
        np.where(np.arange(n) % 2 == 0, 1.0, -1.0) * 0.125,
    ]).astype(np.float32)
    shape = {1: (5 * 4,), 2: (5 * 4, 4), 3: (5 * 4, 4, 4)}[ndim]
    x = rows.reshape(shape)
    for planes in (32, 8):
        tc = tops.compress(torch.from_numpy(x), planes=planes, ndim=ndim)
        jc = jops.compress(jnp.asarray(x), planes=planes, ndim=ndim)
        np.testing.assert_array_equal(_u32(tc.payload), np.asarray(jc.payload))
        np.testing.assert_array_equal(tc.emax.numpy(), np.asarray(jc.emax))
        np.testing.assert_array_equal(
            tops.decompress(tc).numpy(), np.asarray(jops.decompress(jc)))


def test_against_pallas_interpret():
    """One small case through the JAX Pallas kernel (interpret mode)."""
    x = _data((10, 11, 12), 3)
    jc = jops.compress(jnp.asarray(x), planes=12, backend="pallas")
    tc = tops.compress(torch.from_numpy(x), planes=12)
    np.testing.assert_array_equal(_u32(tc.payload), np.asarray(jc.payload))
    np.testing.assert_array_equal(tc.emax.numpy(), np.asarray(jc.emax))
    np.testing.assert_array_equal(
        tops.decompress(tc).numpy(),
        np.asarray(jops.decompress(jc, backend="pallas")))


def test_compressed_metadata_and_error_bound():
    x = _data((10, 11, 12), 5)
    tc = tops.compress(torch.from_numpy(x), planes=12)
    jc = jops.compress(jnp.asarray(x), planes=12)
    assert tc.dtype == jc.dtype == "float32"
    assert tc.shape == jc.shape and tc.planes == jc.planes
    assert tc.nbytes() == jc.nbytes() == tops.compressed_nbytes(tc)
    assert tc.compression_ratio == jc.compression_ratio
    tb = tref.max_abs_error_bound(tc.emax, 12, 3)
    jb = jref.max_abs_error_bound(jc.emax, 12, 3, jnp.float32)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    err = (tops.decompress(tc) - torch.from_numpy(x)).abs()
    per_block = tref.blockify(err, 3).amax(dim=1)
    assert bool((per_block <= tb).all())


def test_compress_units_raw_entries():
    xs = [torch.from_numpy(_data((8, 8, 8), s)) for s in range(3)]
    out = tops.compress_units(xs, planes=[12, None, 16])
    assert out[1] is xs[1]
    for c, x, p in ((out[0], xs[0], 12), (out[2], xs[2], 16)):
        jc = jops.compress(jnp.asarray(x.numpy()), planes=p)
        np.testing.assert_array_equal(_u32(c.payload), np.asarray(jc.payload))
    dec = tops.decompress_units([out[0], out[2]])
    np.testing.assert_array_equal(dec[0].numpy(),
                                  tops.decompress(out[0]).numpy())
    with pytest.raises(ValueError, match="length"):
        tops.compress_units(xs, planes=[12, None])


def test_quantize_and_bucket_tile_match_reference():
    x = _data((9, 10, 11), 8)
    np.testing.assert_array_equal(
        tops.quantize(torch.from_numpy(x), planes=12).numpy(),
        np.asarray(jops.quantize(jnp.asarray(x), planes=12)))
    for nb in (0, 1, 2, 3, 5, 64, 255, 256, 257, 10_000):
        assert tops.bucket_tile(nb) == jops.bucket_tile(nb)


def test_kernel_wrappers_use_plain_version_on_cpu():
    x = torch.from_numpy(_data((6, 7, 9), 9))
    payload, emax = tkernel.encode(x, 12)
    c = tops.compress(x, planes=12)
    np.testing.assert_array_equal(_u32(payload), _u32(c.payload))
    y = tkernel.decode(payload, emax, x.shape, 12)
    np.testing.assert_array_equal(y.numpy(), tops.decompress(c).numpy())


def test_float64_codec_not_ported_raises():
    """float64 is ported now: it compresses at the paper's rate and
    round-trips a zero block exactly; a type the codec does not take
    still raises, here and in the kernel wrappers."""
    x = torch.zeros((4, 4, 4), dtype=torch.float64)
    c = tops.compress(x, planes=24)
    assert c.dtype == "float64"
    y = tops.decompress(c)
    assert y.dtype == torch.float64 and not y.any()
    with pytest.raises(TypeError, match="float16"):
        tops.compress(x.half(), planes=24)
    with pytest.raises(TypeError, match="float16"):
        tkernel.decode(c.payload, c.emax, x.shape, 24, dtype="float16")


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_decode_stream_order_is_level_order(ndim):
    """The decode kernel is compiled for two stream orders; the one its
    wrapper picks at each plane count must be ``level_order``'s perm, in
    the JAX reference and in the port (a wrong compile-time table would
    decode wrong bits)."""
    seen = set()
    for planes in range(1, 33):
        order = tkernel.stream_order(planes, ndim)
        perm = tkernel.order_perm(order, ndim)
        assert perm == tuple(jref.level_order(planes, ndim, 32)[0])
        assert perm == tuple(tref.level_order(planes, ndim, 32)[0])
        seen.add(order)
    assert seen == ({0} if ndim == 1 else {0, 1})


_jax_encode = jax.jit(jref.encode_blocks, static_argnums=(1, 2),
                      compiler_options={"xla_backend_optimization_level": 0})


def _register_packed(u: np.ndarray, planes: int, ndim: int) -> np.ndarray:
    """The payload the encode kernel packs in registers (``pack_regs`` in
    ``csrc/zfp_common.cuh``): the masked negabinary words ``u`` (nb, N)
    put in the compile-time stream order (``kernel.order_perm``), each
    plane's field taken over every stream position (the transposed word)
    and appended at ``counts[j]`` bits, in plane order."""
    perm = tkernel.order_perm(tkernel.stream_order(planes, ndim), ndim)
    _, _, counts = tref.level_order(planes, ndim, 32)
    nwords = tref.payload_words(ndim, planes)
    stream = u[:, list(perm)]
    weights = np.uint64(1) << np.arange(stream.shape[1], dtype=np.uint64)
    words = np.zeros((u.shape[0], nwords + 2), np.uint64)
    off = 0
    for j, k in enumerate(counts):
        bits = (stream >> np.uint64(31 - j)) & np.uint64(1)
        field = (bits * weights).sum(axis=1, dtype=np.uint64)
        # the premise: no position at or past counts[j] has plane j's bit
        assert k == 64 or not (field >> np.uint64(k)).any(), (planes, j)
        lo, hi = field & np.uint64(0xFFFFFFFF), field >> np.uint64(32)
        wi, sh = divmod(off, 32)
        sh = np.uint64(sh)
        m32 = np.uint64(0xFFFFFFFF)
        words[:, wi] |= (lo << sh) & m32
        words[:, wi + 1] |= (lo >> (np.uint64(32) - sh)) | ((hi << sh) & m32)
        words[:, wi + 2] |= hi >> (np.uint64(32) - sh)
        off += k
    assert off == tref.payload_bits(ndim, planes)
    assert not words[:, nwords:].any()
    return words[:, :nwords].astype(np.uint32)


@pytest.mark.parametrize("planes", range(1, 33))
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_register_packing_reproduces_reference_payload(ndim, planes):
    """The premise of the register encoder: with the keep-masks, plane j
    has no bit at any stream position at or past ``counts[j]`` (the
    contributors of a plane are a prefix of ``level_order``), so packing
    each plane's whole transposed field, cut to ``counts[j]`` bits,
    reproduces the JAX reference's payload bit for bit."""
    n = tref.block_size(ndim)
    xb = _data((48, n), 100 * ndim + planes)
    xb[0] = 0.0  # an all-zero block
    xb[1] *= 1e-30  # a block at the emax floor
    emax = tref.block_emax(torch.from_numpy(xb))
    c = tref.fwd_transform(tref.to_fixedpoint(torch.from_numpy(xb), emax),
                           ndim)
    u = tref.truncate_planes(tref.to_negabinary(c), planes, ndim)
    got = _register_packed(u.numpy().astype(np.uint64), planes, ndim)
    want, want_emax = _jax_encode(jnp.asarray(xb), planes, ndim)
    np.testing.assert_array_equal(got, _u32(np.asarray(want)))
    np.testing.assert_array_equal(emax.numpy(), np.asarray(want_emax))


# ---------------------------------------------------------------------------
# float64
# ---------------------------------------------------------------------------

# XLA's float64 exp2 of an integer is off by up to ~6e-14 relative (the
# port's torch.exp2 is exact there); the bound itself is exact arithmetic
F64_BOUND_RTOL = 1e-12
F64_PLANES = [24, 32, 64]


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _data64(shape, seed, scale=7.3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * scale


def _f64_bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _f64_special_rows(n):
    """Zero, denormal, huge, mixed-sign and near-2^emax blocks: the last
    ones (-(2 - ulp) beside +(2 - ulp)) give the most negative lifted
    coefficients the float64 codec can make."""
    near = np.nextafter(2.0, 0.0)
    return np.stack([
        np.zeros(n), np.full(n, 5e-324), np.full(n, 1e-310),
        np.full(n, 1e300), np.linspace(-1e-3, 1e3, n),
        np.where(np.arange(n) % 2 == 0, 1.0, -1.0) * 0.125,
        np.where(np.arange(n) % 2 == 0, -near, near),
        np.full(n, -near), np.full(n, 2.0 ** -900) * 3,
    ])


@pytest.mark.parametrize("planes", F64_PLANES)
def test_f64_encode_decode_bitwise_over_grid(planes):
    for ndim, shapes in SHAPES.items():
        n = tref.block_size(ndim)
        xs = [_data64(s, 500 * ndim + i) for i, s in enumerate(shapes)]
        tb = [tref.blockify(torch.from_numpy(x), ndim) for x in xs]
        xb = torch.cat(tb + [torch.from_numpy(_f64_special_rows(n))])
        tp, te = tref.encode_blocks(xb, planes, ndim)
        td = tref.decode_blocks(tp, te, planes, ndim, "float64")
        with _x64():
            jp, je = jref.encode_blocks(jnp.asarray(xb.numpy()), planes, ndim)
            jd = jref.decode_blocks(jp, je, planes, ndim, jnp.float64)
            jp, je, jd = np.asarray(jp), np.asarray(je), np.asarray(jd)
        assert te.dtype == torch.int32 and td.dtype == torch.float64
        assert tp.shape == (xb.shape[0], tref.payload_words(ndim, planes, 64))
        np.testing.assert_array_equal(_u32(tp), jp)
        np.testing.assert_array_equal(te.numpy(), je)
        np.testing.assert_array_equal(_f64_bits(td), _f64_bits(jd))
        np.testing.assert_array_equal(
            _f64_bits(tref.quantize_blocks(xb, planes, ndim)), _f64_bits(td))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_f64_random_payload_decodes_like_reference(ndim):
    """Arbitrary payload words, so every plane, bit 63 included, is set
    somewhere and the int64 negabinary and inverse lift wrap around."""
    rng = np.random.default_rng(ndim)
    for planes in F64_PLANES:
        nw = tref.payload_words(ndim, planes, 64)
        p = rng.integers(0, 2**32, (64, nw), dtype=np.uint64).astype(
            np.uint32)
        e = rng.integers(-900, 900, (64,)).astype(np.int32)
        td = tref.decode_blocks(torch.from_numpy(p.view(np.int32)).view(
            torch.uint32), torch.from_numpy(e), planes, ndim, "float64")
        with _x64():
            jd = np.asarray(jref.decode_blocks(jnp.asarray(p), jnp.asarray(e),
                                               planes, ndim, jnp.float64))
        np.testing.assert_array_equal(_f64_bits(td), _f64_bits(jd))


def test_f64_negabinary_and_packing_at_bit_63():
    """64-bit negabinary in int64 (wrap-around, the mask as its signed
    value) and plane packing with bit 63 set, against the reference's
    uint64 arithmetic."""
    rng = np.random.default_rng(63)
    extremes = np.array([0, 1, -1, 2**62, -2**62, 2**63 - 1, -2**63,
                         -2**58, 2**58, -0x5555555555555556], np.int64)
    c = np.concatenate([extremes, rng.integers(-2**63, 2**63 - 1, 54,
                                               dtype=np.int64)])
    tu = tref.to_negabinary(torch.from_numpy(c))
    with _x64():
        ju = np.asarray(jref.to_negabinary(jnp.asarray(c)))
        jc = np.asarray(jref.from_negabinary(jnp.asarray(ju)))
        words = rng.integers(0, 2**64 - 1, (5, 64), dtype=np.uint64,
                             endpoint=True)
        words[:, 0] |= np.uint64(1 << 63)
        jpack = np.asarray(jref.pack_planes(jnp.asarray(words), 64, 3))
    np.testing.assert_array_equal(tu.numpy().view(np.uint64), ju)
    np.testing.assert_array_equal(tref.from_negabinary(tu, 64).numpy(), jc)
    np.testing.assert_array_equal(jc, c)
    tw = torch.from_numpy(words.view(np.int64))
    tpack = tref.pack_planes(tw, 64, 3, 64)
    np.testing.assert_array_equal(_u32(tpack), jpack)
    np.testing.assert_array_equal(tref.unpack_planes(tpack, 64, 3, 64), tw)


@pytest.mark.parametrize("planes", [4, 8, 16, 24, 32, 48])
def test_f64_error_bound_holds(planes):
    """Port of the error-bound property: every block's round-trip error
    stays under ``max_abs_error_bound``, which is the reference's."""
    x = torch.from_numpy(_data64((12, 13, 14), planes, scale=100.0))
    c = tops.compress(x, planes=planes)
    err = (tops.decompress(c) - x).abs()
    bound = tref.max_abs_error_bound(c.emax, planes, 3, "float64")
    assert bound.dtype == torch.float64
    assert bool((tref.blockify(err, 3).amax(dim=1) <= bound).all())
    with _x64():
        jb = np.asarray(jref.max_abs_error_bound(
            jnp.asarray(c.emax.numpy()), planes, 3, jnp.float64))
    np.testing.assert_allclose(bound.numpy(), jb, rtol=F64_BOUND_RTOL)


@pytest.mark.parametrize("planes", [1, 8, 24, 32, 64])
def test_f64_pack_unpack_and_lift_inverse(planes):
    """Packing keeps exactly the allocated planes (unpack inverts the
    truncated words), and the int64 lift is exactly invertible."""
    rng = np.random.default_rng(planes)
    q = torch.from_numpy(rng.integers(-2**55, 2**55, (40, 64),
                                      dtype=np.int64))
    c = tref.fwd_transform(q, 3)
    assert torch.equal(tref.inv_transform(c, 3), q)
    u = tref.truncate_planes(tref.to_negabinary(c), planes, 3, 64)
    back = tref.unpack_planes(tref.pack_planes(u, planes, 3, 64), planes, 3,
                              64)
    assert torch.equal(back, u)


def test_f64_error_nonincreasing_in_planes_smooth():
    """On smooth data more planes never hurt (monotone rate-distortion)."""
    z = np.linspace(0, 2 * np.pi, 24)
    g = np.meshgrid(z, z, z, indexing="ij")
    x = torch.from_numpy(np.sin(g[0]) * np.cos(g[1]) + 0.3 * np.sin(g[2]))
    errs = [float((tops.quantize(x, planes=p) - x).abs().max())
            for p in (8, 16, 24, 32, 48, 64)]
    assert all(a >= b for a, b in zip(errs, errs[1:])), errs


def test_f64_paper_rates():
    """Port of the reference's paper-rate test: 32/64 and 24/64 hit the
    paper's error ballpark on smooth wave-like data, bit for bit the
    reference's quantize."""
    z = np.linspace(0, 4 * np.pi, 64)
    x, y, zz = np.meshgrid(z, z, z, indexing="ij")
    wave = np.sin(x) * np.cos(0.7 * y) * np.sin(1.3 * zz)
    xt = torch.from_numpy(wave)
    for planes, lo, hi in ((32, 0.0, 5e-7), (24, 0.0, 2e-4)):
        q = tops.quantize(xt, planes=planes)
        rel = float((q - xt).abs().max() / xt.abs().max())
        assert lo <= rel <= hi, (planes, rel)
        with _x64():
            jq = np.asarray(jref.quantize(jnp.asarray(wave), planes, 3))
        np.testing.assert_array_equal(_f64_bits(q), _f64_bits(jq))


def test_f64_compressed_metadata():
    x = torch.from_numpy(_data64((10, 11, 12), 5))
    c = tops.compress(x, planes=24)
    with _x64():
        jc = jops.compress(jnp.asarray(x.numpy()), planes=24)
        jdec = np.asarray(jops.decompress(jc))
        meta = (jc.dtype, jc.nbytes(), jc.compression_ratio)
    assert (c.dtype, c.nbytes(), c.compression_ratio) == meta
    assert c.compression_ratio == 64 / tref.bits_per_value(3, 24)
    np.testing.assert_array_equal(_f64_bits(tops.decompress(c)),
                                  _f64_bits(jdec))


def test_f64_kernel_wrappers_use_plain_version_on_cpu():
    x = torch.from_numpy(_data64((6, 7, 9), 9))
    payload, emax = tkernel.encode(x, 32)
    c = tops.compress(x, planes=32)
    np.testing.assert_array_equal(_u32(payload), _u32(c.payload))
    y = tkernel.decode(payload, emax, x.shape, 32, dtype="float64")
    assert y.dtype == torch.float64
    np.testing.assert_array_equal(_f64_bits(y), _f64_bits(tops.decompress(c)))


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_f64_stream_order_is_level_order(ndim):
    """The float64 kernels' two compile-time stream orders: the one the
    wrapper picks at each plane count (1-64, width 64) is
    ``level_order``'s perm in the reference and in the port."""
    seen = set()
    for planes in range(1, 65):
        order = tkernel.stream_order(planes, ndim, 64)
        perm = tkernel.order_perm(order, ndim)
        assert perm == tuple(jref.level_order(planes, ndim, 64)[0])
        assert perm == tuple(tref.level_order(planes, ndim, 64)[0])
        seen.add(order)
    assert seen == ({0} if ndim == 1 else {0, 1})


def _register_packed64(u: np.ndarray, planes: int, ndim: int) -> np.ndarray:
    """The payload ``csrc/zfp64.cu`` packs in registers: the masked 64-bit
    negabinary words ``u`` (nb, N) in the compile-time stream order, each
    plane's field over every stream position (a transposed word of the
    high halves for planes 0-31, of the low halves after) appended at
    ``counts[j]`` bits, in plane order."""
    perm = tkernel.order_perm(tkernel.stream_order(planes, ndim, 64), ndim)
    _, _, counts = tref.level_order(planes, ndim, 64)
    nwords = tref.payload_words(ndim, planes, 64)
    stream = u[:, list(perm)]
    weights = np.uint64(1) << np.arange(stream.shape[1], dtype=np.uint64)
    words = np.zeros((u.shape[0], nwords + 2), np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    off = 0
    for j, k in enumerate(counts):
        bits = (stream >> np.uint64(63 - j)) & np.uint64(1)
        field = (bits * weights).sum(axis=1, dtype=np.uint64)
        # the premise: no position at or past counts[j] has plane j's bit
        assert k == 64 or not (field >> np.uint64(k)).any(), (planes, j)
        lo, hi = field & m32, field >> np.uint64(32)
        wi, sh = divmod(off, 32)
        sh = np.uint64(sh)
        words[:, wi] |= (lo << sh) & m32
        words[:, wi + 1] |= (lo >> (np.uint64(32) - sh)) | ((hi << sh) & m32)
        words[:, wi + 2] |= hi >> (np.uint64(32) - sh)
        off += k
    assert off == tref.payload_bits(ndim, planes, 64)
    assert not words[:, nwords:].any()
    return words[:, :nwords].astype(np.uint32)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_f64_register_packing_reproduces_payload(ndim):
    """The premise of the float64 register encoder at every plane count
    1-64: packing each plane's whole transposed field, cut to
    ``counts[j]`` bits, gives the plain version's payload bit for bit
    (and that payload is the reference's, above)."""
    n = tref.block_size(ndim)
    xb = _data64((24, n), 700 + ndim)
    xb[0] = 0.0
    xb[1] *= 1e-290
    xb[2] = _f64_special_rows(n)[6]
    xt = torch.from_numpy(xb)
    emax = tref.block_emax(xt)
    c = tref.fwd_transform(tref.to_fixedpoint(xt, emax), ndim)
    for planes in range(1, 65):
        u = tref.truncate_planes(tref.to_negabinary(c), planes, ndim, 64)
        got = _register_packed64(u.numpy().view(np.uint64), planes, ndim)
        want, _ = tref.encode_blocks(xt, planes, ndim)
        np.testing.assert_array_equal(got, _u32(want))

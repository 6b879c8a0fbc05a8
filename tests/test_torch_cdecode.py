"""The port's fused ZFP-decode attention (plain version and ops wrapper)
against ``repro.kernels.cdecode`` run in interpret mode, on the same
compressed cache (the reference's, carried over bit for bit).

Tolerance 2e-5, the reference's own bound between its kernel and its
oracle (``tests/test_cdecode_kernel.py``): the decoded values are equal
bit for bit, the float32 sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cdecode import kernel as jkernel
from repro.kernels.cdecode import ops as jops
from repro.models import kvcache as JKV
from repro_torch.convert import _tensor
from repro_torch.kernels.cdecode import kernel as tkernel
from repro_torch.kernels.cdecode import ops as tops
from repro_torch.kernels.cdecode import ref as tref
from repro_torch.models import kvcache as TKV

B, KVH, D, H = 2, 2, 16, 4
QPK = H // KVH
PLANES = 16
MAX_LEN = TKV.CHUNK * 4
TOL = dict(rtol=2e-5, atol=2e-5)


def _caches(tokens, seed=0):
    rng = np.random.default_rng(seed)
    j = JKV.init_compressed_kv(B, max_len=MAX_LEN, kv_heads=KVH, head_dim=D,
                               planes=PLANES, dtype=jnp.float32)
    for _ in range(tokens):
        k, v = ((0.5 * rng.standard_normal((B, 1, KVH, D))).astype(np.float32)
                for _ in range(2))
        j = JKV.append_token(j, jnp.asarray(k), jnp.asarray(v), planes=PLANES)
    fields = [_tensor(np.asarray(a), torch.device("cpu")) for a in j[:6]]
    return j, TKV.CompressedKV(*fields, int(j.length))


def _rows(c):
    """(B, KVH, NB, ...) -> (B*KVH, NB, ...) for payload and emax."""
    return [a.reshape((B * KVH,) + tuple(a.shape[2:])) for a in c[:4]]


@pytest.mark.parametrize("tokens", [7, TKV.CHUNK, TKV.CHUNK + 11,
                                    3 * TKV.CHUNK + 5])
def test_plain_partials_and_ops_match_reference(tokens):
    j, t = _caches(tokens)
    q = np.random.default_rng(7).standard_normal((B, 1, H, D)).astype(
        np.float32)
    # the wrapper: port plain version vs the reference kernel (interpret)
    out_j = jops.fused_compressed_decode_attention(
        jnp.asarray(q), j, planes=PLANES, max_len=MAX_LEN)
    out_t = tops.fused_compressed_decode_attention(
        torch.from_numpy(q), t, planes=PLANES, max_len=MAX_LEN)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    # the kernel's partials on their own
    qs = (q.reshape(B, KVH, QPK, D) / np.sqrt(np.float32(D))).reshape(
        B * KVH, QPK, D).astype(np.float32)
    hist = (tokens // TKV.CHUNK) * TKV.CHUNK
    jargs = [jnp.asarray(np.asarray(a).reshape((B * KVH,) + a.shape[2:]))
             for a in j[:4]]
    want = jkernel.fused_cdecode_attention(
        *jargs, jnp.asarray(qs), jnp.full((1, 1), hist, jnp.int32),
        planes=PLANES, head_dim=D, qpk=QPK)
    got = tref.fused_cdecode_attention_ref(
        *_rows(t), torch.from_numpy(qs), hist, planes=PLANES, head_dim=D,
        qpk=QPK)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    # the CUDA wrapper on a CPU tensor runs the plain version
    for g, w in zip(tkernel.fused_cdecode_attention(
            *_rows(t), torch.from_numpy(qs), hist, planes=PLANES, head_dim=D,
            qpk=QPK), got):
        assert torch.equal(g, w)


def test_decode_tiles_are_the_codec_decode():
    """The tile layout is the codec's own decode of the (CHUNK, D)
    chunk, bit for bit."""
    _, t = _caches(2 * TKV.CHUNK, seed=3)
    rows = _rows(t)
    tiles = tref.decode_tiles(rows[0], rows[1], PLANES, D)
    whole = TKV._decode_all(t.payload_k, t.emax_k, PLANES, MAX_LEN, D,
                            torch.float32)  # (B, S, KVH, D)
    want = whole.movedim(2, 1).reshape(B * KVH, MAX_LEN, D)
    assert torch.equal(tiles, want)


def test_reference_is_the_compositional_oracle():
    assert tref.reference is TKV.compressed_decode_attention


def test_merge_weighs_empty_states_zero():
    m = torch.tensor([[1.5], [float("-inf")]])
    l = torch.tensor([[2.0], [0.0]])
    acc = torch.tensor([[[4.0, 6.0]], [[0.0, 0.0]]])
    mm, ll, aa = tref.merge(m, l, acc, dim=0)
    assert torch.equal(mm, m[0]) and torch.equal(ll, l[0])
    assert torch.equal(aa, acc[0])
    mm, ll, aa = tref.merge(m[1:].expand(2, 1), l[1:].expand(2, 1),
                            acc[1:].expand(2, 1, 2), dim=0)
    assert mm.isinf().all() and (ll == 0).all() and (aa == 0).all()


def test_split_plan_covers_every_chunk():
    for rows in (1, 16, 32, 300):
        for live in (0, 1, 5, 468, 511):
            nsplit, per = tkernel.split_plan(rows, live)
            assert nsplit >= 1
            if live:
                assert (nsplit - 1) * per < live <= nsplit * per
            else:
                assert per == 0


def test_split_plan_covers_every_band_once():
    """Every live band lies in exactly one CTA's run; runs longer than a
    chunk are whole chunks; the serving cache's 16 rows with 4 live
    chunks give at least 256 CTAs."""
    for rows in (1, 16, 32, 300):
        for live in range(0, 70):
            nsplit, per = tkernel.split_plan(rows, live)
            runs = [range(s * per, min((s + 1) * per, live))
                    for s in range(nsplit)]
            covered = [b for r in runs for b in r]
            assert covered == list(range(live))
            assert all(len(r) > 0 for r in runs) or live == 0
            if per > tkernel.BANDS_PER_CHUNK:
                assert per % tkernel.BANDS_PER_CHUNK == 0
    serving = tkernel.live_bands(4 * TKV.CHUNK, 4 * D)  # 16 bands
    nsplit, per = tkernel.split_plan(16, serving)
    assert 16 * nsplit >= 256 and per == 1


def test_live_bands():
    assert tkernel.live_bands(0, 10) == 0
    assert tkernel.live_bands(1, 10) == 1
    assert tkernel.live_bands(48, 10) == 3
    assert tkernel.live_bands(3 * TKV.CHUNK + 16, 100) == 13
    assert tkernel.live_bands(10 ** 6, 10) == 10


def test_decoded_tiles_on_cpu_are_the_codec_decode():
    """The band decode check's CPU side: bands cut from the codec's
    decode of whole chunks, mid-chunk starts included."""
    _, t = _caches(3 * TKV.CHUNK, seed=4)
    rows = _rows(t)
    whole = tref.decode_tiles(rows[0], rows[1], PLANES, D)
    for band0, nbands in ((0, 4), (1, 2), (3, 6), (11, 1)):
        k, v = tkernel.decoded_tiles(*rows, planes=PLANES, head_dim=D,
                                     band0=band0, nbands=nbands)
        assert torch.equal(k, whole[:, band0 * 16:(band0 + nbands) * 16])
        assert v.shape == k.shape


def test_cdecode_partials_on_cpu_are_one_split():
    """On a CPU tensor the kernel wrapper's unmerged partials are the
    plain version's, as one split."""
    _, ckv = _caches(TKV.CHUNK + 11, seed=2)
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 1, H, D)).astype(np.float32))
    args, kw = tops.history_inputs(q, ckv)
    assert args[5] == TKV.CHUNK and kw == dict(head_dim=D, qpk=QPK)
    split = tkernel.cdecode_partials(*args, planes=PLANES, **kw)
    whole = tref.fused_cdecode_attention_ref(*args, planes=PLANES, **kw)
    for s, w in zip(split, whole):
        assert s.shape[1] == 1
        torch.testing.assert_close(s[:, 0], w, rtol=0, atol=0)

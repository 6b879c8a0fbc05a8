"""The port's compressed KV cache against ``repro.models.kvcache`` on the
same numpy tokens.

Contract: the cache's contents (payload, emax, tail, length) are bit for
bit the reference's across a chunk boundary (the codec's contract); the
compositional attention is within 2e-5 (float32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as JKV
from repro_torch.models import kvcache as TKV

B, KVH, D, H = 2, 2, 16, 4
PLANES = 16
MAX_LEN = TKV.CHUNK * 4


def _tokens(n, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple((0.5 * rng.standard_normal((B, 1, KVH, D))).astype(
        np.float32) for _ in range(2)) for _ in range(n)]


def _fill(n, seed=0):
    j = JKV.init_compressed_kv(B, max_len=MAX_LEN, kv_heads=KVH, head_dim=D,
                               planes=PLANES, dtype=jnp.float32)
    t = TKV.init_compressed_kv(B, max_len=MAX_LEN, kv_heads=KVH, head_dim=D,
                               planes=PLANES, dtype=torch.float32,
                               device="cpu")
    for k, v in _tokens(n, seed):
        j = JKV.append_token(j, jnp.asarray(k), jnp.asarray(v), planes=PLANES)
        t = TKV.append_token(t, torch.from_numpy(k), torch.from_numpy(v),
                             planes=PLANES)
    return j, t


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).numpy() if x.dtype == torch.uint32 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_init_shapes_and_bytes():
    j, t = _fill(0)
    for name in JKV.CompressedKV._fields[:6]:
        assert tuple(getattr(t, name).shape) == getattr(j, name).shape, name
    assert TKV.compressed_bytes(t) == JKV.compressed_bytes(j)
    with pytest.raises(ValueError, match="multiple"):
        TKV.init_compressed_kv(B, 100, KVH, D, PLANES, device="cpu")


@pytest.mark.parametrize("tokens", [TKV.CHUNK - 1, TKV.CHUNK + 9])
def test_append_token_bitwise(tokens):
    j, t = _fill(tokens)
    assert t.length == int(j.length) == tokens
    for name in JKV.CompressedKV._fields[:6]:
        np.testing.assert_array_equal(_bits(getattr(t, name)),
                                      _bits(getattr(j, name)), err_msg=name)
    assert TKV.compressed_bytes(t) == JKV.compressed_bytes(j)


@pytest.mark.parametrize("tokens", [5, TKV.CHUNK, 2 * TKV.CHUNK + 3])
def test_compressed_attention_matches_reference(tokens):
    j, t = _fill(tokens, seed=tokens)
    q = np.random.default_rng(99).standard_normal((B, 1, H, D)).astype(
        np.float32)
    out_j = JKV.compressed_decode_attention(jnp.asarray(q), j, planes=PLANES,
                                            max_len=MAX_LEN)
    out_t = TKV.compressed_decode_attention(torch.from_numpy(q), t,
                                            planes=PLANES, max_len=MAX_LEN)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=2e-5, atol=2e-5)


def test_chunks_are_independent():
    """Appending never changes previously compressed chunks (paper
    Fig. 3), though the port writes the cache in place."""
    _, t = _fill(TKV.CHUNK)
    before = t.payload_k.view(torch.int32).clone()
    ones = torch.ones((B, 1, KVH, D))
    for _ in range(TKV.CHUNK):
        t = TKV.append_token(t, ones, ones, planes=PLANES)
    nbc = TKV._nb_per_chunk(D)
    after = t.payload_k.view(torch.int32)
    assert torch.equal(after[:, :, :nbc], before[:, :, :nbc])
    assert not torch.equal(after[:, :, nbc:2 * nbc], before[:, :, nbc:2 * nbc])


def test_full_cache_raises():
    t = TKV.init_compressed_kv(1, TKV.CHUNK, 1, 4, 8, dtype=torch.float32,
                               device="cpu")
    x = torch.zeros((1, 1, 1, 4))
    for _ in range(TKV.CHUNK):
        t = TKV.append_token(t, x, x, planes=8)
    for _ in range(TKV.CHUNK - 1):
        t = TKV.append_token(t, x, x, planes=8)
    with pytest.raises(ValueError, match="full"):
        TKV.append_token(t, x, x, planes=8)

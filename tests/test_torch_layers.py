"""The port's layers against ``repro.models.layers`` in float32, on the
same numpy inputs.

Tolerances: elementwise float32 code (norms, RoPE) is held to 2e-6
relative (XLA and PyTorch may differ by an ulp in rsqrt, sin and cos);
code with sums (attention, GLU) to 1e-5 (the order of the float32 sums
differs); blocked attention (ragged S = 37 over chunks of 8) to rtol =
atol = 2e-5 against the reference and against a float64 softmax over the
whole score matrix, its gradients to rtol 1e-4 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

B, S, H, KVH, D = 2, 5, 4, 2, 16


def _rng(seed):
    return np.random.default_rng(seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(t, j, rtol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=rtol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = _rng(1)
    x = (3 * rng.standard_normal((B, S, 64)) + 0.5).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    (jx, tx), (js, ts) = _both(x), _both(scale)
    _close(TL.norm(tx, ts, 1e-6, kind), JL.norm(jx, js, 1e-6, kind), 2e-6)
    fn_t = TL.rms_norm if kind == "rmsnorm" else TL.layer_norm
    fn_j = JL.rms_norm if kind == "rmsnorm" else JL.layer_norm
    _close(fn_t(tx, ts, 1e-5), fn_j(jx, js, 1e-5), 2e-6)


def test_rope_freqs():
    _close(TL.rope_freqs(D, 1e6), JL.rope_freqs(D, 1e6), 2e-6)


@pytest.mark.parametrize("mrope", [(), (2, 3, 3)])
def test_apply_rope(mrope):
    rng = _rng(2)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    shape = (3, B, S) if mrope else (B, S)
    pos = rng.integers(0, 5000, size=shape).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _close(TL.apply_rope(tx, tp, 1e6, mrope),
           JL.apply_rope(jx, jp, 1e6, mrope), 2e-6)


def test_cache_update_and_decode_attention():
    rng = _rng(3)
    smax = 12
    cache_k = rng.standard_normal((B, smax, KVH, D)).astype(np.float32)
    cache_v = rng.standard_normal((B, smax, KVH, D)).astype(np.float32)
    new = rng.standard_normal((B, 1, KVH, D)).astype(np.float32)
    idx = np.array([3, 9], np.int32)
    jk = JL.batched_cache_update(jnp.asarray(cache_k), jnp.asarray(new),
                                 jnp.asarray(idx))
    tk = TL.batched_cache_update(torch.from_numpy(cache_k.copy()),
                                 torch.from_numpy(new), torch.from_numpy(idx))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))

    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    length = idx + 1
    out_j = JL.decode_attention(jnp.asarray(q), jk, jnp.asarray(cache_v),
                                jnp.asarray(length))
    out_t = TL.decode_attention(torch.from_numpy(q), tk,
                                torch.from_numpy(cache_v),
                                torch.from_numpy(length))
    assert out_t.shape == (B, 1, H, D)
    _close(out_t, out_j, 1e-5)


def test_glu_mlp():
    rng = _rng(4)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 128)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.standard_normal((128, 64)).astype(np.float32) / 11
    args = [x, wg, wu, wd]
    _close(TL.glu_mlp(*(torch.from_numpy(a) for a in args)),
           JL.glu_mlp(*(jnp.asarray(a) for a in args)), 1e-5)


def test_bfloat16_promotions_match():
    """bf16 in, bf16 out, float32 inside: the norm, RoPE and attention
    round where the reference rounds (compared after the cast back, to
    one bf16 ulp)."""
    rng = _rng(5)
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 300, size=(B, S)).astype(np.int32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    j = JL.apply_rope(jx, jnp.asarray(pos), 1e6)
    t = TL.apply_rope(tx, torch.from_numpy(pos), 1e6)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)


# ----------------------------------------------------------------------
# blocked attention (training / prefill)
# ----------------------------------------------------------------------

ATT_S, ATT_CHUNK = 37, 8  # ragged: the last chunk holds 5 keys
ATT_TOL = dict(rtol=2e-5, atol=2e-5)


def _naive_attention(q, k, v, causal):
    """Softmax attention in float64, the whole score matrix at once."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    logits = np.einsum("bshd,bthd->bhst", q, k) / np.sqrt(d)
    if causal:
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhst,bthd->bshd", p, v)


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_matches_reference_and_naive(causal):
    rng = _rng(6)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, ATT_S, H, D), (B, ATT_S, KVH, D), (B, ATT_S, KVH, D)))
    out_j = JL.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_chunk=ATT_CHUNK,
                                 causal=causal)
    out_t = TL.blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_chunk=ATT_CHUNK,
                                 causal=causal)
    assert out_t.shape == (B, ATT_S, H, D) and out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **ATT_TOL)
    np.testing.assert_allclose(
        out_t.numpy(),
        _naive_attention(*(a.astype(np.float64) for a in (q, k, v)), causal),
        **ATT_TOL)


def test_blocked_attention_gradient_matches_reference():
    """The online softmax is differentiable with its guards: gradients of
    a causal ragged case against ``jax.grad`` of the reference."""
    import jax

    rng = _rng(7)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, ATT_S, H, D), (B, ATT_S, KVH, D), (B, ATT_S, KVH, D)))
    w = rng.standard_normal((B, ATT_S, H, D)).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(JL.blocked_attention(
        a, b, c, kv_chunk=ATT_CHUNK) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TL.blocked_attention(tq, tk, tv, kv_chunk=ATT_CHUNK)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for t, j in zip(tg, jg):
        assert bool(torch.isfinite(t).all())
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


def test_blocked_attention_bfloat16_upcasts_products():
    """bf16 operands: scores and the weighted sum accumulate in float32
    (the reference's ``preferred_element_type``), within two bf16 ulps of
    the reference after the caller's cast back to bf16."""
    rng = _rng(8)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((B, ATT_S, H, D), (B, ATT_S, KVH, D), (B, ATT_S, KVH, D)))
    out_j = JL.blocked_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), kv_chunk=ATT_CHUNK)
    out_t = TL.blocked_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                   for a in (q, k, v)), kv_chunk=ATT_CHUNK)
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(
        out_t.to(torch.bfloat16).float().numpy(),
        np.asarray(out_j.astype(jnp.bfloat16).astype(jnp.float32)),
        rtol=2 ** -6, atol=2 ** -6)

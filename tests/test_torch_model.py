"""The port's dense decoder against ``repro.models.model``: the same
parameters (the reference's, carried over by ``convert``) and the same
numpy tokens, 70 teacher-forced decode steps over the raw and the
compressed KV cache, at smoke size in float32.

Tolerances on the logits: 1e-4 over the raw cache, where float32 sums
in another order (XLA vs PyTorch matmuls) move a logit by ~1e-6. 5e-3
over the compressed cache: there the K and V that reach the codec are
one ulp apart, and that may flip the lowest kept bit plane of a
coefficient, which at 16 planes in 2-D is worth 2^-8 of its block's
largest value (one such flip moved a logit by 4.8e-4 here; the cache's
bits are otherwise the reference's).

The SSM family (falcon-mamba smoke, float32): logits within 1e-4 as
over the raw cache, the ``conv`` and ``h`` states within rtol 1e-4 /
atol 1e-5 (the selective scan's bound); the port's decode against its
own prefill within rtol = atol = 2e-3, the bound of
``tests/test_models_smoke.py::test_decode_matches_prefill``.

The dense full-sequence path (smoke configs, S = 37, ragged against the
32-token attention chunk): hidden states, prefill logits and the stacked
K/V within rtol = atol = 1e-4 as over the raw cache; ``loss_fn`` within
1e-5 relative, and its gradients under remat none, full and dots within
rtol 1e-4 / atol 1e-5, leaf by leaf in the reference's stacked layout
(float32 sums in another order, through blocked attention's online
softmax and its backward).

The MoE family (qwen3-moe and llama4-scout smoke, float32) with the
same tolerances: forward (hidden, the summed load-balance loss within
1e-6 relative, K/V), prefill, ``loss_fn`` and every gradient under
remat none and compressed, 70 decode steps over the raw and the
compressed cache, and the port's decode against its own prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config, smoke, ARCH_IDS
from repro_torch.models import model as TM

STEPS = 70  # crosses the first 64-token chunk boundary
B, MAX_LEN = 2, 128
TOL = {0: dict(rtol=1e-4, atol=1e-4), 16: dict(rtol=5e-3, atol=5e-3)}


def _cfgs(arch, planes):
    j = dataclasses.replace(jsmoke(jget_config(arch)),
                            kv_compress_planes=planes)
    t = dataclasses.replace(smoke(get_config(arch)), kv_compress_planes=planes)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _params(jcfg, tcfg, seed):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    leaves = jax.tree.map(np.asarray, jp)
    return jp, convert.params_from_reference(tcfg, leaves, "cpu")


def _cache_leaves(cache):
    return {k: None if v is None else np.asarray(v)
            for k, v in cache._asdict().items()}


def _run(jcfg, tcfg, jp, tp, jcache, tcache, toks, start, stop):
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    for i in range(start, stop):
        t = toks[:, i:i + 1]
        ps = np.full((B, 1), i, np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(t), jnp.asarray(ps))
        lt, tcache = TM.decode_step(tcfg, tp, tcache, torch.from_numpy(t),
                                    torch.from_numpy(ps))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   err_msg=f"step {i}",
                                   **TOL[tcfg.kv_compress_planes])
        assert tcache.length == int(jcache.length) == i + 1
    return jcache, tcache


@pytest.mark.parametrize("planes", [0, 16])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "command-r-35b"])
def test_decode_step_matches_reference(arch, planes):
    jcfg, tcfg = _cfgs(arch, planes)
    jp, tp = _params(jcfg, tcfg, seed=len(arch))
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    assert type(tcache).__name__ == type(jcache).__name__
    _run(jcfg, tcfg, jp, tp, jcache, tcache, toks, 0, STEPS)


@pytest.mark.parametrize("planes", [0, 16])
def test_resume_reference_cache_mid_sequence(planes):
    """A reference cache taken mid-sequence (inside the second chunk)
    continues in the port."""
    jcfg, tcfg = _cfgs("qwen2-1.5b", planes)
    jp, tp = _params(jcfg, tcfg, seed=4)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    for i in range(40):
        _, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.full((B, 1), i, jnp.int32))
    tcache = convert.cache_from_reference(_cache_leaves(jcache), "cpu")
    assert isinstance(tcache, TM.CompressedCache if planes
                      else TM.DecodeCache) and tcache.length == 40
    _run(jcfg, tcfg, jp, tp, jcache, tcache, toks, 40, STEPS)


def test_params_carry_over_one_to_one():
    jcfg, tcfg = _cfgs("qwen2-1.5b", 0)
    jp, tp = _params(jcfg, tcfg, seed=0)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_ref
    np.testing.assert_array_equal(tp.layers[1].bq.numpy(),
                                  np.asarray(jp["layers"]["bq"][1]))
    # tied configs still carry their own lm_head, as in the reference
    assert tcfg.tie_embeddings and tp.lm_head.shape == (64, 256)
    bad = jax.tree.map(np.asarray, jp)
    del bad["layers"]["bq"]
    with pytest.raises(KeyError):
        convert.params_from_reference(tcfg, bad, "cpu")


def test_init_params_draws_the_reference_distribution():
    cfg = smoke(get_config("qwen2-1.5b"))
    gen = torch.Generator().manual_seed(0)
    p = TM.init_params(cfg, gen, device="cpu")
    lp = p.layers[0]
    assert torch.equal(lp.ln1, torch.ones(64)) and torch.equal(
        lp.bq, torch.zeros(64))
    assert abs(float(lp.wq.std()) - 64 ** -0.5) < 0.02
    assert abs(float(p.embed.std()) - 0.02) < 0.002
    q = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                q.parameters()))


def test_every_arch_resolves_and_other_families_raise_at_init():
    """No family raises any more: every arch's smoke config inits its
    parameters (as many values as the reference's tree) and its cache
    (the reference's fields and shapes) on the CPU."""
    for arch in ARCH_IDS:
        jcfg, cfg = jsmoke(jget_config(arch)), smoke(get_config(arch))
        params = TM.init_params(cfg, device="cpu")
        shapes = jax.eval_shape(
            lambda k: JM.init_params(jcfg, k), jax.random.PRNGKey(0))
        assert sum(p.numel() for p in params.parameters()) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)), arch
        cache = TM.init_cache(cfg, 1, 64, device="cpu")
        want = JM.init_cache(jcfg, 1, 64)
        assert type(cache).__name__ == type(want).__name__, arch
        for name, w in want._asdict().items():
            got = getattr(cache, name)
            if name == "length" or w is None:
                assert got in (0, None) and (w is None) == (got is None)
                continue
            assert tuple(got.shape) == w.shape, (arch, name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_on_meta_matches_param_specs(arch):
    """``init_params(cfg, device="meta")`` (the dry run's parameters):
    every parameter with ``param_specs``' name, shape and type, on
    ``meta``, at full width and depth, no generator and no card."""
    cfg = get_config(arch)
    got = dict(TM.init_params(cfg, device="meta").named_parameters())
    want = TM.param_specs(cfg)
    assert list(got) == list(want)
    for name, spec in want.items():
        t = got[name]
        assert (t.device.type, t.shape, t.dtype) == (
            "meta", spec.shape, spec.dtype), (arch, name)


def test_bfloat16_params_carry_over_bitwise():
    """The config's own bfloat16 crosses as its bits (numpy's bfloat16
    has no torch counterpart)."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs("qwen2-1.5b", 0))
    jp, tp = _params(jcfg, tcfg, seed=1)
    assert tp.layers[0].wq.dtype == torch.bfloat16
    want = np.asarray(jp["layers"]["wq"][0]).view(np.uint16)
    np.testing.assert_array_equal(tp.layers[0].wq.view(torch.int16).numpy()
                                  .view(np.uint16), want)


# ----------------------------------------------------------------------
# the SSM family (falcon-mamba, Mamba-1)
# ----------------------------------------------------------------------

SSM_ARCH, SSM_STEPS = "falcon-mamba-7b", 20
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _ssm_setup(seed, dtype="float32"):
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype)
                  for c in _cfgs(SSM_ARCH, 0))
    jp, tp = _params(jcfg, tcfg, seed)
    toks = np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, size=(B, SSM_STEPS)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


def _ssm_run(jcfg, tcfg, jp, tp, jcache, tcache, toks, start, stop):
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    for i in range(start, stop):
        t = toks[:, i:i + 1]
        ps = np.full((B, 1), i, np.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(t), jnp.asarray(ps))
        lt, tcache = TM.decode_step(tcfg, tp, tcache, torch.from_numpy(t),
                                    torch.from_numpy(ps))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   err_msg=f"step {i}", **TOL[0])
        for name in ("conv", "h"):
            np.testing.assert_allclose(
                getattr(tcache, name).numpy(),
                np.asarray(getattr(jcache, name)),
                err_msg=f"{name} after step {i}", **STATE_TOL)
        assert tcache.length == int(jcache.length) == i + 1
    return jcache, tcache


def test_ssm_decode_step_matches_reference():
    jcfg, tcfg, jp, tp, toks = _ssm_setup(seed=3)
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    assert tcache.k is None and tcache.v is None
    assert tcache.conv.shape == jcache.conv.shape
    assert tcache.h.shape == jcache.h.shape and tcache.h.dtype == torch.float32
    _ssm_run(jcfg, tcfg, jp, tp, jcache, tcache, toks, 0, SSM_STEPS)


def test_ssm_prefill_matches_reference():
    jcfg, tcfg, jp, tp, toks = _ssm_setup(seed=5)
    pos = np.tile(np.arange(SSM_STEPS, dtype=np.int32), (B, 1))
    lj, sj = JM.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    lt, st = TM.prefill(tcfg, tp, torch.from_numpy(toks),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL[0])
    for name in ("conv", "h"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   **STATE_TOL)


def test_ssm_decode_matches_own_prefill():
    _, tcfg, _, tp, toks = _ssm_setup(seed=6)
    pos = np.tile(np.arange(SSM_STEPS, dtype=np.int32), (B, 1))
    want, states = TM.prefill(tcfg, tp, torch.from_numpy(toks),
                              torch.from_numpy(pos))
    cache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    for i in range(SSM_STEPS):
        logits, cache = TM.decode_step(tcfg, tp, cache,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       torch.from_numpy(pos[:, i:i + 1]))
    torch.testing.assert_close(logits, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(cache.h, states.h, rtol=2e-3, atol=2e-3)


def test_ssm_resume_reference_cache_mid_sequence():
    """A reference ssm ``DecodeCache`` (no K, no V) taken after 9 steps
    continues in the port."""
    jcfg, tcfg, jp, tp, toks = _ssm_setup(seed=8)
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    for i in range(9):
        _, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                         jnp.full((B, 1), i, jnp.int32))
    tcache = convert.cache_from_reference(_cache_leaves(jcache), "cpu")
    assert isinstance(tcache, TM.DecodeCache) and tcache.length == 9
    assert tcache.k is None and tcache.v is None
    _ssm_run(jcfg, tcfg, jp, tp, jcache, tcache, toks, 9, SSM_STEPS)


def test_ssm_a_log_and_d_stay_float32_under_bfloat16():
    jcfg, tcfg, jp, tp, _ = _ssm_setup(seed=2, dtype="bfloat16")
    lp = tp.layers[0]
    assert lp.in_proj.dtype == lp.dt_b.dtype == torch.bfloat16
    assert lp.A_log.dtype == lp.D.dtype == torch.float32
    np.testing.assert_array_equal(lp.A_log.numpy(),
                                  np.asarray(jp["layers"]["A_log"][0]))
    want = np.asarray(jp["layers"]["in_proj"][0]).view(np.uint16)
    np.testing.assert_array_equal(
        lp.in_proj.view(torch.int16).numpy().view(np.uint16), want)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu").layers[0]
    assert own.A_log.dtype == own.D.dtype == torch.float32
    assert own.conv_w.dtype == torch.bfloat16
    n = tcfg.ssm_state
    torch.testing.assert_close(
        own.A_log, torch.log(torch.arange(1, n + 1.0)).expand(
            tcfg.d_inner, n), rtol=0, atol=0)
    assert torch.equal(own.D, torch.ones(tcfg.d_inner))
    assert torch.equal(own.dt_b.float(), torch.full((tcfg.d_inner,), -4.6,
                                                    dtype=torch.bfloat16).float())
    assert torch.equal(own.conv_b.float(), torch.zeros(tcfg.d_inner))
    # conv_w's fan is the kernel width, not d_inner
    assert abs(float(own.conv_w.float().std()) - tcfg.ssm_conv ** -0.5) < 0.05


def test_dense_forward_is_not_ported():
    """Every family's forward and loss are ported now (the name is kept
    from when a family was refused): the dense prefill runs, and the ssm
    family's loss, once refused (a gradient through the selective
    scan), is finite and reaches every weight."""
    cfg = smoke(get_config("qwen2-1.5b"))
    params = TM.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    logits, (k, v) = TM.prefill(cfg, params, toks, toks)
    assert logits.shape == (1, cfg.vocab_size) and k.shape == v.shape
    scfg = smoke(get_config("falcon-mamba-7b"))
    sparams = TM.init_params(scfg, device="cpu")
    batch = {"tokens": toks, "labels": toks, "positions": toks}
    sparams.requires_grad_(True)
    loss = TM.loss_fn(scfg, sparams, batch)
    assert torch.isfinite(loss)
    grads = torch.autograd.grad(loss, list(sparams.parameters()),
                                allow_unused=True)
    assert all(g is not None for g in grads)
    assert not hasattr(TM, "SSM_TRAINING_ITEM")


# ----------------------------------------------------------------------
# the dense full-sequence forward, prefill and loss (training)
# ----------------------------------------------------------------------

SEQ = 37  # ragged against the smoke config's 32-token attention chunk
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _dense_setup(arch, seed, remat="none"):
    jcfg, tcfg = (dataclasses.replace(c, remat=remat)
                  for c in _cfgs(arch, 0))
    jp, tp = _params(jcfg, tcfg, seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, size=(B, SEQ)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, size=(B, SEQ)).astype(np.int32)
    labels[0, -5:] = -1  # masked positions
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (B, 1))
    batch = {"tokens": toks, "labels": labels, "positions": pos}
    return jcfg, tcfg, jp, tp, batch


def _ref_layout(model, tensors):
    """Port gradients (in ``named_parameters`` order) as the reference's
    tree."""
    return convert._to_reference_tree(
        dict(zip((n for n, _ in model.named_parameters()), tensors)))


HYB_SHARE = 1e-3


def _grads_match(tp, tg, jg, share=0.0):
    """The port's gradients (``named_parameters`` order) against the
    reference's tree, leaf by leaf, ``shared_attn`` included, within
    ``GRAD_TOL``; a share ``share`` of a leaf's elements may miss it,
    and those are held within 1e-4 of the leaf's largest |gradient|."""
    got, want = _ref_layout(tp, tg), jax.tree.map(np.asarray, jg)
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            assert set(got[key]) == set(want[key]), key
        pairs = (want[key].items() if isinstance(want[key], dict)
                 else [(None, want[key])])
        for name, w in pairs:
            g = got[key][name] if name is not None else got[key]
            off = ~np.isclose(g, w, **GRAD_TOL)
            assert off.sum() <= share * off.size, (key, name, int(off.sum()))
            np.testing.assert_allclose(
                g, w, err_msg=f"{key}/{name}", rtol=GRAD_TOL["rtol"],
                atol=max(GRAD_TOL["atol"], 1e-4 * np.abs(w).max())
                if share else GRAD_TOL["atol"])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "command-r-35b"])
def test_dense_forward_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp, batch = _dense_setup(arch, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, jaux, jkv = JM.forward(jcfg, jp, jb["tokens"], jb["positions"],
                               collect_cache=True)
    th, taux, tkv = TM.forward(tcfg, tp, batch["tokens"],
                               batch["positions"], collect_cache=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **FWD_TOL)
    assert float(taux) == float(jaux) == 0.0
    for t, j in zip(tkv, jkv):
        assert t.shape == j.shape == (tcfg.num_layers, B, SEQ,
                                      tcfg.num_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **FWD_TOL)
    jl, (jk, jv) = JM.prefill(jcfg, jp, jb["tokens"], jb["positions"])
    tl, (tk, tv) = TM.prefill(tcfg, tp, batch["tokens"], batch["positions"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **FWD_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD_TOL)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "command-r-35b"])
def test_dense_loss_and_gradients_match_reference(arch, remat):
    jcfg, tcfg, jp, tp, batch = _dense_setup(arch, seed=12, remat=remat)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jp)
    tp.requires_grad_(True)
    tl = TM.loss_fn(tcfg, tp, batch)
    tg = torch.autograd.grad(tl, list(tp.parameters()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _grads_match(tp, tg, jg)


def test_dense_remat_policies_agree_in_the_port():
    """none, full and dots recompute the same operations: the same loss
    and gradients, bit for bit, on the CPU."""
    out = {}
    for remat in ("none", "full", "dots"):
        _, tcfg, _, tp, batch = _dense_setup("qwen2-1.5b", 13, remat)
        tp.requires_grad_(True)
        loss = TM.loss_fn(tcfg, tp, batch)
        out[remat] = (loss, torch.autograd.grad(loss, list(tp.parameters())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "full", "dots", "compressed"])
def test_ssm_loss_and_gradients_match_reference(remat):
    """falcon-mamba (smoke, float32): ``loss_fn`` and every gradient
    against ``jax.grad`` of ``repro``'s, each Mamba-1 layer under the
    remat policy (compressed: the layer's hidden state and weights coded
    at 12 planes, as the reference codes them), the scan differentiated
    through its plain version; ``LOSS_RTOL`` and ``GRAD_TOL``."""
    jcfg, tcfg, jp, tp, batch = _dense_setup("falcon-mamba-7b", seed=41,
                                             remat=remat)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jp)
    tp.requires_grad_(True)
    tl = TM.loss_fn(tcfg, tp, batch)
    tg = torch.autograd.grad(tl, list(tp.parameters()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _grads_match(tp, tg, jg)


def test_ssm_forward_and_prefill_keep_their_cache():
    """The ssm forward, now under ``_remat``, returns the same hidden
    state and ``MambaState`` stacks with and without autograd, and the
    prefill (inference mode) the same cache."""
    _, tcfg, _, tp, batch = _dense_setup("falcon-mamba-7b", seed=42,
                                         remat="compressed")
    with torch.no_grad():
        h0, _, st0 = TM.forward(tcfg, tp, batch["tokens"],
                                batch["positions"], collect_cache=True)
    tp.requires_grad_(True)
    h1, _, st1 = TM.forward(tcfg, tp, batch["tokens"], batch["positions"],
                            collect_cache=True)
    assert h1.requires_grad and torch.equal(h1.detach(), h0)
    assert torch.equal(st1.conv.detach(), st0.conv)
    assert torch.equal(st1.h.detach(), st0.h)
    _, st2 = TM.prefill(tcfg, tp, batch["tokens"], batch["positions"])
    assert torch.equal(st2.h, st0.h) and torch.equal(st2.conv, st0.conv)


def test_chunked_xent_masks_and_pads():
    """Chunks of 16 over 37 positions (the last padded with label -1)
    give the one-shot mean over unmasked positions."""
    _, tcfg, _, tp, batch = _dense_setup("qwen2-1.5b", 14)
    h = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (B, SEQ, tcfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(batch["labels"])
    got = TM.chunked_xent(tcfg, tp, h, labels, chunk=16)
    logits = TM._final_hidden_to_logits(tcfg, tp, h).double()
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = labels >= 0
    want = float(nll[valid].mean())
    assert float(got) == pytest.approx(want, rel=1e-6)


# ----------------------------------------------------------------------
# the MoE family (qwen3-moe: top-2 of 4 experts; llama4-scout: top-1 of 4
# plus the shared expert), through the dense forward, loss and decode
# ----------------------------------------------------------------------

MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_prefill_match_reference(arch):
    """Hidden states, the summed load-balance loss, the stacked K/V and
    the prefill logits (S = 37 ragged against the attention chunk; t·k
    under 4096, so no assignment drops)."""
    jcfg, tcfg, jp, tp, batch = _dense_setup(arch, seed=21)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, jaux, jkv = JM.forward(jcfg, jp, jb["tokens"], jb["positions"],
                               collect_cache=True)
    th, taux, tkv = TM.forward(tcfg, tp, batch["tokens"],
                               batch["positions"], collect_cache=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **FWD_TOL)
    assert float(jaux) > 0.0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    for t, j in zip(tkv, jkv):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **FWD_TOL)
    jl, _ = JM.prefill(jcfg, jp, jb["tokens"], jb["positions"])
    tl, _ = TM.prefill(tcfg, tp, batch["tokens"], batch["positions"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)


@pytest.mark.parametrize("remat", ["none", "compressed"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_match_reference(arch, remat):
    """``loss_fn`` (cross-entropy + 0.01 aux) and every gradient, the
    router's through both the combine weights and the aux loss; under
    compressed remat the reference's step runs un-jitted (ROADMAP §3)."""
    jcfg, tcfg, jp, tp, batch = _dense_setup(arch, seed=22, remat=remat)
    vg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, batch))
    jl, jg = (vg if remat == "compressed" else jax.jit(vg))(jp)
    tp.requires_grad_(True)
    tl = TM.loss_fn(tcfg, tp, batch)
    tg = torch.autograd.grad(tl, list(tp.parameters()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert np.abs(np.asarray(jg["layers"]["router"])).max() > 0
    _grads_match(tp, tg, jg)


@pytest.mark.parametrize("planes", [0, 16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_matches_reference(arch, planes):
    """70 teacher-forced decode steps over the raw and the compressed
    cache, step by step (B tokens a step: never a drop)."""
    jcfg, tcfg = _cfgs(arch, planes)
    jp, tp = _params(jcfg, tcfg, seed=len(arch) + planes)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    assert type(tcache).__name__ == type(jcache).__name__
    _run(jcfg, tcfg, jp, tp, jcache, tcache, toks, 0, STEPS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_own_prefill(arch):
    """The port's decode, token by token, reproduces its own prefill's
    last logits (``tests/test_models_smoke.py::test_decode_matches_prefill``
    and its bound, rtol = atol = 2e-3)."""
    _, tcfg = _cfgs(arch, 0)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(7), device="cpu")
    seq = 16
    toks = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, size=(B, seq)).astype(np.int32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (B, 1))
    want, _ = TM.prefill(tcfg, tp, toks, pos)
    cache = TM.init_cache(tcfg, B, seq, device="cpu")
    for i in range(seq):
        logits, cache = TM.decode_step(tcfg, tp, cache, toks[:, i:i + 1],
                                       pos[:, i:i + 1])
    torch.testing.assert_close(logits, want, rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------------------
# the hybrid family (zamba2 smoke: 12 Mamba-2 layers in 2 groups of 6,
# each followed by the shared attention block)
# ----------------------------------------------------------------------

HYB = "zamba2-2.7b"
REMAT_ALL = ["none", "full", "dots", "compressed"]


def test_hybrid_params_leaves_and_initial_values():
    """The port's zamba2 tree is the reference's leaf for leaf and shape
    for shape (``shared_attn`` a GLU decoder layer beside the stacked
    Mamba-2 leaves), with ``_mamba2_layer_init``'s values."""
    jcfg, cfg = _cfgs(HYB, 0)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = convert.params_to_reference(p)
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    got = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert got == jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert set(tree["shared_attn"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo",
                                        "wg", "wu", "wd"}
    lp, nh = p.layers[3], cfg.ssm_heads
    assert lp.in_proj.shape == (64, 2 * cfg.d_inner + 2 * cfg.ssm_state + nh)
    assert lp.A_log.dtype == lp.D.dtype == torch.float32
    assert torch.equal(lp.A_log, torch.zeros(nh))
    assert torch.equal(lp.D, torch.ones(nh))
    assert torch.equal(lp.dt_b, torch.full((nh,), -4.6))
    assert torch.equal(lp.conv_b, torch.zeros(cfg.d_inner))
    assert torch.equal(lp.ln1, torch.ones(64))
    assert abs(float(lp.conv_w.std()) - cfg.ssm_conv ** -0.5) < 0.05
    assert abs(float(lp.out_proj.std()) - cfg.d_inner ** -0.5) < 0.01
    assert torch.equal(p.shared_attn.ln2, torch.ones(64))
    assert abs(float(p.shared_attn.wq.std()) - 64 ** -0.5) < 0.02


def test_hybrid_forward_and_prefill_match_reference():
    """Hidden states, the grouped cache (conv (G, period, B, K-1, di), h
    (G, period, B, H, P, N), K and V (G, B, S, KV, hd)) and the prefill
    logits, S = 37 ragged against the 8-step SSD chunk and the 32-token
    attention chunk."""
    jcfg, tcfg, jp, tp, batch = _dense_setup(HYB, seed=31)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, jaux, jc = JM.forward(jcfg, jp, jb["tokens"], jb["positions"],
                              collect_cache=True)
    th, taux, tc = TM.forward(tcfg, tp, batch["tokens"], batch["positions"],
                              collect_cache=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **FWD_TOL)
    assert float(taux) == float(jaux) == 0.0
    g, period = tcfg.num_layers // tcfg.attn_period, tcfg.attn_period
    (jst, (jk, jv)), (tst, (tk, tv)) = jc, tc
    assert type(tst).__name__ == type(jst).__name__ == "MambaState"
    assert tst.conv.shape == jst.conv.shape == (
        g, period, B, tcfg.ssm_conv - 1, tcfg.d_inner)
    assert tst.h.shape == jst.h.shape == (
        g, period, B, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    assert tk.shape == jk.shape == (g, B, SEQ, tcfg.num_kv_heads,
                                    tcfg.head_dim)
    for t, j in ((tst.conv, jst.conv), (tst.h, jst.h), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **FWD_TOL)
    # the reference's prefill is this forward's last position's logits
    jl = JM._final_hidden_to_logits(jcfg, jp, jh[:, -1:])[:, 0]
    tl, (pst, _) = TM.prefill(tcfg, tp, batch["tokens"], batch["positions"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
    assert pst.h.shape == jst.h.shape


def _ref_hybrid_loss_compressed(cfg, params, batch):
    """``repro``'s hybrid loss under compressed remat with the shared
    block passed to the ``custom_vjp`` as an argument: ``repro``'s own
    closes over it, and ``jax.grad`` then raises (see the next test).
    Built from ``repro``'s pieces, in its forward's order."""
    from repro.core.remat import compressed_checkpoint

    period = cfg.attn_period
    ngroups = cfg.num_layers // period
    grouped = jax.tree.map(lambda a: a.reshape((ngroups, period)
                                               + a.shape[1:]),
                           params["layers"])
    x = JM._embed_in(cfg, params, batch["tokens"])

    def group_body(carry, glp, shared):
        h, aux = carry
        h, _ = jax.lax.scan(lambda hc, lp: (JM._mamba_layer(cfg, lp, hc)[0],
                                            None), h, glp)
        h, a, _ = JM._decoder_layer(cfg, shared, h, batch["positions"])
        return h, aux + a

    body = compressed_checkpoint(group_body, planes=12)
    (x, aux), _ = jax.lax.scan(
        lambda c, glp: (body(c, glp, params["shared_attn"]), None),
        (x, jnp.float32(0)), grouped)
    return JM.chunked_xent(cfg, params, x, batch["labels"]) + 0.01 * aux


@pytest.mark.parametrize("remat", REMAT_ALL)
def test_hybrid_loss_and_gradients_match_reference(remat):
    """``loss_fn`` and every gradient, the shared block's summed over
    its two groups. Under compressed remat (12 planes, each group's
    hidden state and weights coded) the reference is
    ``_ref_hybrid_loss_compressed``, jitted with the batch a constant.
    Twelve SSD layers carry
    float32 rounding further than the dense stack: a share of
    ``HYB_SHARE`` of a leaf may miss ``GRAD_TOL`` (seen: 2 of 16,384
    ``embed`` values, by 1.3e-5 at relative 1.2e-3), held within 1e-4 of
    the leaf's largest. Against the port's own float64 evaluation the
    two packages stand equally far (``embed``: the port 2.7e-5, the
    reference 2.2e-5, of a largest 4.4)."""
    jcfg, tcfg, jp, tp, batch = _dense_setup(HYB, seed=32, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss = (_ref_hybrid_loss_compressed if remat == "compressed"
            else JM.loss_fn)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: loss(jcfg, p, jb)))(jp)
    tp.requires_grad_(True)
    tl = TM.loss_fn(tcfg, tp, batch)
    tg = torch.autograd.grad(tl, list(tp.parameters()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    assert np.abs(np.asarray(jg["shared_attn"]["wq"])).max() > 0
    _grads_match(tp, tg, jg, share=HYB_SHARE)


def test_reference_hybrid_compressed_remat_gradient_raises():
    """Reference caveat (ROADMAP.md §3): ``repro``'s hybrid forward puts
    each group under ``compressed_checkpoint`` with the shared block
    closed over, and ``jax.grad`` of ``loss_fn`` then raises
    ``CustomVJPException``; under none, full and dots it differentiates."""
    jcfg, _, jp, _, batch = _dense_setup(HYB, seed=33, remat="compressed")
    with pytest.raises(Exception, match="closed-over value"):
        jax.grad(lambda p: JM.loss_fn(jcfg, p, batch))(jp)


def _hybrid_decode_cache(parts, length, max_len, fields):
    """A hybrid ``DecodeCache`` from a prefill's grouped parts, numpy:
    states flattened to (L, ...), K and V padded to ``max_len``."""
    st, (k, v) = parts
    flat = lambda a: np.asarray(a).reshape((-1,) + np.asarray(a).shape[2:])
    kv = [np.concatenate([np.asarray(a), np.zeros(
        a.shape[:2] + (max_len - length,) + a.shape[3:], np.float32)], 2)
        for a in (k, v)]
    return fields(kv[0], kv[1], flat(st.conv), flat(st.h), length)


HYB_STEPS = 32


def test_hybrid_decode_from_prefill_matches_reference():
    """32 teacher-forced decode steps from each package's own prefill
    state (S = 37 prompt positions), logits within 1e-4 and every
    layer's ``conv`` and ``h`` within the scan's bound at each step; the
    port's decode from its prefill also against its own prefill of the
    longer sequence (the decode_matches_prefill bound, 2e-3)."""
    jcfg, tcfg, jp, tp, batch = _dense_setup(HYB, seed=34)
    total = SEQ + HYB_STEPS
    toks = np.random.default_rng(35).integers(
        0, tcfg.vocab_size, size=(B, total)).astype(np.int32)
    toks[:, :SEQ] = batch["tokens"]
    pos = np.tile(np.arange(total, dtype=np.int32), (B, 1))
    _, jparts = JM.prefill(jcfg, jp, jnp.asarray(toks[:, :SEQ]),
                           jnp.asarray(pos[:, :SEQ]))
    _, tparts = TM.prefill(tcfg, tp, toks[:, :SEQ], pos[:, :SEQ])
    jcache = _hybrid_decode_cache(jparts, SEQ, MAX_LEN,
                                  lambda *a: JM.DecodeCache(
                                      *map(jnp.asarray, a[:4]),
                                      jnp.int32(a[4])))
    tcache = _hybrid_decode_cache(
        tuple(jax.tree.map(lambda t: t.numpy(), tparts)), SEQ, MAX_LEN,
        lambda *a: TM.DecodeCache(*map(torch.from_numpy, a[:4]), a[4]))
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    for i in range(SEQ, total):
        t, ps = toks[:, i:i + 1], pos[:, i:i + 1]
        lj, jcache = step(jp, jcache, jnp.asarray(t), jnp.asarray(ps))
        lt, tcache = TM.decode_step(tcfg, tp, tcache, t, ps)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   err_msg=f"step {i}", **TOL[0])
        for name in ("conv", "h"):
            np.testing.assert_allclose(
                getattr(tcache, name).numpy(),
                np.asarray(getattr(jcache, name)),
                err_msg=f"{name} after step {i}", **STATE_TOL)
    assert tcache.length == int(jcache.length) == total
    want, _ = TM.prefill(tcfg, tp, toks, pos)
    torch.testing.assert_close(lt, want, rtol=2e-3, atol=2e-3)


# ----------------------------------------------------------------------
# the audio and vision-language front ends (musicgen-medium: embeddings,
# layernorm, 4 of 4 query heads a KV head at smoke size; qwen2-vl-7b:
# embeddings and (3, B, S) M-RoPE positions whose streams differ)
# ----------------------------------------------------------------------

EMB_ARCHS = ["musicgen-medium", "qwen2-vl-7b"]


def _mrope(pos):
    """(3, B, S) M-RoPE streams from (B, S) positions: temporal p,
    height p // 4 and width p % 4 (three different streams)."""
    return np.stack([pos, pos // 4, pos % 4]).astype(np.int32)


def _embeds_setup(arch, seed, remat="none", seq=SEQ):
    jcfg, tcfg = (dataclasses.replace(c, remat=remat)
                  for c in _cfgs(arch, 0))
    jp, tp = _params(jcfg, tcfg, seed)
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((B, seq, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, size=(B, seq)).astype(np.int32)
    labels[1, -4:] = -1
    pos = np.tile(np.arange(seq, dtype=np.int32), (B, 1))
    if tcfg.mrope_sections:
        pos = _mrope(pos)
    batch = {"tokens": embeds, "labels": labels, "positions": pos}
    return jcfg, tcfg, jp, tp, batch


@pytest.mark.parametrize("arch", EMB_ARCHS)
def test_embeds_forward_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp, batch = _embeds_setup(arch, seed=41)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, _, jkv = JM.forward(jcfg, jp, jb["tokens"], jb["positions"],
                            collect_cache=True)
    th, _, tkv = TM.forward(tcfg, tp, batch["tokens"], batch["positions"],
                            collect_cache=True)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **FWD_TOL)
    for t, j in zip(tkv, jkv):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   **FWD_TOL)
    jl, _ = JM.prefill(jcfg, jp, jb["tokens"], jb["positions"])
    tl, _ = TM.prefill(tcfg, tp, batch["tokens"], batch["positions"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)


@pytest.mark.parametrize("remat", REMAT_ALL)
@pytest.mark.parametrize("arch", EMB_ARCHS)
def test_embeds_loss_and_gradients_match_reference(arch, remat):
    """The reference's loss jitted with the batch a constant: its
    compressed remat's custom_vjp closes over the positions, which may
    not be traced (ROADMAP.md §3)."""
    jcfg, tcfg, jp, tp, batch = _embeds_setup(arch, seed=42, remat=remat)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)))(jp)
    tp.requires_grad_(True)
    tl = TM.loss_fn(tcfg, tp, batch)
    tg = torch.autograd.grad(tl, list(tp.parameters()))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    _grads_match(tp, tg, jg)


@pytest.mark.parametrize("planes", [0, 16])
@pytest.mark.parametrize("arch", EMB_ARCHS)
def test_embeds_decode_step_matches_reference(arch, planes):
    """70 decode steps fed seeded embeddings (B, 1, d) over the raw and
    the 16-plane compressed cache; qwen2-vl's positions (3, B, 1) with
    three different streams."""
    jcfg, tcfg = _cfgs(arch, planes)
    jp, tp = _params(jcfg, tcfg, seed=len(arch) + planes)
    emb = np.random.default_rng(4).standard_normal(
        (B, STEPS, tcfg.d_model)).astype(np.float32)
    jcache = JM.init_cache(jcfg, B, MAX_LEN)
    tcache = TM.init_cache(tcfg, B, MAX_LEN, device="cpu")
    assert type(tcache).__name__ == type(jcache).__name__
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    for i in range(STEPS):
        ps = np.full((B, 1), i, np.int32)
        if tcfg.mrope_sections:
            ps = _mrope(ps)
        e = emb[:, i:i + 1]
        lj, jcache = step(jp, jcache, jnp.asarray(e), jnp.asarray(ps))
        lt, tcache = TM.decode_step(tcfg, tp, tcache, torch.from_numpy(e),
                                    torch.from_numpy(ps))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   err_msg=f"step {i}", **TOL[planes])
        assert tcache.length == int(jcache.length) == i + 1

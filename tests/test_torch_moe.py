"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs, float32.

Routing is exact: the same experts in the same order (``top_i``), ties
to the lower index as ``lax.top_k`` breaks them; the weights and the
load-balance loss within 1e-6 (the softmax's last bits differ). The
kept set is exact, also where assignments drop (t·k over 4096 with a
skewed router): the port's, the reference's (its own dispatch
expressions on its own ``top_i``) and a host loop's (each expert's first
``capacity`` assignments in flat (t, k) order) are one set. ``y``
within rtol 1e-5 / atol 1e-6 (float32 sums in another order), and bit
for bit across two calls of the port. Also: the initial scales (an
expert stack's fan is ``shape[-2]``), the reference tree's round trip
through ``convert``, and the router's gradient under every remat
policy, with the experts' products saved by ``dots``.
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
from repro.models import moe as JMOE
from repro_torch import convert
from repro_torch.configs import get_config, smoke
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

W_TOL = 1e-6
Y_TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(t, d, e, f, seed, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    if skew:  # most tokens want experts 0 and 1: their queues overflow
        router[:, 0] += 0.5
        router[:, 1] += 0.3
    wg = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    return x, router, wg, wu, wd


def _t(a):
    return torch.from_numpy(a)


def _reference_keep(top_i, e, capacity):
    """The reference's kept set, by its own dispatch expressions
    (``repro.models.moe._expert_shard``, ``axis=None``)."""
    flat = jnp.asarray(top_i).reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    starts = jnp.searchsorted(se, jnp.arange(e + 1))
    pos = jnp.arange(se.size) - starts[jnp.clip(se, 0, e)]
    keep_sorted = np.asarray((se < e) & (pos < capacity))
    keep = np.zeros(flat.size, bool)
    keep[np.asarray(order)] = keep_sorted
    return keep


def _host_keep(top_i, e, capacity):
    """Each expert's first ``capacity`` assignments in flat (t, k)
    order, by a plain loop."""
    seen = [0] * e
    keep = []
    for ex in np.asarray(top_i).reshape(-1).tolist():
        keep.append(seen[ex] < capacity)
        seen[ex] += 1
    return np.array(keep)


@pytest.mark.parametrize("t,e,k", [(8, 4, 2), (50, 128, 8), (64, 16, 1)])
def test_route_matches_reference(t, e, k):
    x, router, *_ = _inputs(t, 64, e, 8, seed=t + e)
    jw, ji, jaux = JMOE.route(jnp.asarray(x), jnp.asarray(router), k)
    tw, ti, taux = TMOE.route(_t(x), _t(router), k)
    assert ti.dtype == torch.int64 and tuple(ti.shape) == (t, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=W_TOL)
    assert float(taux) == pytest.approx(float(jaux), abs=W_TOL)


def test_route_breaks_ties_to_the_lower_index():
    """Two equal router columns (1 and 3, the largest for every token;
    integer inputs, so their logits are equal exactly) and a router
    whose columns all tie: the lower index first, as ``lax.top_k``
    orders them."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2, size=(16, 64)).astype(np.float32)
    router = (rng.standard_normal((64, 8)) * 0.01).astype(np.float32)
    router[:, 1] = router[:, 3] = 0.25
    for k in (1, 2, 3):
        _, ji, _ = JMOE.route(jnp.asarray(x), jnp.asarray(router), k)
        _, ti, _ = TMOE.route(_t(x), _t(router), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert (ti[:, 0] == 1).all()
        if k > 1:
            assert (ti[:, 1] == 3).all()
    flat = np.zeros((64, 8), np.float32)
    _, ji, _ = JMOE.route(jnp.asarray(x), jnp.asarray(flat), 3)
    _, ti, _ = TMOE.route(_t(x), _t(flat), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti == torch.tensor([0, 1, 2])).all()


@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("t,k,e", [
    (1, 1, 4), (2048, 2, 16), (2049, 2, 16), (512, 8, 128), (513, 8, 128),
    (1024, 8, 128), (4096, 1, 16), (4097, 1, 16), (3000, 2, 16)])
def test_capacity_matches_reference(t, k, e, cf):
    assert TMOE._capacity(t, k, e, cf) == JMOE._capacity(t, k, e, cf)
    if t * k <= 4096:
        assert TMOE._capacity(t, k, e, cf) >= t * k  # never a drop


@pytest.mark.parametrize("case", [
    dict(t=8, e=4, k=2, f=32, skew=False),  # decode-sized: no drop
    dict(t=50, e=128, k=8, f=16, skew=False),  # qwen3-moe's e and k
    dict(t=3000, e=16, k=2, f=24, skew=True),  # t·k 6000 > 4096: drops
])
def test_moe_ffn_matches_reference(case):
    t, e, k, f = case["t"], case["e"], case["k"], case["f"]
    x, router, wg, wu, wd = _inputs(t, 32, e, f, seed=t,
                                    skew=case["skew"])
    jy, jaux = JMOE.moe_ffn(*(jnp.asarray(a[None] if a is x else a)
                              for a in (x, router, wg, wu, wd)),
                            k=k, capacity_factor=1.25)
    args = [_t(x[None]), _t(router), _t(wg), _t(wu), _t(wd)]
    ty, taux = TMOE.moe_ffn(*args, k=k, capacity_factor=1.25)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **Y_TOL)
    assert float(taux) == pytest.approx(float(jaux), abs=W_TOL)
    # the kept set: the port's, the reference's and a host loop's
    _, ji, _ = JMOE.route(jnp.asarray(x), jnp.asarray(router), k)
    _, ti, _ = TMOE.route(_t(x), _t(router), k)
    cap = TMOE._capacity(t, k, e, 1.25)
    mine = TMOE.dispatch(ti, e, cap).keep.numpy()
    ref = _reference_keep(ji, e, cap)
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(mine, _host_keep(ti, e, cap))
    dropped = int((~mine).sum())
    assert dropped == int((~ref).sum())
    assert (dropped > 0) == case["skew"]
    ty2, _ = TMOE.moe_ffn(*args, k=k, capacity_factor=1.25)
    assert torch.equal(ty, ty2)


def test_dispatch_fills_the_buffer_from_kept_assignments_only():
    """``rows``/``filled`` are the inverse of ``slot``/``keep``: every
    kept assignment fills exactly its slot, and no other slot is
    filled."""
    rng = np.random.default_rng(0)
    e, k, cap = 6, 2, 3
    top_i = torch.from_numpy(np.stack([rng.choice(e, k, replace=False)
                                       for _ in range(11)]))
    plan = TMOE.dispatch(top_i, e, cap)
    assert int(plan.filled.sum()) == int(plan.keep.sum())
    for n in torch.nonzero(plan.keep)[:, 0].tolist():
        s = int(plan.slot[n])
        assert plan.filled.reshape(-1)[s] and int(plan.rows.reshape(-1)[s]) == n
    assert (plan.slot[~plan.keep] == e * cap).all()


ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


def _cfgs(arch, **kw):
    j = dataclasses.replace(jsmoke(jget_config(arch)), **kw)
    t = dataclasses.replace(smoke(get_config(arch)), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_round_trip_and_carry_over(arch):
    """``params_to_reference`` after ``params_from_reference`` gives the
    reference's tree back bit for bit, the ``(L, E, d, f)`` stacks
    included; the port's layer has the reference's leaves and shapes."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(3)))
    model = convert.params_from_reference(tcfg, jp, "cpu")
    back = convert.params_to_reference(model)
    assert set(back["layers"]) == set(jp["layers"])
    for name, want in jp["layers"].items():
        assert back["layers"][name].shape == want.shape
        np.testing.assert_array_equal(back["layers"][name], want)
    for key in ("embed", "lm_head", "final_norm"):
        np.testing.assert_array_equal(back[key], jp[key])
    e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
    assert jp["layers"]["wd_e"].shape == (tcfg.num_layers, e, f, d)
    assert ("wg_s" in jp["layers"]) == bool(tcfg.shared_expert_ff)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_scales_use_the_fan_in(arch):
    """Each weight is drawn at ``shape[-2] ** -0.5``: the router and the
    experts' gate and up stacks at d, the down stack at f (not E, its
    first axis)."""
    cfg = dataclasses.replace(smoke(get_config(arch)), d_ff=256)
    lp = TM.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu").layers[0]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    assert abs(float(lp.wd_e.std()) - f ** -0.5) < 0.1 * f ** -0.5
    assert abs(float(lp.wd_e.std()) - e ** -0.5) > 0.3
    for name in ("router", "wg_e", "wu_e", "wq"):
        assert abs(float(getattr(lp, name).std()) - d ** -0.5) < 0.1 * d ** -0.5
    if cfg.shared_expert_ff:
        fs = cfg.shared_expert_ff
        assert abs(float(lp.wd_s.std()) - fs ** -0.5) < 0.1 * fs ** -0.5


def _batch(cfg, seed=0, seq=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, seq)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "positions": np.tile(np.arange(seq, dtype=np.int32), (2, 1))}


@pytest.mark.parametrize("remat", ["none", "full", "dots", "compressed"])
def test_aux_gradient_reaches_the_router_under_every_remat(remat):
    """The load-balance loss alone has a gradient at every layer's
    router: under full and dots bit for bit none's; under compressed
    (the backward at the 12-plane round trip of the hidden state and the
    weights, where a routing may differ from the forward's) the
    reference's under compressed, within ``GRAD_TOL``."""
    jcfg, cfg = _cfgs("qwen3-moe-235b-a22b", remat=remat)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    model = convert.params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                          "cpu")
    model.requires_grad_(True)
    batch = _batch(cfg)
    _, aux, _ = TM.forward(cfg, model, batch["tokens"], batch["positions"])
    routers = [lp.router for lp in model.layers]
    grads = torch.autograd.grad(aux, routers)
    assert all(float(g.abs().max()) > 0 for g in grads)
    if remat == "compressed":
        jg = jax.grad(lambda p: JM.forward(
            jcfg, p, jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["positions"]))[1])(jp)["layers"]["router"]
        np.testing.assert_allclose(torch.stack(grads).numpy(),
                                   np.asarray(jg), rtol=1e-4, atol=1e-5)
        return
    none = dataclasses.replace(cfg, remat="none")
    _, aux0, _ = TM.forward(none, model, batch["tokens"], batch["positions"])
    assert torch.equal(aux, aux0)
    for g, w in zip(grads, torch.autograd.grad(aux0, routers)):
        assert torch.equal(g, w)


def test_dots_remat_saves_the_expert_products(monkeypatch):
    """Under ``remat="dots"`` the three expert products of each layer
    are ``aten.bmm`` calls, and the policy saves them."""
    _, cfg = _cfgs("qwen3-moe-235b-a22b", remat="dots")
    seen = []
    inner = TM._save_dots

    def record(ctx, op, *args, **kwargs):
        verdict = inner(ctx, op, *args, **kwargs)
        if op is torch.ops.aten.bmm.default:
            seen.append((ctx.is_recompute, verdict))
        return verdict

    monkeypatch.setattr(TM, "_save_dots", record)
    model = TM.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    model.requires_grad_(True)
    loss = TM.loss_fn(cfg, model, _batch(cfg))
    torch.autograd.grad(loss, list(model.parameters()))
    from torch.utils.checkpoint import CheckpointPolicy

    first = [v for recompute, v in seen if not recompute]
    assert len(first) >= 3 * cfg.num_layers
    assert all(v == CheckpointPolicy.MUST_SAVE for v in first)

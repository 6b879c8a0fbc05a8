"""The port's trainer against ``repro``'s: train steps, the launcher's
checkpoints and resume, and checkpoints crossing between the packages.

Train steps (smoke Qwen2-1.5B, float32, compressed remat at 12 planes,
gradients at 8 planes with error feedback): ``repro``'s step runs
un-jitted, since it cannot be jitted with compressed remat (a reference
caveat, shown below). Losses and gradient norms are held within 1e-5
relative and learning rates within 1e-6 (float32 sums in another order;
seen: 1e-7 to 8e-7), the parameters after three steps within 1e-7, a few
ulps of weights under 1 (seen: 3e-8 against a largest change of 5e-4).
The residuals and gradients reach the codec a few ulps apart, and no
kept bit plane flips on these inputs; where one did, AdamW's normalised
step would move that element by up to the learning rate, 3e-4.
The launcher's resume is bit for bit on the CPU; a checkpoint crosses
between the packages bit for bit. The MoE family (smoke qwen3-moe): the
same three steps, losses and gradient norms within 1e-5; there one
codec block of ``wg_e`` flips a kept plane at the second step (8 values
moved by up to 9.1e-5, under the learning rate), so a share of 1e-3 of
a leaf's values is held to the learning rate, the rest to 1e-7; its
launcher trains and resumes bit for bit.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.launch import steps as JST
from repro.launch import train as JT
from repro.models import model as JM
from repro.optim import adamw as JA
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import get_config, smoke
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.launch import steps as TST
from repro_torch.launch import train as TT
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA

STEPS, BATCH, SEQ = 3, 2, 40
SCHED = dict(peak_lr=3e-4, warmup=1, total_steps=STEPS)


def _cfgs(arch="qwen2-1.5b", **kw):
    j = dataclasses.replace(jsmoke(jget_config(arch)), **kw)
    t = dataclasses.replace(smoke(get_config(arch)), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _batches(vocab):
    pipe = SyntheticLM(PipelineConfig(vocab, BATCH, SEQ, seed=0))
    return [pipe.batch_at(s) for s in range(STEPS)]


def _flat_ref(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_ref(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _steps_match_reference(arch, flips=0.0):
    """``STEPS`` steps of both packages' train steps from the reference's
    weights (compressed remat, 8-plane gradients with error feedback).
    Parameters within 1e-7, except a share ``flips`` of each leaf's
    elements, held within the learning rate: where a gradient a few ulps
    apart flips a kept bit plane of its 4-value codec block, AdamW's
    normalised step moves those elements by up to the rate."""
    jcfg, tcfg = _cfgs(arch, remat="compressed", grad_compress_planes=8)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, jp)
    tp = convert.params_from_reference(tcfg, start, "cpu")
    jopt = JA.init(jp, error_feedback=True)
    topt = TA.init(dict(tp.named_parameters()), error_feedback=True)
    jstep = JST.make_train_step(jcfg, **SCHED)
    tstep = TST.make_train_step(tcfg, **SCHED)
    for i, batch in enumerate(_batches(tcfg.vocab_size)):
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        topt, tm = tstep(tp, topt, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                   rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(topt.step) == int(jopt.step) == i + 1
    got = _flat_ref(convert.params_to_reference(tp))
    want = _flat_ref(jax.tree.map(np.asarray, jp))
    for k in want:
        off = np.abs(got[k] - want[k]) > 1e-7
        assert off.sum() <= flips * off.size, (k, int(off.sum()))
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=SCHED["peak_lr"] if flips else 1e-7,
                                   err_msg=k)
        # compressed remat's backward reached every weight
        assert not np.array_equal(got[k], _flat_ref(start)[k]), k
    ef_got = _flat_ref(convert.opt_state_to_reference(topt).ef)
    assert set(ef_got) == set(_flat_ref(jax.tree.map(np.asarray, jopt.ef)))


def test_train_steps_match_reference():
    _steps_match_reference("qwen2-1.5b")


def test_moe_train_steps_match_reference():
    """The same for the MoE family (smoke qwen3-moe: top-2 of 4 experts,
    the load-balance loss in the loss, the expert stacks coded as the
    remat's arguments and quantized as stacked leaves). Seen: one or
    two codec blocks of a leaf flipped (8 of 65536 values of ``wg_e``,
    moved by up to 9.1e-5)."""
    _steps_match_reference("qwen3-moe-235b-a22b", flips=1e-3)


def test_reference_train_step_with_compressed_remat_fails_under_jit():
    """Reference caveat (ROADMAP.md §3): ``repro``'s train step with
    ``remat="compressed"`` runs un-jitted, but ``jax.jit`` of it, with the
    batch an argument as ``repro.launch.train`` passes it, raises a
    TypeError: the ``custom_vjp`` body closes over the traced
    ``positions``. The reference's launcher never reaches it (it forces
    ``remat="none"``); the port's eager step has no such limit."""
    jcfg, _ = _cfgs(remat="compressed")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    opt = JA.init(jp)
    batch = {k: jnp.asarray(v) for k, v in _batches(jcfg.vocab_size)[0].items()}
    step = JST.make_train_step(jcfg, **SCHED)
    step(jp, opt, batch)  # un-jitted: fine
    with pytest.raises(TypeError, match="DynamicJaxprTracer"):
        jax.jit(step)(jp, opt, batch)


def _main(tmp, *extra):
    return TT.main(["--preset", "lm-tiny", "--steps", "6", "--batch", "2",
                    "--seq", "32", "--ckpt-dir", str(tmp), "--ckpt-every",
                    "3", "--device", "cpu", *extra])


@pytest.mark.parametrize("grad_compress", ["0", "8"])
def test_launcher_resume_is_bitwise(tmp_path, grad_compress):
    whole = _main(tmp_path / "a", "--grad-compress", grad_compress)
    assert [h[0] for h in whole.history] == list(range(6))
    cut = tmp_path / "b"
    cut.mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000003",
                    cut / "step_0000000003")
    resumed = _main(cut, "--grad-compress", grad_compress, "--resume")
    assert [h[0] for h in resumed.history] == [3, 4, 5]
    assert resumed.history == whole.history[3:]
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    for d in ("m", "v") + (("ef",) if grad_compress != "0" else ()):
        for k, a in getattr(whole.opt, d).items():
            assert torch.equal(a, getattr(resumed.opt, d)[k]), (d, k)
    manifest = TCK.read_manifest(TCK.latest(str(tmp_path / "a")))
    assert {"0/embed", "0/layers/wq", "1/step", "1/m/layers/wq",
            "1/v/lm_head"} <= set(manifest["leaves"])


def _ref_state(cfg, steps):
    """``repro``'s params and optimizer state after ``steps`` jitted
    steps of its own launcher's schedule."""
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    jopt = JA.init(jp, error_feedback=True)
    step = jax.jit(JST.make_train_step(cfg, peak_lr=3e-4, warmup=1,
                                       total_steps=6))
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, 2, 32, seed=0))
    for s in range(steps):
        jp, jopt, _ = step(jp, jopt, {k: jnp.asarray(v) for k, v in
                                      pipe.batch_at(s).items()})
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jopt)


def test_checkpoints_cross_between_packages(tmp_path):
    """A ``repro`` checkpoint of ``(params, AdamWState)`` restores into
    the port bit for bit and resumes there; the port's checkpoint is read
    by ``repro.checkpoint.restore`` bit for bit."""
    cfg = dataclasses.replace(JT.PRESETS["lm-tiny"], grad_compress_planes=8)
    jp, jopt = _ref_state(cfg, 2)
    JCK.save(str(tmp_path / "ref"), 2, (jp, jopt))
    tcfg = TT.config_for(TT.parse_args(["--preset", "lm-tiny",
                                        "--grad-compress", "8"]))
    model = convert.params_from_reference(tcfg, jp, "cpu")
    opt = TA.init(dict(model.named_parameters()), error_feedback=True)
    like = (convert.params_to_reference(model),
            convert.opt_state_to_reference(opt))
    step, (p_np, o_np) = TCK.restore(TCK.latest(str(tmp_path / "ref")),
                                     like, device="cpu")
    assert step == 2
    model = convert.params_from_reference(tcfg, p_np, "cpu")
    opt = convert.opt_state_from_reference(model, o_np)
    back = convert.opt_state_to_reference(opt)
    for got, want in ((convert.params_to_reference(model), jp),
                      (back.m, jopt.m), (back.v, jopt.v),
                      (back.ef, jopt.ef)):
        g, w = _flat_ref(got), _flat_ref(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert int(back.step) == int(jopt.step) == 2
    run = TT.main(["--preset", "lm-tiny", "--steps", "6", "--batch", "2",
                   "--seq", "32", "--ckpt-dir", str(tmp_path / "ref"),
                   "--resume", "--grad-compress", "8", "--device", "cpu"])
    assert [h[0] for h in run.history] == [2, 3, 4, 5]

    ours = tmp_path / "port"
    run = TT.main(["--preset", "lm-tiny", "--steps", "3", "--batch", "2",
                   "--seq", "32", "--ckpt-dir", str(ours), "--ckpt-every",
                   "3", "--grad-compress", "8", "--device", "cpu"])
    j_like = jax.tree.map(np.asarray, (JM.init_params(
        cfg, jax.random.PRNGKey(0)), JA.init(jp, error_feedback=True)))
    step, (rp, ropt) = JCK.restore(JCK.latest(str(ours)), j_like)
    assert step == 3 and int(np.asarray(ropt.step)) == 3
    mine = convert.opt_state_to_reference(run.opt)
    for got, want in ((rp, convert.params_to_reference(run.model)),
                      (ropt.m, mine.m), (ropt.v, mine.v),
                      (ropt.ef, mine.ef)):
        g, w = _flat_ref(got), _flat_ref(want)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-vl-7b",
                                  "musicgen-medium"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    """Meta-device stand-ins with the reference's shapes and types (no
    allocation), for token, embedding and M-RoPE inputs."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs.base import SHAPES

    want = JST.input_specs(jget_config(arch), JSHAPES[shape])
    got = TST.input_specs(get_config(arch), SHAPES[shape])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(
            want[k].dtype), k


def test_prefill_and_decode_steps_drive_the_model():
    from repro_torch.configs.base import SMOKE_SHAPES

    _, tcfg = _cfgs()
    model = TM.init_params(tcfg, torch.Generator().manual_seed(1),
                           device="cpu")
    toks = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (BATCH, 9)).astype(np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (BATCH, 1))
    step = TST.step_for(tcfg, SMOKE_SHAPES["prefill"])
    logits, (k, v) = step(model, {"tokens": toks, "positions": pos})
    want, _ = TM.prefill(tcfg, model, toks, pos)
    assert torch.equal(logits, want) and k.shape[2] == 9
    cache = TM.init_cache(tcfg, BATCH, 16, device="cpu")
    dec = TST.step_for(tcfg, SMOKE_SHAPES["decode"])
    for i in range(9):
        out, cache = dec(model, cache, {"tokens": toks[:, i:i + 1],
                                        "positions": pos[:, i:i + 1]})
    torch.testing.assert_close(out, logits, rtol=1e-4, atol=1e-4)
    assert TST.step_for(tcfg, SMOKE_SHAPES["train"]).__name__ == "train_step"


def test_launcher_trains_and_resumes_moe(tmp_path):
    """``--arch qwen3-moe-235b-a22b --smoke`` trains on the CPU, and a
    resume from its step-2 checkpoint ends where the whole run ends, bit
    for bit."""
    argv = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--steps", "4",
            "--batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--device", "cpu"]
    whole = TT.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert whole.cfg.family == "moe" and len(whole.history) == 4
    cut = tmp_path / "b"
    cut.mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    cut / "step_0000000002")
    resumed = TT.main(argv + ["--ckpt-dir", str(cut), "--resume"])
    assert [h[0] for h in resumed.history] == [2, 3]
    assert resumed.history == whole.history[2:]
    for (n, a), (_, b) in zip(whole.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(a, b), n
    manifest = TCK.read_manifest(TCK.latest(str(tmp_path / "a")))
    assert {"0/layers/router", "0/layers/wd_e",
            "1/m/layers/wg_e"} <= set(manifest["leaves"])


# ----------------------------------------------------------------------
# one train step of the vision-language front end (an embeddings batch
# with (3, B, S) M-RoPE positions) and of the zamba2 hybrid
# ----------------------------------------------------------------------

ONE = dict(peak_lr=3e-4, warmup=0, total_steps=1)


def _one_step_matches_reference(arch, batch, remat, flips=0.0):
    """One step of each package's train step from the reference's
    weights (``remat``, 8-plane gradients with error feedback, the
    schedule at its peak rate; the reference's step jitted): loss and gradient norm within 1e-5
    relative, the parameters within 1e-7 but for a share ``flips`` of a
    leaf (and at least one 4-value codec block) held within the learning
    rate, every weight moved."""
    jcfg, tcfg = _cfgs(arch, remat=remat, grad_compress_planes=8)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    start = _flat_ref(jax.tree.map(np.asarray, jp))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    jopt = JA.init(jp, error_feedback=True)
    topt = TA.init(dict(tp.named_parameters()), error_feedback=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = JST.make_train_step(jcfg, **ONE)
    # jitted with the batch a constant (under compressed remat the
    # reference cannot trace it, ROADMAP.md §3)
    jp, jopt, jm = jax.jit(lambda p, o: jstep(p, o, jb))(jp, jopt)
    topt, tm = TST.make_train_step(tcfg, **ONE)(tp, topt, batch)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["gnorm"]) == pytest.approx(float(jm["gnorm"]), rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6) \
        and float(tm["lr"]) > 0
    got = _flat_ref(convert.params_to_reference(tp))
    want = _flat_ref(jax.tree.map(np.asarray, jp))
    assert got.keys() == want.keys()
    for k in want:
        off = np.abs(got[k] - want[k]) > 1e-7
        # one flipped codec block (4 values) is allowed in any leaf
        assert off.sum() <= (max(4, flips * off.size) if flips else 0), (
            k, int(off.sum()))
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=ONE["peak_lr"] if flips else 1e-7,
                                   err_msg=k)
        assert not np.array_equal(got[k], start[k]), k
    ef = _flat_ref(convert.opt_state_to_reference(topt).ef)
    assert ef.keys() == _flat_ref(jax.tree.map(np.asarray, jopt.ef)).keys()


def test_vlm_train_step_matches_reference():
    """qwen2-vl smoke: seeded embeddings (B, S, d), (3, B, S) positions
    whose three streams differ, compressed remat."""
    rng = np.random.default_rng(3)
    _, tcfg = _cfgs("qwen2-vl-7b")
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (BATCH, 1))
    batch = {"tokens": rng.standard_normal(
                 (BATCH, SEQ, tcfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, tcfg.vocab_size, (BATCH, SEQ)
                                    ).astype(np.int32),
             "positions": np.stack([pos, pos // 4, pos % 4])}
    _one_step_matches_reference("qwen2-vl-7b", batch, "compressed")


def test_hybrid_train_step_matches_reference():
    """zamba2 smoke on a ``SyntheticLM`` batch, remat full (``repro``'s
    hybrid cannot be differentiated under compressed remat, ROADMAP.md
    §3); the shared block's leaves quantized as leaves of their own.
    Seen: one ``in_proj`` value of 215,040 and 3 of ``dt_b``'s 96 (one
    block) past 1e-7 (a kept bit plane of a codec block flipped), so a
    share of 1e-3, or one block, is held to the rate, as for the MoE
    family."""
    _, tcfg = _cfgs("zamba2-2.7b")
    _one_step_matches_reference("zamba2-2.7b",
                                _batches(tcfg.vocab_size)[0], "full",
                                flips=1e-3)


def test_hybrid_params_and_opt_state_round_trip():
    """``params_from_reference`` after ``params_to_reference`` is the
    identity on a hybrid tree (``shared_attn`` a subtree beside the
    stacked layers), the AdamW state's trees round-trip, and a checkpoint
    of both in the reference's trees restores bit for bit."""
    jcfg, tcfg = _cfgs("zamba2-2.7b", grad_compress_planes=8)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(2)))
    model = convert.params_from_reference(tcfg, jp, "cpu")
    tree = convert.params_to_reference(model)
    assert set(tree) == set(jp) and set(tree["shared_attn"]) == set(
        jp["shared_attn"])
    for k, w in _flat_ref(jp).items():
        np.testing.assert_array_equal(_flat_ref(tree)[k], w, err_msg=k)
    again = convert.params_from_reference(tcfg, tree, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    opt = TA.init(dict(model.named_parameters()), error_feedback=True)
    gen = torch.Generator().manual_seed(0)
    for d in (opt.m, opt.v, opt.ef):
        for t in d.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    ref = convert.opt_state_to_reference(opt)
    assert set(ref.m["shared_attn"]) == set(jp["shared_attn"])
    back = convert.opt_state_from_reference(model, ref)
    for d in ("m", "v", "ef"):
        for k, t in getattr(opt, d).items():
            assert torch.equal(getattr(back, d)[k], t), (d, k)

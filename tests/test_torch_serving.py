"""The port's serving engine against ``repro.serving.engine`` on the same
parameters and prompts, at smoke size in float32.

Over the compressed cache the traffic is lockstep (every slot admitted
at once, equal prompt lengths, equal ``max_new``): the cache is
slot-synchronous in the reference too. Greedy token streams must be
equal, and the logits agree within an absolute tolerance: 1e-4 over the
raw cache (float32 sums in another order move a logit by ~4e-6), 2e-3
over the compressed cache, five times the largest move seen over six
seeds (4e-4, from one flipped bit plane in the codec; see
``tests/test_torch_model.py``). Every sampled step's top-2 logit margin
must exceed twice the tolerance, so that equal streams are not luck and
a flip would be explained.

The MoE family (qwen3-moe and llama4-scout smoke) over both caches: the
streams and tolerances as above; there every sampled step's top-2
margin must exceed twice the largest logit distance seen (smallest
margin seen 1.5e-3, largest distance 6.6e-5).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import model as JM
from repro.serving.engine import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config, smoke
from repro_torch.serving.engine import ServeEngine as TEngine

TOL = {0: 1e-4, 16: 2e-3}


def _setup(planes, seed=12):
    jcfg = dataclasses.replace(jsmoke(jget_config("qwen2-1.5b")),
                               kv_compress_planes=planes)
    tcfg = dataclasses.replace(smoke(get_config("qwen2-1.5b")),
                               kv_compress_planes=planes)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    return jcfg, tcfg, jp, tp


def _recording(eng):
    """Record every step's logits (as float32 numpy) by wrapping the
    engine's decode-step function."""
    logs, inner = [], eng._step

    def step(*args):
        logits, cache = inner(*args)
        logs.append(np.asarray(logits, np.float32) if not hasattr(
            logits, "numpy") else logits.float().numpy())
        return logits, cache

    eng._step = step
    return logs


def _serve(eng, prompts, max_new):
    logs = _recording(eng)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    done = eng.run_all()
    assert set(done) == set(rids)
    return [done[r] for r in rids], np.stack(logs)


def _margins(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("planes", [16, 0])
def test_engine_matches_reference_lockstep(planes):
    jcfg, tcfg, jp, tp = _setup(planes)
    prompts = np.random.default_rng(4).integers(
        1, tcfg.vocab_size, size=(2, 70)).tolist()
    out_j, log_j = _serve(JEngine(jcfg, jp, slots=2, max_len=128), prompts, 6)
    out_t, log_t = _serve(TEngine(tcfg, tp, slots=2, max_len=128,
                                  device="cpu"), prompts, 6)
    assert out_t == out_j
    assert log_t.shape == log_j.shape == (75, 2, tcfg.vocab_size)
    np.testing.assert_allclose(log_t, log_j, rtol=0, atol=TOL[planes])
    # the steps whose argmax became a token
    assert _margins(log_j[69:]).min() > 2 * TOL[planes]


def test_engine_continuous_batching_overlap():
    """More requests than slots over the raw cache: all finish, slots
    are reused, and the streams are the reference's."""
    jcfg, tcfg, jp, tp = _setup(0)
    prompts = [[i + 1, i + 2] for i in range(5)]
    out_j, log_j = _serve(JEngine(jcfg, jp, slots=2, max_len=64), prompts, 3)
    out_t, log_t = _serve(TEngine(tcfg, tp, slots=2, max_len=64,
                                  device="cpu"), prompts, 3)
    assert all(len(v) == 3 for v in out_t)
    assert out_t == out_j
    np.testing.assert_allclose(log_t, log_j, rtol=0, atol=TOL[0])
    assert _margins(log_j).min() > 2 * TOL[0]


def test_engine_deterministic_sampling():
    _, tcfg, _, tp = _setup(0)
    outs = []
    for _ in range(2):
        eng = TEngine(tcfg, tp, slots=1, max_len=64, temperature=0.8, seed=3,
                      device="cpu")
        rid = eng.submit([4, 2], max_new=6)
        outs.append(eng.run_all()[rid])
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_engine_rejects_params_on_another_device_or_backend():
    _, tcfg, _, tp = _setup(0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TEngine(tcfg, tp, device="cpu", backend="cuda")


def test_engine_refuses_late_admission_into_compressed_cache():
    """The compressed cache is slot-synchronous: a request that would
    enter it after the first step raises instead of attending to the
    earlier requests' history."""
    _, tcfg, _, tp = _setup(16)
    eng = TEngine(tcfg, tp, slots=2, max_len=128, device="cpu")
    for i in range(3):
        eng.submit([i + 1, i + 2], max_new=2)
    with pytest.raises(ValueError, match="slot-synchronous"):
        eng.run_all()


def test_launcher_serves_on_cpu(capsys):
    """The launcher's default traffic (6 requests, 4 slots, raw cache)
    answers every request at smoke size."""
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert [line.startswith(f"request {i}:")
            for i, line in enumerate(out.splitlines()[:6], 1)] == [True] * 6
    assert "18 tokens in" in out


# ----------------------------------------------------------------------
# the SSM family (falcon-mamba smoke, float32)
# ----------------------------------------------------------------------


def _ssm_setup(seed=21):
    jcfg = jsmoke(jget_config("falcon-mamba-7b"))
    tcfg = smoke(get_config("falcon-mamba-7b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    return jcfg, tcfg, jp, tp


def test_ssm_engine_matches_reference_lockstep():
    """Every slot admitted at once from zero state: the reference engine
    is right there, and the port's streams and logits are its own."""
    jcfg, tcfg, jp, tp = _ssm_setup()
    prompts = np.random.default_rng(6).integers(
        1, tcfg.vocab_size, size=(2, 12)).tolist()
    out_j, log_j = _serve(JEngine(jcfg, jp, slots=2, max_len=64), prompts, 6)
    out_t, log_t = _serve(TEngine(tcfg, tp, slots=2, max_len=64,
                                  device="cpu"), prompts, 6)
    assert out_t == out_j
    assert log_t.shape == log_j.shape == (17, 2, tcfg.vocab_size)
    np.testing.assert_allclose(log_t, log_j, rtol=0, atol=TOL[0])
    assert _margins(log_j[11:]).min() > 2 * TOL[0]


# A long request in slot 0, a short one in slot 1 that finishes first,
# and a third request that enters slot 1 once it is free.
LATE = dict(prompts=[[5, 9, 14, 3, 7, 1, 8, 2, 6, 4], [11, 12], [30, 31, 32]],
            max_new=[6, 2, 4])


def _watch_admission(eng, rid):
    """Wrap the engine's ``_admit`` to record, when request ``rid``
    enters a slot: (the step it enters at, the slot, max |h| and max
    |conv| of that slot's rows over the layers as it starts)."""
    seen, inner, steps = [], eng._admit, [0]

    def admit():
        before = dict(eng.active)
        inner()
        for slot, req in eng.active.items():
            if req is not None and before[slot] is None and req.rid == rid:
                seen.append((steps[0], slot,
                             float(np.abs(np.asarray(eng.cache.h[:, slot])).max()),
                             float(np.abs(np.asarray(eng.cache.conv[:, slot])).max())))
        steps[0] += 1

    eng._admit = admit
    return seen


def _late_traffic(eng):
    """Serve LATE; returns (the streams, the logits of the third
    request's steps in its slot, its admission record)."""
    seen = _watch_admission(eng, 3)
    logs = _recording(eng)
    rids = [eng.submit(p, max_new=m)
            for p, m in zip(LATE["prompts"], LATE["max_new"])]
    done = eng.run_all()
    (step, slot, _, _), = seen
    n = len(LATE["prompts"][2]) + LATE["max_new"][2] - 1
    rows = np.stack([row[slot] for row in logs[step:step + n]])
    return [done[r] for r in rids], rows, seen[0]


def _solo(eng):
    logs = _recording(eng)
    rid = eng.submit(LATE["prompts"][2], max_new=LATE["max_new"][2])
    out = eng.run_all()[rid]
    return out, np.stack([row[0] for row in logs])


def test_ssm_late_admission_starts_from_zero_state():
    """A request admitted into a freed slot yields the stream it yields
    served alone: the engine zeroes the slot's conv and h."""
    _, tcfg, _, tp = _ssm_setup()
    outs, late, (step, slot, h_max, conv_max) = _late_traffic(
        TEngine(tcfg, tp, slots=2, max_len=64, device="cpu"))
    assert [len(o) for o in outs] == LATE["max_new"]
    # the third request entered slot 1 after the second left it, and
    # found zero state there
    assert step > 0 and slot == 1 and h_max == conv_max == 0.0
    solo_out, solo = _solo(TEngine(tcfg, tp, slots=2, max_len=64,
                                   device="cpu"))
    assert outs[2] == solo_out
    np.testing.assert_allclose(late, solo, rtol=0, atol=TOL[0])


def test_reference_engine_does_not_reset_ssm_slot_state():
    """The reference engine resets only the slot's position: the third
    request starts from the state the second request (and the idle steps
    on token 0 after it) left in slot 1, and its logits differ from its
    solo run's. ROADMAP section 3 logs this reference caveat."""
    jcfg, _, jp, _ = _ssm_setup()
    _, late, (step, slot, h_max, conv_max) = _late_traffic(
        JEngine(jcfg, jp, slots=2, max_len=64))
    assert step > 0 and slot == 1 and h_max > 0 and conv_max > 0
    _, solo = _solo(JEngine(jcfg, jp, slots=2, max_len=64))
    assert np.abs(late - solo).max() > 100 * TOL[0]


def test_launcher_serves_falcon_mamba_on_cpu(capsys):
    """``--arch falcon-mamba-7b`` at smoke size: 6 requests through 4
    slots (two enter freed slots) are all answered."""
    from repro_torch.launch import serve

    serve.main(["--arch", "falcon-mamba-7b", "--device", "cpu",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert [line.startswith(f"request {i}:")
            for i, line in enumerate(out.splitlines()[:6], 1)] == [True] * 6
    assert "18 tokens in" in out


# ----------------------------------------------------------------------
# the MoE family (smoke qwen3-moe: top-2 of 4; llama4-scout: top-1 of 4
# plus the shared expert)
# ----------------------------------------------------------------------

MOE_ARCHS = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]


@pytest.mark.parametrize("planes", [16, 0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_reference_lockstep(arch, planes):
    """Greedy streams equal to the reference engine's on lockstep
    traffic (every step routes the slots' tokens with no drop), the
    logits within the dense family's tolerances."""
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)),
                               kv_compress_planes=planes)
    tcfg = dataclasses.replace(smoke(get_config(arch)),
                               kv_compress_planes=planes)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(31))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    prompts = np.random.default_rng(8).integers(
        1, tcfg.vocab_size, size=(2, 70)).tolist()
    out_j, log_j = _serve(JEngine(jcfg, jp, slots=2, max_len=128), prompts, 6)
    out_t, log_t = _serve(TEngine(tcfg, tp, slots=2, max_len=128,
                                  device="cpu"), prompts, 6)
    assert out_t == out_j
    assert log_t.shape == log_j.shape == (75, 2, tcfg.vocab_size)
    np.testing.assert_allclose(log_t, log_j, rtol=0, atol=TOL[planes])
    # every sampled step's top-2 margin is over twice the logits' largest
    # distance: equal streams are not luck
    assert _margins(log_j[69:]).min() > 2 * np.abs(log_t - log_j).max()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_serves_moe_on_cpu(capsys, arch):
    """``--arch`` of the MoE family at smoke size: 6 requests through 4
    slots (two enter freed slots) are all answered."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert [line.startswith(f"request {i}:")
            for i, line in enumerate(out.splitlines()[:6], 1)] == [True] * 6
    assert "18 tokens in" in out


# ----------------------------------------------------------------------
# the hybrid family (zamba2 smoke: Mamba-2 states a layer, the shared
# block's raw K/V a group), and the embeddings front ends the engine
# refuses
# ----------------------------------------------------------------------


def _hyb_setup(seed=41):
    jcfg = jsmoke(jget_config("zamba2-2.7b"))
    tcfg = smoke(get_config("zamba2-2.7b"))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    return jcfg, tcfg, jp, tp


def test_hybrid_engine_matches_reference_lockstep():
    """Every slot admitted at once from zero state: greedy streams equal
    to the reference engine's, the logits within 1e-4, every sampled
    step's top-2 margin over twice the largest logit distance."""
    jcfg, tcfg, jp, tp = _hyb_setup()
    prompts = np.random.default_rng(9).integers(
        1, tcfg.vocab_size, size=(2, 12)).tolist()
    out_j, log_j = _serve(JEngine(jcfg, jp, slots=2, max_len=64), prompts, 6)
    out_t, log_t = _serve(TEngine(tcfg, tp, slots=2, max_len=64,
                                  device="cpu"), prompts, 6)
    assert out_t == out_j
    assert log_t.shape == log_j.shape == (17, 2, tcfg.vocab_size)
    np.testing.assert_allclose(log_t, log_j, rtol=0, atol=TOL[0])
    assert _margins(log_j[11:]).min() > 2 * np.abs(log_t - log_j).max()


def test_hybrid_late_admission_starts_from_zero_state():
    """A request admitted into a freed hybrid slot yields the stream it
    yields served alone: the engine zeroes every layer's conv and h rows
    of the slot (its K/V rows are masked by position)."""
    _, tcfg, _, tp = _hyb_setup()
    outs, late, (step, slot, h_max, conv_max) = _late_traffic(
        TEngine(tcfg, tp, slots=2, max_len=64, device="cpu"))
    assert [len(o) for o in outs] == LATE["max_new"]
    assert step > 0 and slot == 1 and h_max == conv_max == 0.0
    solo_out, solo = _solo(TEngine(tcfg, tp, slots=2, max_len=64,
                                   device="cpu"))
    assert outs[2] == solo_out
    np.testing.assert_allclose(late, solo, rtol=0, atol=TOL[0])


def test_launcher_serves_zamba2_on_cpu(capsys):
    """``--arch zamba2-2.7b`` at smoke size: 6 requests through 4 slots
    (two enter freed slots) are all answered."""
    from repro_torch.launch import serve

    serve.main(["--arch", "zamba2-2.7b", "--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert [line.startswith(f"request {i}:")
            for i, line in enumerate(out.splitlines()[:6], 1)] == [True] * 6
    assert "18 tokens in" in out


@pytest.mark.parametrize("arch", ["musicgen-medium", "qwen2-vl-7b"])
def test_launcher_refuses_embeddings_archs(capsys, arch):
    """The audio and vision-language configs take embeddings, which the
    engine (the reference's too) does not feed: the launcher stops with
    the engine's message and answers nothing."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="feeds token ids only"):
        serve.main(["--arch", arch, "--device", "cpu"])
    assert "request" not in capsys.readouterr().out


def test_engine_refuses_embeds_input_config():
    cfg = smoke(get_config("qwen2-vl-7b"))
    from repro_torch.models import model as TM

    params = TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="embeddings"):
        TEngine(cfg, params, device="cpu")

"""The port's model on DTensors over a (data 2, model 2) mesh of 4 gloo
ranks on the CPU, against ``repro``'s model on the same numpy inputs.

Each family's smoke config (float32; the hybrid cut to one group of its
two, as the dry run cuts it) runs in ``tests/torch_sharded_model_worker.py``
with its parameters, batch and decode cache placed by
``launch.steps.shardings_for`` under ``DEFAULT_RULES``: the placements
a sharded model holds, so the roads the model takes only on DTensors
(``layers.divisible_shards`` and ``merged`` around head splits,
``grad_placed`` at the embedding, ``_sharded_cache_update``, the
one-hot gold logit of ``chunked_xent``, ``moe.expert_parallel`` and
``route``'s partial hit counts) are held to values, not only shapes.

Checked against ``repro`` (``jax.jit`` on one CPU device, the same
parameters through ``convert``): the loss within ``LOSS_RTOL`` and
every gradient within ``GRAD_TOL`` (``tests/test_torch_model.py``'s
bounds), ``prefill``'s logits and ``STEPS`` decode steps' logits from
an empty raw cache within ``FWD_TOL``. The decode steps cross the
cache's position shards (``cache_seq`` over ``model``: positions 0-7 on
one rank, 8-15 on the other). The 4 ranks have ``TIMEOUT`` seconds.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config, smoke

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
TIMEOUT = 420
WORLD = 4
B, SEQ, MAX_LEN, STEPS = 2, 16, 16, 10
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["qwen2-1.5b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
         "zamba2-2.7b"]


def _layers(cfg):
    return cfg.attn_period if cfg.attn_period else cfg.num_layers


def _cfgs(arch):
    j, t = jsmoke(jget_config(arch)), smoke(get_config(arch))
    n = _layers(t)
    j, t = (dataclasses.replace(c, num_layers=n) for c in (j, t))
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _inputs(arch, seed, path):
    """The reference's parameters and the inputs; the port's parameters
    and the inputs written to ``path``."""
    jcfg, tcfg = _cfgs(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = convert.params_from_reference(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, (B, SEQ)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (B, SEQ)).astype(np.int32)
    labels[0, -5:] = -1
    pos = np.tile(np.arange(SEQ, dtype=np.int32), (B, 1))
    dec = rng.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
    batch = {"tokens": toks, "labels": labels, "positions": pos}
    np.savez(path, tokens=toks, labels=labels, positions=pos,
             dec_tokens=dec, **{"p/" + n: p.detach().numpy()
                                for n, p in tp.named_parameters()})
    return jcfg, jp, batch, dec, [n for n, _ in tp.named_parameters()]


def _reference(jcfg, jp, batch, dec, names):
    """``repro``'s loss, gradients, prefill and decode logits."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch)))(jp)
    logits, _ = JM.prefill(jcfg, jp, jnp.asarray(batch["tokens"]),
                           jnp.asarray(batch["positions"]))
    step = jax.jit(lambda p, c, t, ps: JM.decode_step(jcfg, p, c, t, ps))
    cache = JM.init_cache(jcfg, B, MAX_LEN)
    steps = []
    for i in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(dec[:, i:i + 1]),
                         jnp.full((B, 1), i, jnp.int32))
        steps.append(np.asarray(lg))
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads),
            "prefill": np.asarray(logits), "decode": np.stack(steps),
            "names": names}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results (computed while the ranks run) and rank
    0's."""
    tmp = tmp_path_factory.mktemp("sharded_model")
    made, inputs = {}, {}
    for seed, arch in enumerate(ARCHS):
        inputs[arch] = str(tmp / f"{arch}.npz")
        made[arch] = _inputs(arch, 50 + seed, inputs[arch])
    jobs = {"archs": ARCHS, "max_len": MAX_LEN, "inputs": inputs,
            "layers": {a: _cfgs(a)[1].num_layers for a in ARCHS}}
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_model_worker.py"),
         str(r), str(tmp / "store"), str(tmp / "jobs.json"),
         str(tmp / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for r in range(WORLD)]
    try:
        refs = {arch: _reference(*made[arch]) for arch in ARCHS}
    finally:
        for p in procs:
            try:
                _, err = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail(f"the 4 gloo ranks took over {TIMEOUT} s")
            assert p.returncode == 0, err.decode()[-3000:]
    return refs, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_gradients_match_reference(runs, arch):
    refs, got = runs
    ref = refs[arch]
    assert float(got[f"{arch}/loss"]) == pytest.approx(ref["loss"],
                                                       rel=LOSS_RTOL)
    names = ref["names"]
    mine = convert._to_reference_tree(
        {n: torch.from_numpy(got[f"{arch}/g/{n}"]) for n in names})
    want = ref["grads"]
    assert set(mine) == set(want)
    for key, w in want.items():
        pairs = w.items() if isinstance(w, dict) else [(None, w)]
        for name, wv in pairs:
            g = mine[key][name] if name is not None else mine[key]
            np.testing.assert_allclose(g, wv, err_msg=f"{key}/{name}",
                                       **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_reference(runs, arch):
    refs, got = runs
    np.testing.assert_allclose(got[f"{arch}/prefill"], refs[arch]["prefill"],
                               **FWD_TOL)
    np.testing.assert_allclose(got[f"{arch}/decode"], refs[arch]["decode"],
                               **FWD_TOL)

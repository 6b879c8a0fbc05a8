"""The port's expert-parallel MoE branch (``repro_torch.models.moe``
under ``use_rules`` on a ``DeviceMesh`` of gloo ranks) against
``repro.models.moe.moe_ffn``'s ``shard_map`` branch on JAX meshes of
the same shapes, on the same numpy inputs, float32.

The port runs over 2 and 4 gloo ranks (``tests/torch_moe_ep_worker.py``
a rank, a ``FileStore`` under ``tmp_path``); the reference in one
process over 4 host devices (``tests/moe_ep_reference_worker.py``,
``XLA_FLAGS=--xla_force_host_platform_device_count=4``); each process
within ``TIMEOUT`` seconds. Meshes are ``DATAxMODEL``. Cases:

- ``nodrop``: 2 × 16 tokens, E 8, top-2 (t·k under 4096: no drop);
- ``drop``: 4 × 1100 tokens under a skewed router: each token shard's
  capacity is ``_capacity(T // dp_size, ...)``, so (1, 4) and (2, 2)
  keep different sets, as in the reference;
- ``indivisible``: E 6 on a model axis of 4: the single-device branch;
- ``no_rules``: ``rules["moe_experts"] = None``: the single-device
  branch.

Checked: the branch taken (the reference's condition); ``y`` within
rtol 1e-5 / atol 1e-6 and the aux loss within 1e-6 relative (float32
sums in another order, as ``tests/test_torch_moe.py``); the gradients
of ``sum(y · r) + aux`` with respect to x, the router and the experts
within rtol 1e-4 / atol 1e-5 of ``jax.grad`` (the model tests' bound);
the kept set (the assignments whose ``top_w`` gets a gradient) exactly;
``y`` the same bits on every rank and in two calls; where the
single-device branch runs, ``y`` bit for bit the port's call without
rules. Each check runs on plain inputs (the whole tensor on every rank)
and on DTensors placed by the model's logical axes (tokens sharded over
the data axes, experts over ``model`` and FSDP over ``data``), which
take the same ``local_map`` path.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models import moe as TMOE

HERE = Path(__file__).resolve().parent
SRC = str(HERE.parent / "src")
TIMEOUT = 240
Y_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_TOL = 1e-6
G_TOL = dict(rtol=1e-4, atol=1e-5)
K, CF = 2, 1.25

# case: (b, s, d, E, f, skew, moe_experts, {world: meshes})
CASES = {
    "nodrop": (2, 16, 16, 8, 24, False, "model",
               {4: ("1x4", "2x2", "4x1"), 2: ("1x2", "2x1")}),
    "drop": (4, 1100, 16, 8, 24, True, "model",
             {4: ("1x4", "2x2", "4x1"), 2: ("1x2", "2x1")}),
    "indivisible": (2, 16, 16, 6, 24, False, "model", {4: ("1x4",)}),
    "no_rules": (2, 16, 16, 8, 24, False, None, {4: ("2x2",)}),
}
RUNS = [(case, mesh) for case, c in CASES.items()
        for meshes in c[-1].values() for mesh in meshes]


def _inputs(b, s, d, e, f, skew, seed):
    rng = np.random.default_rng(seed)
    router = (rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)
    if skew:  # most tokens want experts 0 and 1: their queues overflow
        router[:, 0] += 0.5
        router[:, 1] += 0.3
    return {
        "x": rng.standard_normal((b, s, d)).astype(np.float32),
        "router": router,
        "wg": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
        "wu": (rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32),
        "wd": (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32),
        "r": rng.standard_normal((b, s, d)).astype(np.float32),
    }


def _wait(procs, what):
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{what} took over {TIMEOUT} s")
        assert p.returncode == 0, f"{what} failed:\n{err.decode()[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on every mesh: the reference's and each rank's
    results, and the inputs."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    jobs, inputs = [], {}
    for seed, (case, (b, s, d, e, f, skew, experts, worlds)) in enumerate(
            CASES.items()):
        inputs[case] = _inputs(b, s, d, e, f, skew, seed)
        path = tmp / f"{case}.npz"
        np.savez(path, **inputs[case])
        jobs += [{"case": case, "inputs": str(path), "k": K, "cf": CF,
                  "experts": experts, "mesh": mesh, "world": world}
                 for world, meshes in worlds.items() for mesh in meshes]
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "moe_ep_reference_worker.py"),
         str(tmp / "jobs.json"), str(tmp / "ref.npz")], env=env, **pipes)
    ranks = {}
    for world in (2, 4):
        ranks[world] = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_moe_ep_worker.py"), str(r),
             str(world), str(tmp / f"store{world}"), str(tmp / "jobs.json"),
             str(tmp / f"w{world}r{r}.npz")], env=env, **pipes)
            for r in range(world)]
    _wait([ref], "the reference")
    for world, procs in ranks.items():
        _wait(procs, f"the port over {world} gloo ranks")
    return {
        "ref": dict(np.load(tmp / "ref.npz")),
        "ranks": {w: [dict(np.load(tmp / f"w{w}r{r}.npz")) for r in range(w)]
                  for w in (2, 4)},
        "inputs": inputs,
    }


def _world(mesh):
    dp, mp = (int(v) for v in mesh.split("x"))
    return dp * mp


def _branch_matches(runs, case, mesh, form):
    ranks = runs["ranks"][_world(mesh)]
    got, ref = ranks[0], runs["ref"]
    key = f"{case}/{mesh}/{form}"
    e = CASES[case][3]
    dp, mp = (int(v) for v in mesh.split("x"))
    want_ep = CASES[case][6] is not None and e % mp == 0
    assert bool(got[key + "expert_parallel"]) == want_ep
    want = f"{case}/{mesh}/"
    assert int(got[key + "capacity"]) == int(ref[want + "capacity"])
    np.testing.assert_array_equal(got[key + "kept"], ref[want + "kept"])
    np.testing.assert_allclose(got[key + "y"], ref[want + "y"], **Y_TOL)
    assert abs(float(got[key + "aux"]) - float(ref[want + "aux"])) <= (
        AUX_TOL * abs(float(ref[want + "aux"])))
    for r in ranks[1:]:
        assert np.array_equal(r[key + "y"], got[key + "y"]), "ranks differ"
    assert all(bool(r[key + "y_again_same"]) for r in ranks)


def _gradients_match(runs, case, mesh, form):
    got, ref = runs["ranks"][_world(mesh)][0], runs["ref"]
    key, want = f"{case}/{mesh}/{form}", f"{case}/{mesh}/"
    for leaf in ("x", "router", "wg", "wu", "wd"):
        np.testing.assert_allclose(got[key + "g_" + leaf],
                                   ref[want + "g_" + leaf], **G_TOL,
                                   err_msg=leaf)


@pytest.mark.parametrize("case,mesh", RUNS)
def test_branch_y_aux_and_kept_set_match_the_reference(runs, case, mesh):
    _branch_matches(runs, case, mesh, "")


@pytest.mark.parametrize("case,mesh", RUNS)
def test_gradients_match_jax_grad_through_the_reference(runs, case, mesh):
    _gradients_match(runs, case, mesh, "")


@pytest.mark.parametrize("case,mesh", RUNS)
def test_sharded_inputs_y_aux_and_kept_set_match_the_reference(
        runs, case, mesh):
    """The same checks on DTensors placed as a sharded model holds them
    (the worker's ``dtensor/`` runs)."""
    _branch_matches(runs, case, mesh, "dtensor/")


@pytest.mark.parametrize("case,mesh", RUNS)
def test_sharded_inputs_gradients_match_jax_grad_through_the_reference(
        runs, case, mesh):
    _gradients_match(runs, case, mesh, "dtensor/")


def test_drop_case_keeps_other_sets_on_other_meshes(runs):
    """Capacity is a token shard's: (2, 2) and (1, 4) drop, and drop
    different assignments, in the reference and in the port alike."""
    got = runs["ranks"][4][0]
    a, b = got["drop/1x4/kept"], got["drop/2x2/kept"]
    assert (~a).any() and (~b).any()
    assert not np.array_equal(a, b)
    assert int(got["drop/2x2/capacity"]) < int(got["drop/1x4/capacity"])


@pytest.mark.parametrize("case,mesh", [("indivisible", "1x4"),
                                       ("no_rules", "2x2")])
def test_single_device_fallback_is_bitwise_the_call_without_rules(
        runs, case, mesh):
    inp = {n: torch.from_numpy(v) for n, v in runs["inputs"][case].items()}
    y, _ = TMOE.moe_ffn(inp["x"], inp["router"], inp["wg"], inp["wu"],
                        inp["wd"], k=K, capacity_factor=CF)
    got = runs["ranks"][_world(mesh)][0][f"{case}/{mesh}/y"]
    assert np.array_equal(got, y.numpy())


def test_expert_axis_is_the_references_condition():
    """No mesh, no ``moe_experts`` or a mesh of no ranks (a JAX
    ``AbstractMesh``): the single-device branch."""
    from jax.sharding import AbstractMesh

    from repro_torch.distributed import sharding as tsh

    rules = tsh.DEFAULT_RULES
    assert TMOE.expert_axis(None, rules, 8) is None
    assert TMOE.expert_axis(AbstractMesh((2, 2), ("data", "model")),
                            rules, 8) is None
    assert TMOE.expert_axis(None, {**rules, "moe_experts": None}, 8) is None

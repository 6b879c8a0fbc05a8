"""The port's domain partitioner (``repro_torch.distributed.sharding``)
against the JAX package's: pure Python, so equal exactly.

Over an (ndiv, nshards) grid: every shard's block range, topology flags
and unit footprints (owned, ghost, all, halo) and its ``to_dict``; the
same rejections; device pins round-robin over ``torch.device``s, left
out of the dict and of equality.
"""

import os
import pathlib

import pytest
import torch

from repro.distributed import sharding as jsh
from repro_torch.distributed import sharding as tsh

GRID = [(ndiv, n) for ndiv in (1, 2, 3, 4, 5, 7, 8, 12)
        for n in range(1, ndiv + 1)]


def _view(spec):
    return (spec.index, spec.nshards, spec.block_lo, spec.block_hi,
            spec.ndiv, spec.first, spec.last, spec.nblocks,
            list(spec.blocks), spec.owned_units(), spec.ghost_units(),
            spec.unit_keys(), spec.halo_units(), spec.to_dict())


@pytest.mark.parametrize("ndiv,nshards", GRID)
def test_partition_and_footprints_equal_reference(ndiv, nshards):
    ref = jsh.partition_domain(ndiv, nshards)
    got = tsh.partition_domain(ndiv, nshards)
    assert [_view(s) for s in got] == [_view(s) for s in ref]
    # the shards tile the blocks, and the owned units tile the plan's
    assert [b for s in got for b in s.blocks] == list(range(ndiv))
    owned = sorted(u for s in got for u in s.owned_units())
    assert owned == sorted([("R", i) for i in range(ndiv)]
                           + [("C", j) for j in range(ndiv - 1)])
    for s in got:
        assert tsh.ShardSpec.from_dict(s.to_dict()) == s
        assert s.device is None


@pytest.mark.parametrize("ndiv,nshards", [(4, 0), (4, -1), (3, 4), (1, 2)])
def test_partition_rejections_equal_reference(ndiv, nshards):
    with pytest.raises(ValueError) as jerr:
        jsh.partition_domain(ndiv, nshards)
    with pytest.raises(ValueError) as terr:
        tsh.partition_domain(ndiv, nshards)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("bad", [
    dict(index=2, nshards=2, block_lo=0, block_hi=1, ndiv=4),
    dict(index=0, nshards=1, block_lo=2, block_hi=2, ndiv=4),
    dict(index=0, nshards=1, block_lo=0, block_hi=5, ndiv=4),
])
def test_invalid_spec_rejected(bad):
    with pytest.raises(ValueError):
        tsh.ShardSpec(**bad)


def test_device_pins_round_robin_and_not_persisted():
    devs = [torch.device("cpu"), "cpu"]
    specs = tsh.partition_domain(8, 3, devices=devs)
    assert [s.device for s in specs] == [torch.device("cpu")] * 3
    assert tsh.pins(None, 3) == [None, None, None]
    assert tsh.pins(["cpu", "meta"], 3) == [
        torch.device("cpu"), torch.device("meta"), torch.device("cpu")]
    for s in specs:
        assert "device" not in s.to_dict()
        back = tsh.ShardSpec.from_dict(s.to_dict(), device="cpu")
        assert back == s and back.device == "cpu"


# ----------------------------------------------------------------------
# the logical-axis half: specs, placements and hints against the
# reference's, on abstract meshes (no device)
# ----------------------------------------------------------------------

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, smoke  # noqa
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = jsh.DEFAULT_RULES


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _jspec(axes, shape, mesh):
    return tuple(jsh.resolve_spec(axes, tuple(shape), RULES, mesh))


def _tspec(axes, shape, mesh):
    return tsh.resolve_spec(axes, tuple(shape), tsh.DEFAULT_RULES, mesh)


def _ref_flat(axes, shapes, prefix=""):
    """``{"layers/wq": (axes, shape), ...}`` of the reference's trees."""
    out = {}
    for k, a in axes.items():
        if isinstance(a, dict):
            out.update(_ref_flat(a, shapes[k], prefix + k + "/"))
        else:
            out[prefix + k] = (a, tuple(shapes[k].shape))
    return out


def test_default_rules_and_the_documented_spec():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    mesh = _mesh("4x2")
    assert _tspec(("batch", "seq", "embed"), (8, 16, 32), mesh) == (
        "data", None, None) == _jspec(("batch", "seq", "embed"),
                                      (8, 16, 32), mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_optimizer_specs_equal_reference(arch, mesh):
    """Every parameter's resolved spec, the port's per-layer leaf
    against the reference's ``(L, ...)`` stack without its unsharded
    ``L`` entry; the optimizer state's axes are the parameters'."""
    m = _mesh(mesh)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jaxes = JM.param_logical_axes(jcfg)
    ref = _ref_flat(jaxes, jax.eval_shape(
        lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
    taxes = TM.param_logical_axes(tcfg)
    specs = TM.param_specs(tcfg)
    assert list(taxes) == list(specs)
    seen = set()
    for name, t in specs.items():
        parts = name.split(".")
        key = f"{parts[0]}/{parts[-1]}" if len(parts) > 1 else name
        axes, shape = ref[key]
        want = _jspec(axes, shape, m)
        if parts[0] == "layers":
            assert axes[0] is None and want[0] is None
            axes, shape, want = axes[1:], shape[1:], want[1:]
        assert taxes[name] == axes and tuple(t.shape) == shape, name
        assert _tspec(taxes[name], t.shape, m) == want, name
        seen.add(key)
    assert seen == set(ref)
    topt = TA.state_logical_axes(taxes, error_feedback=True)
    jopt = JA.state_logical_axes(jaxes, error_feedback=True)
    assert topt.step == jopt.step == ()
    assert topt.m is topt.v is topt.ef is taxes


def _cache_cfgs(arch):
    for planes in (0, 16):
        yield (dataclasses.replace(jget_config(arch),
                                   kv_compress_planes=planes),
               dataclasses.replace(get_config(arch),
                                   kv_compress_planes=planes))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh):
    """The decode cache of ``decode_32k``, raw and compressed
    (``cache_logical_axes`` / ``compressed_cache_logical_axes``): every
    field's shape, axes and resolved spec."""
    m = _mesh(mesh)
    shape = SHAPES["decode_32k"]
    for jcfg, tcfg in _cache_cfgs(arch):
        jaxes, taxes = JM.cache_logical_axes(jcfg), TM.cache_logical_axes(
            tcfg)
        assert type(taxes).__name__ == type(jaxes).__name__
        assert tuple(taxes) == tuple(jaxes)
        jc, tc = JST.cache_specs(jcfg, shape), TST.cache_specs(tcfg, shape)
        for field, axes in zip(jaxes._fields, jaxes):
            if axes is None or field == "length":
                assert getattr(tc, field) is None or field == "length"
                continue
            t, j = getattr(tc, field), getattr(jc, field)
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(j.shape), field
            assert _tspec(axes, t.shape, m) == _jspec(axes, j.shape, m)
        if jcfg.kv_compress_planes and jcfg.family in (
                "dense", "moe", "audio", "vlm"):
            assert (TM.compressed_cache_logical_axes(tcfg)
                    == tuple(JM.compressed_cache_logical_axes(jcfg)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_for_equal_reference(arch, mesh):
    """``shardings_for`` at train, prefill and decode: every leaf's
    DTensor placements are the reference's ``NamedSharding`` spec laid
    over the mesh, and the specs' shapes match; the batch axes are the
    reference's."""
    from repro.configs.base import SHAPES as JSHAPES

    m = _mesh(mesh)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        jshape, tshape = JSHAPES[kind], SHAPES[kind]
        assert (TST.batch_logical_axes(tcfg, tshape)
                == JST.batch_logical_axes(jcfg, jshape))
        (jsh_tree, jspecs) = JST.shardings_for(jcfg, jshape, m, RULES)
        (tsh_tree, tspecs) = TST.shardings_for(tcfg, tshape, m, RULES)
        assert len(jsh_tree) == len(tsh_tree)
        assert TST.donate_argnums_for(tshape) == JST.donate_argnums_for(
            jshape)
        # params: the port's per-layer leaves against the stacks
        flat = {}

        def walk(tree, specs, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, specs[k], prefix + k + "/")
                else:
                    flat[prefix + k] = (tuple(v.spec), tuple(specs[k].shape))

        walk(jsh_tree[0], jspecs[0])
        for name, pl in tsh_tree[0].items():
            parts = name.split(".")
            key = f"{parts[0]}/{parts[-1]}" if len(parts) > 1 else name
            spec, shape = flat[key]
            if parts[0] == "layers":
                spec, shape = spec[1:], shape[1:]
            assert tuple(tspecs[0][name].shape) == shape, name
            assert pl == tsh.placements(spec + (None,) * (
                len(shape) - len(spec)), m), name
        # batch (and the optimizer state's step, cache fields)
        for k, pl in tsh_tree[-1].items():
            want = tuple(jsh_tree[-1][k].spec)
            assert pl == tsh.placements(want, m), k
            assert tuple(tspecs[-1][k].shape) == tuple(jspecs[-1][k].shape)
        if kind == "train_4k":
            assert tsh_tree[1].step == tsh.placements((), m)
            assert tsh_tree[1].m == tsh_tree[0] == tsh_tree[1].v
        if kind == "decode_32k":
            for field in jspecs[1]._fields:
                j = getattr(jsh_tree[1], field)
                t = getattr(tsh_tree[1], field)
                if j is None or field == "length":
                    continue
                assert t == tsh.placements(tuple(j.spec), m), field


def test_logical_is_the_tensor_itself_without_a_mesh_of_ranks():
    """``logical`` returns ``x`` itself without rules, on a (1, 1) mesh
    and, for a plain tensor, on a larger mesh."""
    x = torch.ones(8, 16, 32)
    assert tsh.logical(x, "batch", "seq", "embed") is x
    for mesh in ("1x1", "4x2"):
        with tsh.use_rules(_mesh(mesh), tsh.DEFAULT_RULES):
            assert tsh.current_rules() is tsh.DEFAULT_RULES
            assert tsh.logical(x, "batch", "seq", "embed") is x
    assert tsh.current_mesh() is None and tsh.current_rules() is None


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "qwen3-moe-235b-a22b"])
def test_forward_under_rules_on_one_rank_is_bitwise(arch):
    """A smoke forward and loss under ``use_rules`` on a (1, 1) mesh are
    bit for bit the same without (the seven hints are no-ops there)."""
    cfg = smoke(get_config(arch))
    model = TM.init_params(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)).astype(
        np.int32))
    pos = torch.arange(12, dtype=torch.int32).repeat(2, 1)
    batch = {"tokens": toks, "labels": toks, "positions": pos}
    plain = TM.forward(cfg, model, toks, pos)[0], TM.loss_fn(cfg, model,
                                                             batch)
    with tsh.use_rules(_mesh("1x1"), tsh.DEFAULT_RULES):
        ruled = TM.forward(cfg, model, toks, pos)[0], TM.loss_fn(
            cfg, model, batch)
    for a, b in zip(plain, ruled):
        assert torch.equal(a, b)


def test_meshes_need_their_process_group():
    """``launch/mesh.py``'s shapes and names, and without a process
    group of that size the ranks that are missing."""
    with pytest.raises(RuntimeError, match=r"ranks 0\.\.255 are missing"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match=r"ranks 0\.\.511 are missing"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match=r"\(4, 2\) mesh over \('data', "
                                           r"'model'\)"):
        tmesh.make_mesh_for_devices(8, 2, device="cpu")
    with pytest.raises(ValueError, match="model-parallel"):
        tmesh.make_mesh_for_devices(8, 3, device="cpu")


def test_meshes_run_on_the_cpu_only_when_asked():
    """Without a card and without ``device="cpu"``, ``launch/mesh.py``
    raises ``NoCudaDevice``, as every entry point of the port does,
    before it looks for a process group."""
    from repro_torch.device import NoCudaDevice

    if torch.cuda.is_available():
        pytest.skip("checks the machine without a card")

    with pytest.raises(NoCudaDevice):
        tmesh.make_production_mesh()
    with pytest.raises(NoCudaDevice):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(NoCudaDevice):
        tmesh.make_mesh_for_devices(8, 2)


def test_place_shards_over_two_gloo_ranks(tmp_path):
    """``checkpoint.place`` over two gloo ranks (two processes, a
    ``FileStore`` under ``tmp_path``, joined within 60 s): on a (2, 1)
    and a (1, 2) mesh every parameter's local shard has the shape its
    resolved spec gives, some are sharded, and each gathers back to the
    original."""
    import json
    import subprocess
    import sys

    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).with_name(
            "torch_place_worker.py")), str(r), str(store),
         str(tmp_path / f"rank{r}.json")],
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path)))
        for r in range(2)]
    try:
        rcs = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert rcs == [0, 0]
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert len(got) == 2 * len(TM.param_logical_axes(
            smoke(get_config("qwen2-1.5b"))))
        for key, (local, want, whole, sharded) in got.items():
            assert local == want and whole, key
        assert sum(v[3] for v in got.values()) > 0

"""The port's checkpoint module (``repro_torch.checkpoint.checkpoint``)
against ``repro.checkpoint.checkpoint``: the same on-disk format.

* the same tree saved by both packages (raw, zstd, and lossy at 16
  planes on the CPU's plain codec) gives byte-identical shard files and
  equal manifests, digests included, and each package loads the other's
  snapshot leaf for leaf, bit for bit;
* flat keys in the reference's order; ``restore`` rebuilds the tree;
  torch tensors (float32, uint32, bfloat16) save as the reference's
  arrays of the same values;
* integrity, as ``tests/test_integrity.py``: a tampered shard, manifest
  ``extra`` or unit digest is refused by name, the last good snapshot is
  found behind a corrupt one, a snapshot without digests still loads;
* ``keep=N`` never collects a directory a kept manifest references, and
  ``add_external`` chains point at the original directory;
* lossy leaves need a device: without ``device="cpu"`` and without a
  card, ``save``/``load`` of one raise ``NoCudaDevice``.
"""

import collections
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.executor import AsyncExecutor
from repro_torch.core.outofcore import HostUnitStore, OOCConfig, \
    paper_code_fields
from repro_torch.distributed.fault import ChecksumError, FaultInjector, \
    FaultPlan, FaultSpec, RetryPolicy, UnrecoverableFault
from repro_torch.kernels.stencil import ref as stencil_ref

Pair = collections.namedtuple("Pair", ["lo", "hi"])
CODECS = {
    "raw": dict(zstd_level=0),
    "zstd": dict(zstd_level=3),
    "lossy16-raw": dict(zstd_level=0, lossy_planes=16),
    "lossy16-zstd": dict(zstd_level=3, lossy_planes=16),
}


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": [
            {"w": rng.standard_normal((40, 50)).astype(np.float32),
             "b": np.zeros((50,), np.float32)},
            (rng.integers(0, 9, (7,)).astype(np.int32), None),
        ],
        "big": rng.standard_normal(3001).astype(np.float32) * 7.3,
        "pair": Pair(np.float32(2.5),
                     rng.integers(0, 2**32, (5,), dtype=np.uint32)),
        "f64": rng.standard_normal((4, 4)),
    }


def _files(path):
    p = pathlib.Path(path)
    return {f.name: f.read_bytes() for f in sorted(p.iterdir())}


def _manifest(path):
    return json.loads((pathlib.Path(path) / "manifest.json").read_text())


def test_flat_keys_match_reference():
    tree = _tree()
    assert list(ckpt._flatten(tree)) == list(jckpt._flatten(tree))
    step_j = jckpt._flatten(tree)
    for key, leaf in ckpt._flatten(tree).items():
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(step_j[key]))


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_same_tree_same_bytes_both_ways(tmp_path, codec):
    kw = CODECS[codec]
    tree = _tree()
    pj = jckpt.save(str(tmp_path / "j"), 5, tree, extra={"a": [1, 2]}, **kw)
    pt = ckpt.save(str(tmp_path / "t"), 5, tree, extra={"a": [1, 2]},
                   device="cpu", **kw)
    assert pathlib.Path(pj).name == pathlib.Path(pt).name
    assert _files(pj) == _files(pt)
    assert _manifest(pj) == _manifest(pt)
    if "lossy" in codec:
        assert _manifest(pt)["leaves"]["big"]["codec"].startswith("zfp+")
    # each package reads the other's snapshot, leaf for leaf
    sj, from_t, ej = jckpt.load(pt)
    st, from_j, et = ckpt.load(pj, device="cpu")
    assert sj == st == 5 and ej == et == {"a": [1, 2]}
    assert list(from_j) == list(from_t)
    for key in from_t:
        np.testing.assert_array_equal(from_j[key], np.asarray(from_t[key]))
        assert from_j[key].dtype == np.asarray(from_t[key]).dtype


def test_restore_rebuilds_the_tree(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 1, tree, zstd_level=0)
    step, back = ckpt.restore(path, tree)
    assert step == 1
    assert isinstance(back["pair"], Pair)
    assert back["layers"][1][1] is None
    assert isinstance(back["layers"][1], tuple)
    for key, leaf in ckpt._flatten(back).items():
        np.testing.assert_array_equal(leaf, ckpt._flatten(tree)[key])


def test_torch_leaves_save_as_the_reference_arrays(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((6, 7)).astype(np.float32)
    u32 = rng.integers(0, 2**32, (9,), dtype=np.uint32)
    bf = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)
                          ).to(torch.bfloat16)
    ttree = {"f": torch.from_numpy(f32), "u": torch.from_numpy(
        u32.view(np.int32)).view(torch.uint32), "bf": bf}
    jtree = {"f": f32, "u": u32,
             "bf": jnp.asarray(bf.float().numpy(), dtype=jnp.bfloat16)}
    pt = ckpt.save(str(tmp_path / "t"), 2, ttree, zstd_level=0)
    pj = jckpt.save(str(tmp_path / "j"), 2, jtree, zstd_level=0)
    assert _files(pt) == _files(pj)
    assert _manifest(pt)["leaves"]["bf"]["dtype"] == "bfloat16"
    for path in (pt, pj):
        _, leaves, _ = ckpt.load(path)
        assert leaves["bf"].dtype == torch.bfloat16
        assert torch.equal(leaves["bf"].view(torch.int16),
                           bf.view(torch.int16))
        np.testing.assert_array_equal(leaves["u"], u32)
    _, jleaves, _ = jckpt.load(pt)
    np.testing.assert_array_equal(jleaves["bf"].view(np.uint16),
                                  bf.view(torch.int16).numpy().view(
                                      np.uint16))


def test_lossy_leaves_need_a_device(tmp_path, monkeypatch):
    tree = _tree()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.save(str(tmp_path / "a"), 1, tree, zstd_level=0,
                  lossy_planes=16)
    assert ckpt.latest(str(tmp_path / "a")) is None  # tmp dir aborted
    # no lossy leaf: nothing is resolved, nothing is computed on a device
    plain = ckpt.save(str(tmp_path / "b"), 1, tree, zstd_level=0)
    ckpt.load(plain)
    lossy = ckpt.save(str(tmp_path / "c"), 1, tree, zstd_level=0,
                      lossy_planes=16, device="cpu")
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.load(lossy)
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.restore(lossy, tree)
    _, back = ckpt.restore(lossy, tree, device="cpu")
    err = np.abs(back["big"] - tree["big"]).max()
    assert 0 < err < 0.05 * np.abs(tree["big"]).max()


def test_shard_write_faults_retry_then_give_up(tmp_path):
    plan = FaultPlan([FaultSpec(kind="shard", unit="big", attempts=2)])
    inj = FaultInjector(plan)
    path = ckpt.save(str(tmp_path / "ok"), 1, _tree(), zstd_level=0,
                     injector=inj, retry=RetryPolicy(attempts=3))
    assert inj.counts["shard_faults"] == 2
    ckpt.load(path)
    with pytest.raises(UnrecoverableFault, match="shard write of big"):
        ckpt.save(str(tmp_path / "bad"), 1, _tree(), zstd_level=0,
                  injector=FaultInjector(plan),
                  retry=RetryPolicy(attempts=2))
    assert ckpt.latest(str(tmp_path / "bad")) is None


# ----------------------------------------------------------------------
# gc and incremental chains
# ----------------------------------------------------------------------
def test_gc_keeps_directories_a_kept_manifest_references(tmp_path):
    tree = {"a": np.arange(4, dtype=np.float32),
            "b": np.ones(3, np.float32)}
    first = ckpt.save(str(tmp_path), 1, tree, zstd_level=0)
    entries = _manifest(first)["leaves"]
    # steps 2 and 3 reuse leaf "a" of step 1, the chain flattened
    for step, src in ((2, "step_0000000001"), (3, "step_0000000002")):
        w = ckpt.ShardWriter(str(tmp_path), step, zstd_level=0)
        prev = _manifest(tmp_path / src)["leaves"]
        w.add_external("a", prev["a"], src)
        w.add("b", tree["b"] + step)
        w.finalize(keep=1)
        assert _manifest(tmp_path / f"step_{step:010d}")["leaves"]["a"][
            "dir"] == "step_0000000001"
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_0000000001", "step_0000000003"]
    for load in (ckpt.load, jckpt.load):
        _, leaves, _ = load(str(tmp_path / "step_0000000003"))
        np.testing.assert_array_equal(leaves["a"], tree["a"])
        np.testing.assert_array_equal(leaves["b"], tree["b"] + 3)
    assert entries["a"]["file"] == "a.bin"
    # once no kept manifest points at step 1, gc collects it
    ckpt.save(str(tmp_path), 4, tree, zstd_level=0, keep=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000004"]


# ----------------------------------------------------------------------
# integrity (tests/test_integrity.py on the port)
# ----------------------------------------------------------------------
SHAPE = (32, 8, 8)


def _initial():
    p_cur = stencil_ref.ricker_source(SHAPE).numpy()
    return (0.95 * p_cur).astype(np.float32), p_cur, \
        np.full(SHAPE, 0.07, np.float32)


def _executor(code=2):
    cfg = OOCConfig(SHAPE, 2, 1, paper_code_fields(code), backend="ref",
                    device="cpu")
    return AsyncExecutor(cfg, *_initial())


def _two_checkpoints(tmp_path):
    live = _executor()
    live.run(1)
    first = live.checkpoint(str(tmp_path), zstd_level=0)
    live.run(1)
    second = live.checkpoint(str(tmp_path), zstd_level=0)
    assert first != second
    return live, pathlib.Path(first), pathlib.Path(second)


def _flip_byte(path: pathlib.Path, offset: int = 7) -> None:
    raw = bytearray(path.read_bytes())
    raw[offset % len(raw)] ^= 0x04
    path.write_bytes(bytes(raw))


def test_shard_tamper_refused_naming_the_shard(tmp_path):
    _, first, second = _two_checkpoints(tmp_path)
    shard = sorted(second.glob("p_cur*"))[0]
    _flip_byte(shard)
    for load in (ckpt.load, jckpt.load):
        with pytest.raises(Exception) as e:
            load(str(second))
        assert type(e.value).__name__ == "ChecksumError"
        assert shard.name in str(e.value)
        assert "restore from an earlier step_<k>" in str(e.value)
    step, leaves, extra = ckpt.load(str(first))
    assert leaves and extra["kind"] == "ooc-executor"


def test_manifest_extra_tamper_refused(tmp_path):
    _, first, second = _two_checkpoints(tmp_path)
    mpath = second / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["extra"]["progress"]["sweeps_done"] += 1
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ChecksumError) as e:
        ckpt.read_manifest(str(second))
    assert str(second) in str(e.value)
    with pytest.raises(ChecksumError):
        AsyncExecutor.restore(str(second), device="cpu")
    ckpt.read_manifest(str(first))


def test_restore_refuses_tampered_unit_digest():
    live = _executor()
    live.run(2)
    live.flush()
    leaves, meta = live.store.state_dict()
    tampered = dict(leaves)
    key = sorted(k for k in leaves if k.endswith(".payload"))[0]
    tampered[key] = np.asarray(FaultInjector.corrupt(leaves[key]))
    with pytest.raises(ChecksumError) as e:
        HostUnitStore(live.cfg).load_state(tampered, meta)
    assert key.rsplit(".", 1)[0] in str(e.value)


def test_load_last_good_skips_corrupt_newest(tmp_path):
    _, first, second = _two_checkpoints(tmp_path)
    _flip_byte(sorted(second.glob("p_prev*"))[0])
    _, _, _, path = AsyncExecutor._load_last_good(str(tmp_path))
    assert path == str(first)
    _flip_byte(sorted(first.glob("p_prev*"))[0])
    with pytest.raises(UnrecoverableFault):
        AsyncExecutor._load_last_good(str(tmp_path))


def test_snapshot_without_digests_still_loads(tmp_path):
    live = _executor()
    live.run(1)
    path = pathlib.Path(live.checkpoint(str(tmp_path), zstd_level=0))
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest.pop("manifest_crc32")
    for entry in manifest["leaves"].values():
        entry.pop("crc32", None)
    for u in manifest["extra"]["store"]["units"].values():
        u.pop("crc32", None)
    mpath.write_text(json.dumps(manifest))
    resumed = AsyncExecutor.restore(str(tmp_path), device="cpu")
    assert resumed.sweeps_done == 1

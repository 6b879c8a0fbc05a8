"""Checkpoint, restore and the overlapped cut of the port's live engine
(``repro_torch.core.executor.AsyncExecutor``) on the CPU: the contract of
``tests/test_checkpoint_restore.py`` on the port.

* a quiesced snapshot taken mid-run (window parked, dirty residents,
  evictions) and an overlapped one taken at every sweep boundary, across
  schedules × budgets × policies, restore into a fresh engine that
  finishes bit for bit as the port's uninterrupted run;
* the cut's mechanics: progress record, cursor and version vector, the
  window left parked, copy-on-write keeping the pre-cut bytes in the
  shard, policy triggers and validation, the wall budget, quiesced
  against overlapped, a gather in the middle of a snapshot, incremental
  reuse, a failed flush reissued;
* the snapshot's transfers (``ckpt=True`` D2H records) and pin/flush
  counters those of the port's task graph and of ``repro``'s engine;
* a paced snapshot chunk never runs the staging pool dry;
* restore across packages, both ways: ``repro``'s ``"ref"`` manifest,
  its ``"pallas"`` read as ``"cuda"`` (which needs a card), fields within
  ``GATHER_RTOL`` of ``repro``'s.
"""

import functools
import json
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core.executor import AsyncExecutor as JExecutor
from repro.core.executor import CheckpointPolicy as JPolicy
from repro.core.outofcore import OOCConfig as JConfig
from repro.core.outofcore import paper_code_fields as jfields
from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.executor import AsyncExecutor, CheckpointPolicy
from repro_torch.core.outofcore import OOCConfig, paper_code_fields
from repro_torch.core.taskgraph import Schedule, build_sweep_tasks
from repro_torch.distributed.fault import ReissuePolicy
from repro_torch.kernels.stencil import ref as stencil_ref
from test_torch_outofcore import GATHER_RTOL

SHAPE = (96, 12, 12)
BT = 2
EVICTING = 100_000  # forces dirty evictions mid-run
ALL_FITS = 1 << 30
FIELDS = ("p_cur", "p_prev")


def _initial():
    p_cur = stencil_ref.ricker_source(SHAPE).numpy()
    return (0.95 * p_cur).astype(np.float32), p_cur, \
        np.full(SHAPE, 0.07, np.float32)


def _cfg(code=2):
    return OOCConfig(SHAPE, 4, BT, paper_code_fields(code), backend="ref",
                     device="cpu")


def _executor(code=2, budget=EVICTING, schedule="depth2",
              policy="write-back", **kw):
    return AsyncExecutor(_cfg(code), *_initial(), schedule=schedule,
                         cache_bytes=budget, policy=policy, **kw)


def _restore(path, **kw):
    return AsyncExecutor.restore(str(path), device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _uninterrupted(code=2, sweeps=4, schedule="depth2", budget=EVICTING,
                   policy="write-back"):
    ref = _executor(code, budget, schedule, policy)
    ref.run(sweeps * BT)
    return {n: ref.gather(n) for n in FIELDS}


def _same(eng, want):
    for name in FIELDS:
        np.testing.assert_array_equal(eng.gather(name), want[name])


def _steps(root):
    return sorted(int(p.name.split("_")[1]) for p in pathlib.Path(root)
                  .iterdir() if p.name.startswith("step_"))


# ----------------------------------------------------------------------
# the acceptance bar: snapshot -> fresh engine -> bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["paper", "unitgrain", "depth2"])
@pytest.mark.parametrize("policy", ["write-back", "write-through"])
def test_midrun_checkpoint_restores_bit_identical(tmp_path, schedule,
                                                  policy):
    want = _uninterrupted(schedule=schedule, policy=policy)
    live = _executor(schedule=schedule, policy=policy)
    live.sweep()
    live.sweep()  # the window is still parked: an in-flight snapshot
    assert live.stats()["pending"] > 0
    if policy == "write-back":
        assert live.stats()["cache_dirty_bytes"] > 0
        assert live.stats()["cache"]["evictions"] > 0
    live.checkpoint(str(tmp_path))
    resumed = _restore(tmp_path)
    resumed.run(2 * BT)
    _same(resumed, want)


@pytest.mark.parametrize("schedule", ["paper", "unitgrain", "depth2"])
@pytest.mark.parametrize("budget,policy", [
    (EVICTING, "write-back"), (ALL_FITS, "write-back"),
    (0, "write-back"), (ALL_FITS, "write-through"),
])
@pytest.mark.parametrize("cut", [1, 2, 3])
def test_overlapped_cut_restores_bit_identical_every_position(
    tmp_path, schedule, budget, policy, cut
):
    """An overlapped snapshot at any boundary (window parked, dirty
    residents pinned, copy-on-write under eviction pressure) restores
    bit for bit; every published snapshot, not only the newest."""
    want = _uninterrupted(schedule=schedule, budget=budget, policy=policy)
    live = _executor(schedule=schedule, budget=budget, policy=policy)
    live.run(4 * BT, ckpt_policy=CheckpointPolicy(str(tmp_path),
                                                  every_sweeps=cut))
    _same(live, want)
    assert live.lanes.free_slots == len(live.lanes._slots)
    steps = _steps(tmp_path)
    assert steps, "the periodic policy published nothing"
    for step in steps:
        resumed = _restore(tmp_path / f"step_{step:010d}")
        assert resumed.sweeps_done == step
        resumed.run((4 - step) * BT)
        _same(resumed, want)


# ----------------------------------------------------------------------
# the quiesced cut's mechanics
# ----------------------------------------------------------------------
def test_checkpoint_quiesces_flushes_and_records_progress(tmp_path):
    live = _executor(budget=ALL_FITS)
    live.sweep()
    assert live.stats()["pending"] > 0
    path = live.checkpoint(str(tmp_path))
    st = live.stats()
    assert st["pending"] == 0 and st["cache_dirty_bytes"] == 0
    for key in live.store.unit_keys():
        assert live.store.host_current(*key)
    extra = ckpt.read_manifest(path)["extra"]
    assert extra["kind"] == "ooc-executor" and extra["format"] == 1
    prog = extra["progress"]
    assert (prog["sweeps_done"], prog["schedule"], prog["policy"],
            prog["cache_bytes"], prog["shard"]) == (
        1, "depth2", "write-back", ALL_FITS, None)
    assert extra["cfg"]["shape"] == list(SHAPE)
    assert max(u["version"] for u in extra["store"]["units"].values()) == 1
    assert st["checkpoint"]["quiesced"] == 1
    assert st["checkpoint"]["shard_bytes"] > 0


def test_restore_rebuilds_cursor_config_and_versions(tmp_path):
    live = _executor(code=4, budget=ALL_FITS, schedule="depth3")
    live.run(3 * BT)
    live.checkpoint(str(tmp_path))
    resumed = _restore(tmp_path)
    assert resumed.sweeps_done == 3
    assert resumed.schedule.name == "depth3"
    assert resumed.cache.budget_bytes == ALL_FITS
    assert resumed.cache.policy == "write-back"
    assert resumed.cfg.to_dict() == live.cfg.to_dict()
    for key in live.store.unit_keys():
        assert resumed.store.version_of(*key) == live.store.version_of(*key)
        assert resumed.store.host_current(*key)
    other = _restore(tmp_path, schedule="paper", cache_bytes=0,
                     policy="write-through")
    assert other.schedule.name == "paper" and not other.cache.enabled


def test_custom_schedule_roundtrips_through_checkpoint(tmp_path):
    custom = Schedule("bespoke", codec_sync=True, window=3)
    live = AsyncExecutor(_cfg(), *_initial(), schedule=custom,
                         cache_bytes=EVICTING)
    live.run(2 * BT)
    live.checkpoint(str(tmp_path))
    resumed = _restore(tmp_path)
    assert resumed.schedule == custom and resumed.depth == 3


def test_restore_under_different_policy_stays_bit_exact(tmp_path):
    want = _uninterrupted()
    live = _executor()
    live.run(2 * BT)
    live.checkpoint(str(tmp_path))
    resumed = _restore(tmp_path, policy="write-through", cache_bytes=0)
    resumed.run(2 * BT)
    _same(resumed, want)


def test_checkpoint_of_stale_host_store_is_refused():
    live = _executor(budget=ALL_FITS)
    live.run(2 * BT)  # drains the window; dirty residents remain
    assert live.stats()["cache_dirty_bytes"] > 0
    with pytest.raises(RuntimeError, match="flush residency first"):
        live.store.state_dict()


def test_partial_writer_crash_leaves_latest_checkpoint_intact(tmp_path):
    live = _executor()
    live.run(2 * BT)
    good = live.checkpoint(str(tmp_path))
    crash = tmp_path / "tmp.3"
    crash.mkdir()
    (crash / "half-written.bin").write_bytes(b"\x00" * 17)
    assert ckpt.latest(str(tmp_path)) == good
    assert _restore(tmp_path).sweeps_done == 2


def test_checkpoint_gc_keeps_newest(tmp_path):
    live = _executor(code=1, budget=0)
    for _ in range(4):
        live.sweep()
        live.checkpoint(str(tmp_path), keep=2)
    assert _steps(tmp_path) == [3, 4]
    assert _restore(tmp_path).sweeps_done == 4


def test_restore_refuses_foreign_checkpoint_and_missing_device(
        tmp_path, monkeypatch):
    ckpt.save(str(tmp_path / "w"), 7, {"w": np.zeros((4,), np.float32)})
    with pytest.raises(ValueError, match="not an AsyncExecutor"):
        _restore(tmp_path / "w")
    with pytest.raises(FileNotFoundError):
        _restore(tmp_path / "nowhere")
    live = _executor()
    live.run(BT)
    live.checkpoint(str(tmp_path / "c"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        AsyncExecutor.restore(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _restore(tmp_path / "c", backend="cuda")


def test_lossy_checkpoint_codes_on_the_engine_device(tmp_path, monkeypatch):
    """``checkpoint(lossy_planes=)`` runs the raw float32 units through
    the codec on the engine's device (the plain version on the CPU); the
    leaves load within the codec's error, and not without a device."""
    live = _executor(code=4, budget=ALL_FITS)
    live.run(BT)
    path = live.checkpoint(str(tmp_path), lossy_planes=16, zstd_level=0)
    leaves = ckpt.read_manifest(path)["leaves"]
    assert leaves["p_cur.R0"]["codec"] == "zfp+raw"
    assert leaves["p_prev.R0.payload"]["codec"] == "raw"
    exact, _ = live.store.state_dict()
    _, got, _ = ckpt.load(path, device="cpu")
    scale = np.abs(exact["p_cur.R0"]).max()
    assert 0 < np.abs(got["p_cur.R0"] - exact["p_cur.R0"]).max() < (
        0.05 * scale)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.load(path)
    with pytest.raises(device_mod.NoCudaDevice):
        AsyncExecutor.restore(path)


@pytest.mark.parametrize("level", [0, 3])
def test_incremental_checkpoint_reuses_unchanged_units(tmp_path, level):
    """vel2 never changes: an incremental cut points its shards at the
    first snapshot, whose directory gc keeps while it is referenced; the
    restored run is bit for bit."""
    want = _uninterrupted(code=4)
    live = _executor(code=4)
    live.run(BT)
    first = live.checkpoint(str(tmp_path), zstd_level=level, keep=1)
    live.run(BT)
    second = live.checkpoint(str(tmp_path), zstd_level=level, keep=1,
                             incremental=True)
    reused = live.stats()["checkpoint"]["units_reused"]
    nvel = sum(1 for k in live.store.unit_keys() if k[0] == "vel2")
    assert reused == 2 * nvel  # payload + emax of every vel2 unit
    entries = ckpt.read_manifest(second)["leaves"]
    assert entries["vel2.R0.payload"]["dir"] == pathlib.Path(first).name
    assert sorted(_steps(tmp_path)) == [1, 2]  # the source is kept
    resumed = _restore(tmp_path)
    resumed.run(2 * BT)
    _same(resumed, want)


def _flaky_store(live, fail_times=1):
    orig_put = live.store.put
    state = {"left": fail_times}

    def flaky(field, kind, idx, value, version=None, **kw):
        if state["left"] > 0:
            state["left"] -= 1
            raise RuntimeError("injected flush fault")
        return orig_put(field, kind, idx, value, version=version, **kw)

    live.store.put = flaky


def test_failed_flush_is_reissued_and_snapshot_completes(tmp_path):
    want = _uninterrupted(budget=ALL_FITS)
    live = _executor(budget=ALL_FITS, reissue=ReissuePolicy(factor=3.0))
    live.run(2 * BT)
    _flaky_store(live)
    live.checkpoint(str(tmp_path))
    assert live.stats()["cache"]["flush_reissues"] == 1
    assert live.stats()["cache_dirty_bytes"] == 0
    resumed = _restore(tmp_path)
    resumed.run(2 * BT)
    _same(resumed, want)
    plain = _executor(budget=ALL_FITS)
    plain.run(2 * BT)
    _flaky_store(plain)
    with pytest.raises(RuntimeError, match="injected flush fault"):
        plain.checkpoint(str(tmp_path / "p"))
    assert plain.stats()["cache_dirty_bytes"] > 0


# ----------------------------------------------------------------------
# the overlapped cut's mechanics
# ----------------------------------------------------------------------
def test_overlapped_cut_does_not_drain_the_window(tmp_path):
    live = _executor(budget=ALL_FITS)
    live.sweep()
    live.sweep()
    pending = live.stats()["pending"]
    assert pending > 0
    live.begin_checkpoint(str(tmp_path))
    st = live.stats()
    assert st["pending"] == pending
    assert st["cache"]["pins"] > 0
    assert st["ckpt_pending_units"] > 0
    assert st["cache_dirty_bytes"] > 0
    assert live.last_checkpoint_path is None
    live.sweep()
    live.finish()
    assert live.stats()["ckpt_pending_units"] == 0
    assert live.last_checkpoint_path is not None
    assert sum(t.ckpt for t in live.transfers) > 0
    assert _restore(tmp_path).sweeps_done == 2


def test_overlapped_cut_cow_keeps_precut_bytes(tmp_path):
    """The next sweep overwrites pinned units before their snapshot D2H
    (the queue rotated): the shadows hand the snapshot the pre-cut
    payloads, which the shards hold byte for byte."""
    want = _uninterrupted(budget=ALL_FITS)
    live = _executor(budget=ALL_FITS)
    live.sweep()
    live.sweep()
    live.begin_checkpoint(str(tmp_path))
    precut = {key: live.cache.pinned_entry(key).value
              for key, _ in live._ckpt_queue}
    precut = {key: (v.payload.clone(), v.emax.clone())
              if hasattr(v, "payload") else v.clone()
              for key, v in precut.items()}
    live._ckpt_queue.rotate(-(len(live._ckpt_queue) // 2))
    live.sweep()
    live.finish()
    assert live.stats()["cache"]["cow_shadows"] > 0
    assert live.stats()["cache"]["pinned_bytes"] == 0
    _, leaves, _ = ckpt.load(live.last_checkpoint_path)
    for (field, (kind, idx)), v in precut.items():
        ukey = f"{field}.{kind}{idx}"
        if isinstance(v, tuple):
            np.testing.assert_array_equal(
                leaves[ukey + ".payload"].view(np.int32),
                v[0].view(torch.int32).numpy())
            np.testing.assert_array_equal(leaves[ukey + ".emax"],
                                          v[1].numpy())
        else:
            np.testing.assert_array_equal(leaves[ukey], v.numpy())
    resumed = _restore(tmp_path)
    resumed.run(2 * BT)
    _same(resumed, want)


def test_paced_chunk_never_runs_the_pool_dry(tmp_path):
    """At the budget where every unit stays dirty-resident the cut pins
    the most units, and depth 3 parks the most writebacks: each snapshot
    D2H still finds a free slot (one at a time), and the pool is whole
    at the end."""
    live = _executor(budget=ALL_FITS, schedule="depth3")
    lanes = live.lanes
    low = []
    real = lanes._acquire

    def acquire(nbytes):
        slot = real(nbytes)
        low.append(lanes.free_slots)
        return slot

    lanes._acquire = acquire
    live.run(4 * BT, ckpt_policy=CheckpointPolicy(str(tmp_path),
                                                  every_sweeps=1))
    assert live.stats()["checkpoint"]["overlapped"] == 4
    assert live.stats()["cache"]["ckpt_flushes"] >= 4 * live._ckpt_chunk
    assert live._ckpt_chunk > 1  # several pinned units a visit
    assert min(low) >= 0 and lanes.free_slots == len(lanes._slots)
    _same(live, _uninterrupted(schedule="depth3", budget=ALL_FITS))


def test_ckpt_policy_triggers_and_validation(tmp_path):
    with pytest.raises(ValueError, match="every_sweeps and/or"):
        CheckpointPolicy(str(tmp_path))
    with pytest.raises(ValueError, match="mode"):
        CheckpointPolicy(str(tmp_path), every_sweeps=1, mode="bogus")
    with pytest.raises(ValueError, match=">= 1"):
        CheckpointPolicy(str(tmp_path), every_sweeps=0)
    pol = CheckpointPolicy(str(tmp_path), every_sweeps=2)
    assert [pol.due(s, 0.0) for s in (1, 2, 3, 4)] == [False, True, False,
                                                       True]
    wall = CheckpointPolicy(str(tmp_path), wall_budget_s=10.0)
    assert not wall.due(1, 9.9) and wall.due(1, 10.0)


def test_wall_budget_policy_snapshots_on_elapsed_time(tmp_path):
    live = _executor(code=1, budget=ALL_FITS)
    live.run(4 * BT, ckpt_policy=CheckpointPolicy(str(tmp_path),
                                                  wall_budget_s=0.0))
    assert live.stats()["checkpoint"]["overlapped"] == 4
    assert live.stats()["checkpoint"]["boundary_block_s"] > 0
    never = _executor(code=1, budget=ALL_FITS)
    never.run(4 * BT, ckpt_policy=CheckpointPolicy(
        str(tmp_path / "never"), wall_budget_s=1e9))
    assert never.stats()["checkpoint"]["snapshots"] == 0
    assert not (tmp_path / "never").exists()


def test_quiesced_policy_mode(tmp_path):
    want = _uninterrupted(budget=ALL_FITS)
    live = _executor(budget=ALL_FITS)
    live.run(4 * BT, ckpt_policy=CheckpointPolicy(
        str(tmp_path), every_sweeps=2, mode="quiesced"))
    st = live.stats()
    assert st["checkpoint"]["quiesced"] == 2
    assert st["cache"]["pins"] == 0
    assert sum(t.ckpt for t in live.transfers) == 0
    _same(live, want)
    resumed = _restore(tmp_path)
    resumed.run((4 - resumed.sweeps_done) * BT)
    _same(resumed, want)


def test_overlapped_and_quiesced_snapshots_restore_identically(tmp_path):
    a = _executor(budget=ALL_FITS)
    a.sweep()
    a.sweep()
    a.begin_checkpoint(str(tmp_path / "ov"))
    a.sweep()
    a.finish()
    b = _executor(budget=ALL_FITS)
    b.sweep()
    b.sweep()
    b.checkpoint(str(tmp_path / "qu"))
    ov = ckpt.read_manifest(a.last_checkpoint_path)
    qu = ckpt.read_manifest(b.last_checkpoint_path)
    assert ov["extra"]["store"] == qu["extra"]["store"]
    for key, entry in qu["leaves"].items():
        assert ov["leaves"][key]["crc32"] == entry["crc32"], key
    ra, rb = _restore(tmp_path / "ov"), _restore(tmp_path / "qu")
    assert ra.sweeps_done == rb.sweeps_done == 2
    ra.run(2 * BT)
    rb.run(2 * BT)
    np.testing.assert_array_equal(ra.gather("p_cur"), rb.gather("p_cur"))


def test_overlapped_snapshot_is_crash_consistent(tmp_path):
    live = _executor(budget=ALL_FITS)
    live.sweep()
    good = live.checkpoint(str(tmp_path))
    live.sweep()
    live.begin_checkpoint(str(tmp_path))
    live._drain_ckpt(paced=True)  # a few shards land, then "crash"
    assert live._ckpt_writer is not None
    assert ckpt.latest(str(tmp_path)) == good
    assert _restore(tmp_path).sweeps_done == 1


def test_gather_mid_snapshot_forces_completion(tmp_path):
    want = _uninterrupted(sweeps=2, budget=ALL_FITS)
    live = _executor(budget=ALL_FITS)
    live.sweep()
    live.sweep()
    live.begin_checkpoint(str(tmp_path))
    _same(live, want)
    st = live.stats()
    assert st["ckpt_pending_units"] == 0
    assert st["cache"]["pinned_bytes"] == 0
    assert live.last_checkpoint_path is not None
    assert _restore(tmp_path).sweeps_done == 2


# ----------------------------------------------------------------------
# the snapshot's transfers against the task graph and the reference
# ----------------------------------------------------------------------
def _log(transfers):
    return Counter((t.direction, t.field, t.unit, t.sweep, t.block,
                    t.wire_bytes, t.flush, t.ckpt) for t in transfers)


@pytest.mark.parametrize("budget", [0, EVICTING, ALL_FITS])
def test_ckpt_transfers_match_graph_and_reference(tmp_path, budget):
    cfg = _cfg(4)
    live = AsyncExecutor(cfg, *_initial(), schedule="depth2",
                         cache_bytes=budget)
    live.run(3 * BT, ckpt_policy=CheckpointPolicy(str(tmp_path / "t"),
                                                  every_sweeps=1))
    stats = {}
    tasks = build_sweep_tasks(cfg, sweeps=3, schedule="depth2",
                              cache_bytes=budget, ckpt_every=1, stats=stats)
    model = Counter((t.kind, t.field, t.unit, t.sweep, t.flush, t.ckpt)
                    for t in tasks if t.kind in ("h2d", "d2h"))
    real = Counter((t.direction, t.field, t.unit, t.sweep, t.flush, t.ckpt)
                   for t in live.transfers)
    assert real == model
    cache = live.stats()["cache"]
    for k in ("pins", "pin_releases", "cow_shadows", "ckpt_flushes",
              "ckpt_flush_wire_bytes", "flushes", "evictions"):
        assert cache[k] == stats[k], k
    jlive = JExecutor(JConfig(SHAPE, 4, BT, jfields(4)), *_initial(),
                      schedule="depth2", cache_bytes=budget)
    jlive.run(3 * BT, ckpt_policy=JPolicy(str(tmp_path / "j"),
                                          every_sweeps=1))
    assert _log(live.transfers) == _log(jlive.transfers)
    jcache = jlive.stats()["cache"]
    for k in ("pins", "pin_releases", "cow_shadows", "ckpt_flushes",
              "ckpt_flush_wire_bytes"):
        assert cache[k] == jcache[k], k
    assert _steps(tmp_path / "t") == _steps(tmp_path / "j")


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _close(got, want, code):
    tol = GATHER_RTOL[code] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_restore_across_packages_both_ways(tmp_path):
    """A ``repro`` snapshot resumes in the port and a port snapshot in
    ``repro``; each finishes within ``GATHER_RTOL`` of ``repro``'s
    uninterrupted run."""
    code = 4
    jref = JExecutor(JConfig(SHAPE, 4, BT, jfields(code)), *_initial(),
                     cache_bytes=EVICTING)
    jref.run(3 * BT)
    want = {n: jref.gather(n) for n in FIELDS}
    jlive = JExecutor(JConfig(SHAPE, 4, BT, jfields(code)), *_initial(),
                      cache_bytes=EVICTING)
    jlive.run(BT)
    jpath = jlive.checkpoint(str(tmp_path / "j"), zstd_level=0)
    port = _restore(jpath)  # "ref" recorded: stays "ref"
    assert port.cfg.backend == "ref" and port.cfg.device == "cpu"
    assert port.sweeps_done == 1
    port.run(2 * BT)
    for name in FIELDS:
        _close(port.gather(name), want[name], code)
    tlive = _executor(code)
    tlive.run(BT)
    tpath = tlive.checkpoint(str(tmp_path / "t"), zstd_level=0)
    back = JExecutor.restore(tpath)
    assert back.sweeps_done == 1 and back.cfg.backend == "ref"
    back.run(2 * BT)
    for name in FIELDS:
        _close(back.gather(name), want[name], code)


def test_reference_pallas_manifest_reads_as_cuda(tmp_path):
    """``repro``'s ``"pallas"`` backend is the port's ``"cuda"``: restored
    as recorded it needs a CUDA device, and runs the plain versions only
    when the caller asks for ``backend="ref"``."""
    jlive = JExecutor(JConfig(SHAPE, 4, BT, jfields(2)), *_initial())
    jlive.run(BT)
    path = pathlib.Path(jlive.checkpoint(str(tmp_path), zstd_level=0))
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["extra"]["cfg"]["backend"] = "pallas"
    manifest["manifest_crc32"] = jckpt._manifest_digest(manifest)
    mpath.write_text(json.dumps(manifest))
    assert OOCConfig.from_dict(manifest["extra"]["cfg"]).backend == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _restore(path)
    port = _restore(path, backend="ref")
    assert port.cfg.backend == "ref" and port.sweeps_done == 1

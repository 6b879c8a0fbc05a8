"""A whole run of each cell on the CPU at a tiny volume, the look for a
card skipped (``harness.run`` on the ``host_device`` fixture, the plain
kernels): sound runs come out correct; runs with the timed path broken
underneath, and the control, come out not correct."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import card, control, harness, spec
from repro_torch.core import outofcore
from repro_torch.core import executor as executor_mod
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.zfp import ops as zfp_ops

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
QUIET = {"log": lambda s: None}


def _run(cell, dev, seed=2 ** 31 + 7, seconds=0.2):
    return harness.run(cell, seed, seconds, False, dev, **QUIET)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(tiny_cell, host_device, name):
    out = _run(tiny_cell(name), host_device)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 4
    assert list(out)[-1] == "checks"
    for k, v in out["checks"].items():
        assert v["value"] == 0 and v["limit"] == 0, k
    assert set(out["metrics"]) == {"update_rate", "device_peak_gb",
                                   "setup_s"}
    assert out["window"]["sweeps"] >= 1


def _unchanged(p_prev, p_cur, vel2, *, steps, backend):
    return p_prev.clone(), p_cur.clone()


def _every_other(real):
    calls = []

    def fake(p_prev, p_cur, vel2, *, steps, backend):
        calls.append(1)
        if len(calls) % 2:
            return p_prev.clone(), p_cur.clone()
        return real(p_prev, p_cur, vel2, steps=steps, backend=backend)

    return fake


def _altered(real):
    def fake(p_prev, p_cur, vel2, *, steps, backend):
        pp, pc = real(p_prev, p_cur, vel2, steps=steps, backend=backend)
        pc = pc.clone()
        pc.view(-1)[pc.numel() // 2] += 1e-3
        return pp, pc

    return fake


@pytest.mark.parametrize("fault", ["state unchanged", "half the blocks",
                                   "an answer altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(tiny_cell, host_device, monkeypatch,
                                      fault, name):
    real = stencil_ops.fused_temporal_steps
    fake = {"state unchanged": _unchanged,
            "half the blocks": _every_other(real),
            "an answer altered": _altered(real)}[fault]
    monkeypatch.setattr(stencil_ops, "fused_temporal_steps", fake)
    out = _run(tiny_cell(name), host_device)
    assert not out["correct"]
    assert {"p_prev_rel_err", "p_cur_rel_err"} & set(
        k for k, v in out["checks"].items() if v["value"] > v["limit"])


def test_a_payload_altered_where_it_is_encoded_is_not_correct(
        tiny_cell, host_device, monkeypatch):
    real = zfp_ops.compress_units

    def fake(xs, *, planes, ndim=3, backend="ref"):
        out = real(xs, planes=planes, ndim=ndim, backend=backend)
        out[0].payload.view(torch.int32).view(-1)[0] ^= 1 << 30
        return out

    monkeypatch.setattr(zfp_ops, "compress_units", fake)
    out = _run(tiny_cell("wave1152-f32.code4"), host_device)
    assert not out["correct"]


def test_a_run_whose_units_skip_the_link_is_not_correct(tiny_cell,
                                                         host_device):
    # device residency keeps the units on the card: crossings the plan
    # counts never happen, so the wire falls short of the plan's
    out = _run(tiny_cell("wave1152-f32.code4", cache_bytes=1 << 30),
               host_device)
    assert out["checks"]["wire_bytes_off"]["value"] > 0
    assert not out["correct"]


def test_a_writeback_left_out_is_not_correct(tiny_cell, host_device,
                                             monkeypatch):
    real = executor_mod.AsyncExecutor._park_writebacks

    def fake(self, btasks, kr=1):
        real(self, btasks, kr)
        if self._pending and self.sweeps_done == 1:
            self.transfers.pop()  # a crossing the log never saw

    monkeypatch.setattr(executor_mod.AsyncExecutor, "_park_writebacks",
                        fake)
    out = _run(tiny_cell("wave1152-f32.code1"), host_device)
    assert out["checks"]["wire_bytes_off"]["value"] > 0
    assert not out["correct"]


def _seed_planting_in(field, fields, start=2 ** 31 + 11):
    """A seed whose planted crc32 fault lands in ``field`` (the draw of
    ``wave_ooc.crc32_fault_missed``)."""
    names = sorted(fields)
    seed = start
    while names[int(np.random.default_rng([seed, 1]).integers(
            len(names)))] != field:
        seed += 1
    return seed


# every kind of stored unit: read-write and read-only, compressed and raw
PLANTED = [("wave1152-f32.code4", "p_prev"), ("wave1152-f32.code4", "p_cur"),
           ("wave1152-f32.code4", "vel2"), ("wave1152-f32.code1", "vel2"),
           ("wave1152-f64.code4", "p_prev")]


@pytest.mark.parametrize("name,field", PLANTED)
def test_a_planted_crc32_fault_is_refused_at_its_crossing(
        tiny_cell, host_device, name, field):
    cell = tiny_cell(name)
    logs = []
    out = harness.run(cell, _seed_planting_in(field, cell.traffic["fields"]),
                      0.2, False, host_device, log=logs.append)
    assert out["checks"]["crc32_fault_missed"]["value"] == 0, logs
    assert out["correct"], out["checks"]
    assert any(f"planted in {field}." in s for s in logs), logs


@pytest.mark.parametrize("name", CELLS)
def test_a_digest_that_always_passes_is_not_correct(tiny_cell, host_device,
                                                    monkeypatch, name):
    # every digest (the store's record and what crossed) reads the same:
    # the crossings are unchecked, and the fields and wire stay right
    monkeypatch.setattr(outofcore, "unit_checksum", lambda value, ver: 0)
    out = _run(tiny_cell(name), host_device)
    assert out["checks"]["crc32_fault_missed"]["value"] == 1
    assert out["checks"]["p_cur_rel_err"]["value"] == 0
    assert out["checks"]["wire_bytes_off"]["value"] == 0
    assert not out["correct"]


@pytest.mark.parametrize("name", ["wave1152-f32.code4", "wave1152-f64.code4",
                                  "wave1152-f32.code1"])
def test_the_control_fails_the_limits(tiny_cell, name):
    cell = tiny_cell(name)
    rows = control.readings(cell, 2 ** 31 + 3, 2, device="cpu")
    limits = cell.limits["limits"]
    for _, row in rows:
        assert any(v > limits[k] for k, v in row.items()), row


def test_run_py_refuses_without_a_card_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "wave1152-f32.code4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=str(spec.ROOT))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(cuda_card, tiny_cell):
    out = harness.run(tiny_cell("wave1152-f32.code4", shape=[96, 48, 48]),
                      11, 0.5, False, card.Card(), **QUIET)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_run_py_refuses_a_checkout_without_the_program(cuda_card, tmp_path):
    # BENCHMARK.json and the benchmark's own files, nothing else
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "wave1152-f32.code4", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "program" in out.stderr

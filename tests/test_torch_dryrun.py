"""The port's dry run (``repro_torch.launch.dryrun``): each cell's step
on ``meta`` DTensors over a ``fake`` process group.

Run in processes of their own (``tests/torch_fake_group_worker.py``;
the group is process-wide), each within ``TIMEOUT`` seconds:

- every family's smoke config (dense, MoE, Mamba-1, the zamba2 hybrid
  cut to one group of its two, audio and vision-language front ends) x
  its smoke train, prefill and decode shapes on a fake (2, 2) mesh:
  ``status == "ok"``, with ``repro``'s record keys, matrix flops counted
  and collectives issued;
- ``arg_bytes_per_device`` of every arch x shape on the 16x16 and
  2x16x16 production meshes against ``repro``'s own reckoning (the
  local shard shapes of its ``shardings_for`` on an ``AbstractMesh``):
  equal, less the 4 bytes of ``repro``'s int32 cache ``length`` in a
  decode cell (the port's is a host int, no argument of the step);
- the command line on one production cell (run beside the others).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_supported as jshape_supported
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro_torch.configs import ARCH_IDS

HERE = Path(__file__).resolve().parent
TIMEOUT = 600
FAMILIES = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "zamba2-2.7b", "musicgen-medium", "qwen2-vl-7b")
# processes run side by side; zamba2 (several layers a group) alone
GROUPS = (("zamba2-2.7b",), ("qwen3-moe-235b-a22b", "falcon-mamba-7b"),
          ("qwen2-1.5b", "musicgen-medium", "qwen2-vl-7b"))
RECORD_KEYS = {"arch", "shape", "mesh", "rules", "variant", "status",
               "lower_compile_s", "memory", "collectives", "hlo_costs",
               "roofline"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _env():
    return {**os.environ, "PYTHONPATH": str(HERE.parent / "src")}


def _spawn(*args):
    return subprocess.Popen(
        [sys.executable, str(HERE / "torch_fake_group_worker.py"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())


def _result(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"a fake-group run took over {TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _command_line(out):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-1.5b", "--shape", "decode_32k", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())


@pytest.fixture(scope="module")
def smoke_cells(tmp_path_factory):
    """The smoke cells, and beside them the command line on one
    production cell (its process and output directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    cli_out = tmp_path_factory.mktemp("dryrun_cli")
    cli = _command_line(cli_out)
    procs = [_spawn("smoke_cells", str(out), *g) for g in GROUPS]
    cells = {}
    for p in procs:
        cells.update(_result(p))
    return cells, out, (cli, cli_out)


@pytest.fixture(scope="module")
def arg_bytes():
    procs = {m: _spawn("arg_bytes", m, *ARCH_IDS) for m in MESHES}
    return {m: _result(p) for m, p in procs.items()}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_runs_on_a_fake_2x2_mesh(smoke_cells, arch, kind):
    cells, out, _ = smoke_cells
    rec = cells[f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec["error"]
    assert rec["mesh"] == "2x2"
    assert rec["roofline"]["chips"] == 4
    assert rec["hlo_costs"]["dot_flops"] > 0
    assert sum(rec["collectives"].values()) > 0
    assert rec["memory"]["arg_bytes_per_device"] > 0
    path = out / f"{arch}__{kind}__2x2__baseline.json"
    assert RECORD_KEYS <= set(json.loads(path.read_text()))


def _reference_arg_bytes(arch, shape, mesh_name):
    mesh = AbstractMesh(*MESHES[mesh_name])
    shardings, specs = JST.shardings_for(jget_config(arch), JSHAPES[shape],
                                         mesh, JSH.DEFAULT_RULES)
    return sum(
        int(np.prod(sh.shard_shape(sp.shape))) * sp.dtype.itemsize
        for sh, sp in zip(jax.tree.leaves(shardings),
                          jax.tree.leaves(specs)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_arg_bytes_per_device_equal_the_references(arg_bytes, arch, mesh):
    for shape in JSHAPES:
        if not jshape_supported(arch, shape):
            continue
        want = _reference_arg_bytes(arch, shape, mesh)
        length = 4 if JSHAPES[shape].kind == "decode" else 0
        assert arg_bytes[mesh][f"{arch}/{shape}"] == want - length, shape


def test_command_line_writes_a_production_record(smoke_cells):
    cli, out_dir = smoke_cells[2]
    stdout, stderr = cli.communicate(timeout=TIMEOUT)
    assert cli.returncode == 0, stderr[-3000:]
    assert "OK " in stdout and "collective bytes/device" in stdout
    rec = json.loads((out_dir / "qwen2-1.5b__decode_32k__16x16__baseline"
                      ".json").read_text())
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert rec["roofline"]["chips"] == 256

"""The port's roofline (``repro_torch.launch.roofline``) against
``repro.launch.roofline``.

- ``Roofline``: given ``repro``'s own constants (read from
  ``repro.launch.roofline``) as a ``Hardware`` record, ``as_dict()`` is
  ``repro``'s, key for key and value for value;
- ``model_flops_for``: equal for every arch x shape;
- ``StepCounter`` on the step of ``tests/test_roofline_parser.py``'s
  synthetic HLO, on a fake (16, 16) mesh (a process of its own,
  ``tests/torch_fake_group_worker.py synthetic``): the same per-device
  dot flops and collective wire bytes as ``parse_hlo`` reads from that
  HLO;
- the counter's dot flops of each family's smoke train step (on
  ``meta``, no mesh) against ``parse_hlo`` of ``repro``'s same step
  compiled on one CPU device, within ``FLOPS_RTOL``: equal for the
  attention families; the Mamba families differ by 0.18% (falcon-mamba,
  the port's more) and 0.28% (zamba2, the port's fewer): matrix
  products of the scans' own formulations (``repro``'s XLA forms
  against the port's plain versions), so the bound is 1%.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke as jsmoke
from repro.configs.base import SMOKE_SHAPES as JSMOKE_SHAPES
from repro.launch import roofline as JRL
from repro.launch import steps as JST
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, smoke
from repro_torch.configs.base import SMOKE_SHAPES
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.models import model as TM
from repro_torch.optim import adamw

HERE = Path(__file__).resolve().parent
FLOPS_RTOL = 1e-2
BYTES_RATIO = (1.0, 2.0)
FAMILIES = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "zamba2-2.7b", "musicgen-medium", "qwen2-vl-7b")
REFERENCE_HW = RL.Hardware("repro's constants", peak_flops=JRL.PEAK_FLOPS,
                           hbm_bytes_per_s=JRL.HBM_BW,
                           link_bytes_per_s=JRL.ICI_BW)


@pytest.mark.parametrize("terms", [
    (3.1e12, 7.5e10, 2.2e9, 4.4e14, 256),  # compute-bound
    (1.0e9, 8.2e11, 1.0e8, 1.0e11, 256),  # memory-bound
    (1.0e9, 1.0e9, 4.0e11, 5.0e11, 512),  # collective-bound
    (0.0, 0.0, 0.0, 0.0, 256),  # an empty step
])
def test_roofline_as_dict_is_the_references(terms):
    flops, hbm, coll, model_flops, chips = terms
    want = JRL.Roofline(flops, hbm, coll, model_flops, chips).as_dict()
    got = RL.Roofline(flops, hbm, coll, model_flops, chips,
                      hardware=REFERENCE_HW).as_dict()
    assert got == want


def test_default_hardware_is_the_h100_data_sheet():
    roof = RL.Roofline(989.4e12, 3.35e12, 450e9, 0.0, 1)
    assert roof.hardware is RL.H100_SXM
    assert roof.compute_s == roof.memory_s == roof.collective_s == 1.0


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_equal_the_references(arch, shape):
    want = JRL.model_flops_for(jget_config(arch), JSHAPES[shape])
    assert RL.model_flops_for(get_config(arch), SHAPES[shape]) == want


def test_counter_reads_the_synthetic_step_as_parse_hlo_does():
    out = subprocess.run(
        [sys.executable, str(HERE / "torch_fake_group_worker.py"),
         "synthetic"], capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(HERE.parent / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    spec = importlib.util.spec_from_file_location(
        "roofline_parser_cases", HERE / "test_roofline_parser.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    colls, costs = JRL.parse_hlo(cases.SYNTH, default_trip=99)
    want = {c.kind: c.bytes * c.count for c in colls}
    assert got["collectives"] == want
    assert got["dot_flops"] == costs.dot_flops == 2 * 8 * 16 * 32 * 12


@functools.lru_cache(maxsize=None)
def _both_counts(arch):
    """``parse_hlo``'s costs of ``repro``'s smoke train step compiled on
    one CPU device, and ``StepCounter`` over the port's same step."""
    jcfg, shape = jsmoke(jget_config(arch)), JSMOKE_SHAPES["train"]
    params = jax.eval_shape(
        lambda: JST.M.init_params(jcfg, jax.random.PRNGKey(0)))
    opt = jax.eval_shape(
        lambda: JST.adamw.init(JST.param_specs_to_zeros(params)))
    hlo = jax.jit(JST.step_for(jcfg, shape)).lower(
        params, opt, JST.input_specs(jcfg, shape)).compile().as_text()
    _, costs = JRL.parse_hlo(hlo, default_trip=jcfg.num_layers)

    cfg = smoke(get_config(arch))
    model = TM.init_params(cfg, device="meta")
    state = adamw.init(dict(model.named_parameters()))
    batch = ST.input_specs(cfg, SMOKE_SHAPES["train"])
    counter = RL.StepCounter()
    with counter:
        ST.step_for(cfg, SMOKE_SHAPES["train"])(model, state, batch)
    return costs, counter


@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_dot_flops_match_parse_hlo_of_the_same_step(arch):
    costs, counter = _both_counts(arch)
    assert counter.dot_flops == pytest.approx(costs.dot_flops,
                                              rel=FLOPS_RTOL)
    assert counter.launches > 0 and counter.buffer_bytes > 0
    assert counter.collectives == {}  # one device: none


@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_buffer_bytes_bound_parse_hlo_of_the_same_step(arch):
    """The HBM proxy of one eager run against ``parse_hlo``'s of the
    fused program: never under it, within ``BYTES_RATIO``."""
    costs, counter = _both_counts(arch)
    ratio = counter.buffer_bytes / costs.buffer_bytes
    assert BYTES_RATIO[0] <= ratio <= BYTES_RATIO[1], ratio

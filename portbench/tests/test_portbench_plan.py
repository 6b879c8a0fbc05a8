"""The yardstick's arithmetic: the plan's units and wire bytes agree with
the program's block plan and its transfer summary, and the bytes each
kernel needs are those of PERF.md's kernels table (bounds at 3.35 TB/s)."""

import numpy as np
import pytest

from portbench import plan
from repro_torch.core.blocks import BlockPlan
from repro_torch.core.outofcore import OOCConfig, OutOfCoreWave, \
    paper_code_fields
from repro_torch.kernels.zfp import ref as zfp_ref

PAPER = (1152, 1152, 1152)


@pytest.mark.parametrize("z,ndiv,bt", [(1152, 8, 12), (96, 4, 2),
                                       (288, 2, 12), (96, 8, 1)])
def test_units_are_the_programs(z, ndiv, bt):
    ours = [(k, i, lo, hi) for k, i, lo, hi in plan.units(z, ndiv, bt)]
    theirs = [(k, i, lo, hi) for k, i, (lo, hi) in
              BlockPlan(z, ndiv, bt).units()]
    assert ours == theirs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("planes", range(1, 70))
def test_payload_words_are_the_codecs(dtype, planes):
    width = plan.WIDTH[dtype]
    assert plan.payload_words(planes, dtype) == zfp_ref.payload_words(
        3, planes, width)


@pytest.mark.parametrize("bound_ms,got", [
    # PERF.md rows 3-4: a rung at the (240, 1152, 1152) block, float32
    (1.5212177194029852, lambda: plan.rung_bytes((240,) + PAPER[1:],
                                                 "float32")),
    # row 4f: the same in float64
    (3.0424354388059704, lambda: plan.rung_bytes((240,) + PAPER[1:],
                                                 "float64")),
    # rows 1-2: the codec on a (96, 1152, 1152) unit at 12 planes
    (0.2115443391044776, lambda: plan.codec_bytes((96,) + PAPER[1:], 12,
                                                  "float32")),
    # rows 1f-2f: at 24 and 32 planes of float64
    (0.42071177552238803, lambda: plan.codec_bytes((96,) + PAPER[1:], 24,
                                                   "float64")),
    (0.4587422185074627, lambda: plan.codec_bytes((96,) + PAPER[1:], 32,
                                                  "float64")),
])
def test_kernel_bytes_match_the_kernels_table(bound_ms, got):
    assert got() == round(bound_ms * 1e-3 * plan.PEAK_HBM_BYTES_PER_S)


def test_a_rung_launch_moves_four_blocks():
    assert plan.rung_bytes((240, 1152, 1152), "float32") == 5_096_079_360
    n, b = plan.sweep_rungs(PAPER, 8, 12, "float32")
    assert (n, b) == (96, 96 * 5_096_079_360)


def test_the_codec_bytes_of_a_sweep():
    fields = {"p_prev": {"role": "rw", "planes": 12},
              "p_cur": {"role": "rw", "planes": None},
              "vel2": {"role": "ro", "planes": 12}}
    got = plan.sweep_codec(PAPER, 8, 12, fields, "float32")
    units = plan.units(1152, 8, 12)
    one = sum(plan.codec_bytes((hi - lo,) + PAPER[1:], 12, "float32")
              for _, _, lo, hi in units)
    assert got == {"decode": (30, 2 * one), "encode": (15, one)}


@pytest.mark.parametrize("code", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_expected_summary_is_a_sync_sweeps(code, dtype):
    shape, ndiv, bt = (96, 16, 16), 4, 2
    fields = paper_code_fields(code, f32=dtype == "float32")
    cfg = OOCConfig(shape, ndiv, bt, fields, backend="ref", dtype=dtype,
                    device="cpu")
    z = np.zeros(shape, dtype)
    eng = OutOfCoreWave(cfg, z, z + 1, z + 0.05)
    eng.sweep()
    want = plan.expected_summary(
        shape, ndiv, bt, {n: {"role": f.role, "planes": f.planes}
                          for n, f in fields.items()}, dtype)
    got = eng.transfer_summary()
    assert {k: got[k] for k in want} == want


def test_field_planes_take_whole_planes():
    assert plan.field_planes(0.375, "float32") == 12
    assert plan.field_planes(0.375, "float64") == 24
    assert plan.field_planes(0.5, "float64") == 32
    assert plan.field_planes(None, "float32") is None
    with pytest.raises(ValueError):
        plan.field_planes(0.3, "float32")


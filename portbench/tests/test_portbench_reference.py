"""The plain reference against the program's plain versions on the CPU:
the wave step for step and the codec's round trip bit for bit, so that a
run the reference agrees with exactly is a run the program's own
arithmetic would give."""

import pytest
import torch

from portbench import inputs
from portbench.references import acoustic25, zfp_quantize
from repro_torch.kernels.stencil import ref as stencil_ref
from repro_torch.kernels.zfp import ref as zfp_ref

PARAMS = {"width": 0.125, "jitter": 0.0625, "prev_scale": 0.97,
          "vel2": [0.03, 0.06], "layers": 4, "transition": 0.015625,
          "dip": 0.1}


def _fields(shape, dtype, seed=3):
    return {n: inputs.on_device(n, seed, shape, PARAMS, dtype, "cpu")
            for n in inputs.FIELDS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,slab", [((40, 12, 10), 7), ((24, 9, 13), 32),
                                        ((16, 8, 8), 1)])
def test_wave_steps_are_the_programs_bit_for_bit(dtype, shape, slab):
    f = _fields(shape, dtype)
    want = stencil_ref.run_steps(f["p_prev"], f["p_cur"], f["vel2"], 5)
    got = acoustic25.run(f["p_prev"].clone(), f["p_cur"].clone(), f["vel2"],
                         5, slab=slab)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,planes", [
    (torch.float32, 12), (torch.float32, 16), (torch.float32, 3),
    (torch.float32, 30), (torch.float64, 24), (torch.float64, 32),
    (torch.float64, 62)])
@pytest.mark.parametrize("shape", [(16, 12, 8), (10, 7, 5), (3, 4, 9)])
def test_codec_round_trip_is_the_programs_bit_for_bit(dtype, planes, shape):
    g = torch.Generator().manual_seed(planes)
    x = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    x[0, 0, 0] = 0.0
    want = zfp_ref.decompress(zfp_ref.compress(x, planes, 3))
    got = x.clone()
    zfp_quantize.quantize_(got, planes, chunk=4)
    assert torch.equal(got, want)


def test_quantize_in_another_type_casts_back():
    x = torch.linspace(-1, 1, 4 * 8 * 8).reshape(4, 8, 8)
    low = x.to(torch.bfloat16)
    zfp_quantize.quantize_(low, 12, torch.float32)
    want = zfp_ref.quantize(x.to(torch.bfloat16).to(torch.float32), 12, 3)
    assert torch.equal(low, want.to(torch.bfloat16))


def test_inputs_repeat_for_a_seed_and_keep_their_range():
    shape = (32, 20, 12)
    a = _fields(shape, torch.float32, seed=2 ** 31 + 11)
    b = _fields(shape, torch.float32, seed=2 ** 31 + 11)
    c = _fields(shape, torch.float32, seed=5)
    for n in inputs.FIELDS:
        assert torch.equal(a[n], b[n])
        assert not torch.equal(a[n], c[n])
    # within the float32 values nearest 0.03 and 0.06
    assert bool((a["vel2"] >= torch.tensor(0.03)).all())
    assert bool((a["vel2"] <= torch.tensor(0.06)).all())
    assert torch.equal(a["p_prev"], 0.97 * a["p_cur"])
    host = inputs.on_host("vel2", 2 ** 31 + 11, shape, PARAMS,
                          torch.float32, "cpu")
    assert torch.equal(host, a["vel2"])
    again = inputs.on_host("p_cur", 2 ** 31 + 11, shape, PARAMS,
                           torch.float32, "cpu", out=host)
    assert again is host and torch.equal(host, a["p_cur"])

"""The trace's reduction and the per-layer readers, on a made-up Chrome
trace and window: the readers' arithmetic, and that a reader with
nothing to read returns nothing."""

import pytest

from portbench import plan, spec
from portbench.drivers.wave_ooc import Engine, Window
from portbench.trace import NoDeviceRecords, parse, short, union

CALLER = {"pid": 1, "tid": 7}


def ev(cat, name, ts, dur, **where):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            **(where or {"pid": 0, "tid": 9})}


def events():
    return [
        ev("user_annotation", "portbench.window", 1000, 100_000, **CALLER),
        ev("user_annotation", "portbench.sweep", 1000, 90_000, **CALLER),
        ev("kernel", "void wave_rung_kernel<12>(float const*, int)",
           2000, 10_000),
        ev("kernel", "void wave_rung_kernel<12>(float const*, int)",
           12_000, 10_000),
        ev("kernel", "void encode_kernel<3, 1>(float const*)", 30_000, 4000),
        ev("kernel", "void decode_kernel<3>(unsigned int const*)",
           40_000, 6000),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 41_000, 20_000),
        ev("kernel", "outside", 200_000, 5000),
        ev("cuda_runtime", "cudaEventSynchronize", 70_000, 25_000,
           **CALLER),
        ev("cuda_runtime", "cudaLaunchKernel", 80_000, 1000, **CALLER),
        ev("cpu_op", "aten::copy_", 22_000, 3000, **{"pid": 1, "tid": 8}),
    ]


def test_parse_clips_to_the_window():
    t = parse(events())
    assert t.seconds == pytest.approx(0.1)
    assert [o.name for o in t.device if o.name == "outside"] == []
    assert t.busy(("kernel",)) == pytest.approx(0.030)
    assert t.busy() == pytest.approx(0.020 + 0.004 + 0.021)
    assert len(t.kernels(r"wave_rung(64)?_kernel")) == 2
    assert len(t.kernels(r"decode(64)?_kernel")) == 1


def test_breakdown_names_ops_and_gaps():
    t = parse(events())
    ops = dict(t.device_ops())
    assert ops["wave_rung_kernel"] == pytest.approx(0.020)
    assert ops["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(0.020)
    gaps = dict(t.idle_gaps())
    # 1-2 ms, 22-30, 34-40, 61-101: the caller synchronised in 70-95
    # and launched in 80-81; the other thread's copy_ is not the caller's
    assert gaps["cudaEventSynchronize"] == pytest.approx(0.024)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.001)
    assert gaps["none"] == pytest.approx(0.001 + 0.008 + 0.006 + 0.015)
    assert sum(gaps.values()) == pytest.approx(0.1 - t.busy())


def test_no_kernel_in_the_window_fails_the_run():
    with pytest.raises(NoDeviceRecords):
        parse([e for e in events() if e["cat"] != "kernel"
               or e["name"] == "outside"])


def test_short_names_and_union():
    assert short("void encode64_kernel<3, 2, 24>(double const*, "
                 "unsigned int*)") == "encode64_kernel"
    assert short("void (anonymous namespace)::decode_kernel<3, true>("
                 "unsigned int const*)") == "decode_kernel"
    assert short("(anonymous namespace)::wave_rung_kernel(float const*, "
                 "int, bool)") == "wave_rung_kernel"
    assert short("Memcpy DtoH (Device -> Pinned)") == (
        "Memcpy DtoH (Device -> Pinned)")
    assert union([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


ENG = Engine((1152, 1152, 1152), 8, 12, "float32",
             {"p_prev": {"role": "rw", "planes": 12},
              "p_cur": {"role": "rw", "planes": None},
              "vel2": {"role": "ro", "planes": 12}}, "depth2", 0)


def window(trace=None, sweeps=2):
    return Window(
        seconds=10.0, sweeps=sweeps, steps=12 * sweeps, engine=ENG,
        counters={"lanes.host_wait_s": 9.0, "lanes.crc_wait_s": 6.0,
                  "busy.h2d": 1.0},
        wire={"h2d_wire": 2 * 10_797_318_144, "d2h_wire": 2 * 8_456_306_688},
        trace=trace)


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py", name).read


def test_counter_readers():
    w = window()
    assert reader("caller_wait_share")(w) == pytest.approx(90.0)
    assert reader("crc32_wait_share")(w) == pytest.approx(60.0)
    assert reader("h2d_busy_share")(w) == pytest.approx(10.0)
    assert reader("wire_gb_per_step")(w) == pytest.approx(1.604468736)


def test_trace_readers_read_nothing_without_a_trace():
    w = window()
    for name in ("zfp_roofline", "stencil_roofline", "idle_share"):
        assert reader(name)(w) is None


def test_trace_readers():
    t = parse(events())
    w = window(t)
    rung_bytes = 2 * plan.sweep_rungs(ENG.shape, 8, 12, "float32")[1]
    assert reader("stencil_roofline")(w) == pytest.approx(
        100 * rung_bytes / plan.PEAK_HBM_BYTES_PER_S / 0.020)
    need = plan.sweep_codec(ENG.shape, 8, 12, ENG.fields, "float32")
    codec_bytes = 2 * (need["decode"][1] + need["encode"][1])
    assert reader("zfp_roofline")(w) == pytest.approx(
        100 * codec_bytes / plan.PEAK_HBM_BYTES_PER_S / 0.010)
    assert reader("idle_share")(w) == pytest.approx(70.0)


def test_a_roofline_without_its_kernel_is_silent():
    t = parse([e for e in events() if "rung" not in e["name"]
               and "encode" not in e["name"]])
    w = window(t)
    assert reader("stencil_roofline")(w) is None
    need = plan.sweep_codec(ENG.shape, 8, 12, ENG.fields, "float32")
    assert reader("zfp_roofline")(w) == pytest.approx(
        100 * 2 * need["decode"][1] / plan.PEAK_HBM_BYTES_PER_S / 0.006)

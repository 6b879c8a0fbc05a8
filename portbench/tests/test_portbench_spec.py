"""BENCHMARK.json and the files it names: every configuration, traffic
mix, limit file and metric reader loads, every cell resolves, and the
names, units and texts keep to the benchmark's characters and lengths."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE_RE = re.compile(r"^[A-Za-z0-9_./-]+$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_rule_is_broken():
    assert problems(BENCH) == []


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    eng = cell.driver().engine_of(cell)
    assert eng.shape == (1152, 1152, 1152)
    assert set(eng.fields) == {"p_prev", "p_cur", "vel2"}
    assert {m["name"] for m in cell.end_to_end} == {
        "update_rate", "device_peak_gb", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(cell.limits["limits"]) == {
        "p_prev_rel_err", "p_cur_rel_err", "wire_bytes_off",
        "crc32_fault_missed"}
    cell.reference()
    drv = cell.driver()
    for fn in ("libraries", "setup", "window", "check", "end_to_end",
               "report"):
        assert callable(getattr(drv, fn)), fn
    assert drv.libraries(cell)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert FILE_RE.match(c["file"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_texts_fit_one_line_of_200():
    texts = [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert TEXT_RE.match(t), t


def test_the_codec_metric_is_read_where_the_codec_runs():
    zfp = next(m for m in BENCH["per_layer"] if m["name"] == "zfp_roofline")
    assert zfp["workloads"] == [c for c in CELLS if c.endswith(".code4")]
    for name in CELLS:
        cell = spec.cell(name)
        coded = any(f["rate"] is not None
                    for f in cell.traffic["fields"].values())
        assert coded == (name in zfp["workloads"])


def test_every_data_file_loads():
    for d in ("configs", "traffic", "limits"):
        files = sorted((spec.HERE / d).glob("*.json"))
        assert files, d
        for path in files:
            assert FILE_RE.match(path.name)
            json.loads(path.read_text())
    for path in sorted((spec.HERE / "metrics").glob("*.py")):
        assert callable(spec.load_module(path, f"m_{path.stem}").read)


def test_a_missing_file_is_named():
    with pytest.raises(spec.SpecError):
        spec.cell("no-such-cell")


def problems(bench, root=spec.ROOT):
    """What in ``bench`` breaks the benchmark's rules of names, units
    and files (empty when nothing does)."""
    out = []
    names = {"configs": [], "workloads": [], "metrics": []}
    for c in bench["configs"]:
        names["configs"].append(c["name"])
        if not (root / c["file"]).exists():
            out.append(f"config file {c['file']} is missing")
        for key in c["reduced"]:
            if not NAME_RE.match(key):
                out.append(f"reduced key {key!r}")
    for w in bench["workloads"]:
        names["workloads"].append(w["name"])
        for key in ("name", "config", "traffic"):
            if not NAME_RE.match(w[key]):
                out.append(f"workload {key} {w[key]!r}")
        if w["config"] not in names["configs"]:
            out.append(f"workload {w['name']} names no config")
        for path in (spec.HERE / "traffic" / f"{w['traffic']}.json",
                     spec.HERE / "limits" / f"{w['name']}.json"):
            if not path.exists():
                out.append(f"{path.relative_to(root)} is missing")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} asks for {w['chips']} chips")
    for m in bench["end_to_end"] + bench["per_layer"]:
        names["metrics"].append(m["name"])
        if not NAME_RE.match(m["name"]):
            out.append(f"metric name {m['name']!r}")
        if not UNIT_RE.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better {m['better']!r} of {m['name']}")
        for w in m.get("workloads", []):
            if w not in names["workloads"]:
                out.append(f"{m['name']} lists unknown workload {w}")
    for m in bench["per_layer"]:
        if not (spec.HERE / "metrics" / f"{m['name']}.py").exists():
            out.append(f"metrics/{m['name']}.py is missing")
    for kind, seen in names.items():
        if len(seen) != len(set(seen)):
            out.append(f"duplicate {kind} names: {seen}")
    for c in bench["configs"]:
        conf = spec.load_json(root / c["file"])
        if not (spec.HERE / "references" / f"{conf['reference']}.py").exists():
            out.append(f"references/{conf['reference']}.py is missing")
    return out

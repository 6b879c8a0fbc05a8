"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (``repro``), top-level names compared whole, and the plain
reference loads nothing of the program (``repro_torch``)."""

import subprocess
import sys

from portbench import harness
from portbench.spec import HERE, ROOT

_CHILD = """
import glob, os, runpy, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for m in ({mods}):
    importlib.import_module(m)
for path in sorted(glob.glob(os.path.join({here!r}, "metrics", "*.py"))):
    runpy.run_path(path)
print(sorted(sys.modules))
"""


def _loaded(mods):
    code = _CHILD.format(root=str(ROOT), src=str(ROOT / "src"),
                         here=str(HERE), mods=", ".join(map(repr, mods)) + ",")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return {m.split(".")[0] for m in eval(out.stdout.strip().splitlines()[-1])}


def test_the_benchmark_loads_neither_jax_nor_repro():
    tops = _loaded(["portbench.harness", "portbench.spec", "portbench.trace",
                    "portbench.control", "portbench.card",
                    "portbench.references.acoustic25",
                    "portbench.drivers.wave_ooc", "repro_torch._build",
                    "repro_torch.core.executor", "repro_torch.core.outofcore"])
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(["portbench.references.acoustic25",
                    "portbench.references.zfp_quantize", "portbench.inputs",
                    "portbench.plan", "portbench.compare"])
    assert "repro_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_no_import_line_names_a_forbidden_package():
    for path in sorted(HERE.rglob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "repro"), (
                    path, line)
                if "references" in path.parts:
                    assert top != "repro_torch", (path, line)


def test_guard_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like.sub", sys)
    assert "repro_torch_like.sub" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    try:
        harness.check_imports()
    except harness.ImportGuard as exc:
        assert "jaxlib" in str(exc) and "repro.core" in str(exc)
    else:
        raise AssertionError("the guard let jaxlib and repro through")

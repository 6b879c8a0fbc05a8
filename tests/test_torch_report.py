"""The port's report (``repro_torch.launch.report``) against
``repro.launch.report``: over the same dry-run records, both tables and
the command line's output, text for text.

The records are made from a seed: every arch x shape on both production
meshes, each ``ok`` (roofline terms drawn so every dominant term and
every note of ``_note`` shows), ``error`` or missing.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest

from repro.launch import report as JREPORT
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import report as TREPORT
from repro_torch.launch import roofline as RL


def _records(out_dir, seed):
    rng = np.random.default_rng(seed)
    for mesh in ("16x16", "2x16x16"):
        for arch in ARCH_IDS:
            for shape in TREPORT.SHAPE_ORDER:
                fate = rng.choice(["ok", "ok", "ok", "error", "missing"])
                if fate == "missing":
                    continue
                rec = {"arch": arch, "shape": shape, "mesh": mesh,
                       "rules": "baseline", "variant": "", "status": fate}
                if fate == "ok":
                    terms = 10.0 ** rng.uniform(6, 15, size=3)
                    roof = RL.Roofline(*terms, model_flops=float(
                        10.0 ** rng.uniform(9, 18)), chips=256)
                    rec.update(
                        lower_compile_s=float(np.round(
                            rng.uniform(0, 90), 1)),
                        memory={"arg_bytes_per_device": int(
                            10 ** rng.uniform(3, 13))},
                        collectives={"all-gather": float(terms[2]) / 2,
                                     "all-reduce": float(terms[2]) / 2},
                        roofline=roof.as_dict())
                path = out_dir / f"{arch}__{shape}__{mesh}__baseline.json"
                path.write_text(json.dumps(rec))


@pytest.mark.parametrize("seed", range(6))
def test_both_tables_equal_the_references(tmp_path, seed):
    _records(tmp_path, seed)
    assert TREPORT.dryrun_table(str(tmp_path)) == JREPORT.dryrun_table(
        str(tmp_path))
    for mesh in ("16x16", "2x16x16"):
        assert TREPORT.roofline_table(str(tmp_path), mesh) == (
            JREPORT.roofline_table(str(tmp_path), mesh))


def test_command_line_prints_the_references_text(tmp_path, monkeypatch):
    _records(tmp_path, 7)
    text = {}
    for name, mod in (("port", TREPORT), ("reference", JREPORT)):
        monkeypatch.setattr(sys, "argv", ["report", str(tmp_path)])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        text[name] = buf.getvalue()
    assert text["port"] == text["reference"]
    assert "| ok |" in text["port"] and "**" in text["port"]

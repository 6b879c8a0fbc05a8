"""The §Dry-run and §Roofline tables from the dry-run JSON records.

Port of ``repro.launch.report``, over the port's records
(``launch.dryrun``) and ``configs``: given the same records it prints
the same two tables. The "compile" column holds a record's
``lower_compile_s``, which the port's dry run fills with the seconds of
its meta run. The port's "memory" term is the HBM proxy of one eager
run (``roofline.StepCounter``: each operator's result, nothing fused),
an upper bound that is not ``repro``'s fused count; "dominant" and
"next move" rest on it. Over the port's records (their ``hlo_costs``
count ``launches``) the command line says so under the tables.

  PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun
"""

from __future__ import annotations

import json
import pathlib
import sys
from typing import Dict, List

from repro_torch.configs import ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if x >= scale:
            return f"{x/scale:.2f}{unit}"
    return f"{x*1e9:.1f}ns"


def _fmt_b(x: float) -> str:
    for unit, scale in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6),
                        ("kB", 1e3)):
        if x >= scale:
            return f"{x/scale:.2f}{unit}"
    return f"{x:.0f}B"


def _note(rec: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    r = rec["roofline"]
    dom = r["dominant"]
    arch, shape = rec["arch"], rec["shape"]
    if dom == "collective":
        if "decode" in shape or "long" in shape:
            return ("weight-resident serve rules (no per-token FSDP "
                    "all-gather)")
        return ("reduce FSDP re-gather (zero-2 policy) / compress the "
                "pod-axis grad all-reduce")
    if dom == "memory":
        if "decode" in shape:
            return "compress the KV cache (rate 8/32, paper technique)"
        if r["useful_flops_fraction"] < 0.5:
            return ("cut replicated/gathered activation buffers via "
                    "per-arch head-sharding rules")
        return "relax remat policy (dots-only) to trade HBM for compute"
    if dom == "compute":
        if r["useful_flops_fraction"] < 0.6:
            return ("remove replicated attention compute (heads not "
                    "divisible by TP) via head-dim sharding")
        return "near roofline: only kernel-level fusion is left"
    return ""


def load(out_dir: str, mesh: str, rules: str = "baseline") -> Dict:
    recs = {}
    for p in pathlib.Path(out_dir).glob(f"*__{mesh}__{rules}.json"):
        rec = json.loads(p.read_text())
        recs[(rec["arch"], rec["shape"])] = rec
    return recs


def dryrun_table(out_dir: str) -> str:
    lines = [
        "| arch | shape | mesh | status | compile | args/dev | "
        "HLO flops/dev | collective bytes/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for mesh in ("16x16", "2x16x16"):
        recs = load(out_dir, mesh)
        for arch in ARCH_IDS:
            for shape in SHAPE_ORDER:
                if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                    if mesh == "16x16":
                        lines.append(
                            f"| {arch} | {shape} | - | SKIP "
                            f"(full attention; DESIGN §4) | | | | |"
                        )
                    continue
                rec = recs.get((arch, shape))
                if rec is None:
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | MISSING | | | | |"
                    )
                    continue
                if rec["status"] != "ok":
                    lines.append(
                        f"| {arch} | {shape} | {mesh} | FAIL | | | | |"
                    )
                    continue
                r = rec["roofline"]
                coll = sum(rec["collectives"].values())
                lines.append(
                    f"| {arch} | {shape} | {mesh} | ok | "
                    f"{rec['lower_compile_s']}s | "
                    f"{_fmt_b(rec['memory']['arg_bytes_per_device'])} | "
                    f"{r['flops_per_device']:.2e} | {_fmt_b(coll)} |"
                )
    return "\n".join(lines)


def roofline_table(out_dir: str, mesh: str = "16x16") -> str:
    recs = load(out_dir, mesh)
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful frac | roofline frac | next move |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPE_ORDER:
            rec = recs.get((arch, shape))
            if rec is None or rec["status"] != "ok":
                if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                    lines.append(
                        f"| {arch} | {shape} | - | - | - | SKIP | - | - "
                        f"| - | full-attention policy (DESIGN §4) |"
                    )
                continue
            r = rec["roofline"]
            lines.append(
                f"| {arch} | {shape} | {_fmt_s(r['compute_s'])} | "
                f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
                f"**{r['dominant']}** | {r['model_flops']:.2e} | "
                f"{min(r['useful_flops_fraction'],9.99):.2f} | "
                f"{r['roofline_fraction']:.3f} | {_note(rec)} |"
            )
    return "\n".join(lines)


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun"
    print("## Dry-run table\n")
    print(dryrun_table(out_dir))
    print("\n## Roofline table (single-pod 16x16)\n")
    print(roofline_table(out_dir))
    if _eager_counts(out_dir):
        print("\nmemory: the HBM proxy of one eager run (each operator's "
              "result, nothing fused), an upper bound on the traffic, "
              "not comparable with a fused program's count; 'dominant' "
              "and 'next move' rest on it")


def _eager_counts(out_dir: str) -> bool:
    """Whether any record holds the port's eager count."""
    return any("launches" in json.loads(p.read_text()).get("hlo_costs", {})
               for p in pathlib.Path(out_dir).glob("*.json"))


if __name__ == "__main__":
    main()

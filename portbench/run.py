#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload wave1152-f32.code4 --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines
of standard error). Exits non-zero, printing no result, without a CUDA
card (or fewer than the cell asks for), without the program
(``src/repro_torch``), or when JAX or the JAX package is loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import card, harness, spec

    try:
        cell = spec.cell(args.workload, ROOT)
    except spec.SpecError as exc:
        fail(str(exc), 2)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs only on the card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present", 3)
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the program is missing: {exc}", 4)
    try:
        out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                          card.Card(), started=STARTED)
        harness.check_imports()
    except harness.ImportGuard as exc:
        fail(str(exc), 5)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

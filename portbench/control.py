#!/usr/bin/env python3
"""The control of a cell's comparison, at the cell's own size, on the
card: the plain reference put in the program's place and computed in
the nearest precision below the configuration's (bfloat16 for float32,
float32 for float64), read by the comparison the runs use against the
reference in the configuration's own precision.

    python3 portbench/control.py --workload wave1152-f32.code4 \
        --seeds 101 102 103 --sweeps 8

Prints one JSON line a seed and sweep: the sweeps run and each field's
``<field>_rel_err``, the control computed as the reference is (the
codec's numerics in the configuration's type, ``run_ooc``), each step in
the lower type. The limits in ``limits/<cell>.json`` lie below the
smallest of these (the upper reading; see PERF.md). Not a part of the
benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LOWER = {"float32": "bfloat16", "float64": "float32"}


def readings(cell, seed: int, sweeps: int, device: str = "cuda"):
    """``[(sweeps, {"p_prev_rel_err": ..., "p_cur_rel_err": ...})]`` of
    the control against the reference, after each sweep."""
    import torch

    from portbench import compare, inputs

    drv = cell.driver()
    eng = drv.engine_of(cell)
    hi = drv.DTYPES[eng.dtype]
    lo = getattr(torch, LOWER[eng.dtype])
    params = cell.traffic["inputs"]
    ref = cell.reference()
    spans = eng.spans()
    planes = {n: f["planes"] for n, f in eng.fields.items()}
    want = {n: inputs.on_device(n, seed, eng.shape, params, hi, device)
            for n in inputs.FIELDS}
    low = {n: v.to(lo) for n, v in want.items()}
    for f in (want, low):
        for name, t in f.items():
            ref.store_(t, spans, planes[name], hi)
    out = []
    pp, pc = want["p_prev"], want["p_cur"]
    qp, qc = low["p_prev"], low["p_cur"]
    for n in range(1, sweeps + 1):
        pp, pc = ref.sweep(pp, pc, want["vel2"], eng.bt, spans, planes)
        qp, qc = ref.sweep(qp, qc, low["vel2"], eng.bt, spans, planes, hi)
        row = {f"{name}_rel_err": compare.rel_err(g, w)
               for name, w, g in (("p_prev", pp, qp), ("p_cur", pc, qc))}
        out.append((n, row))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sweeps", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        sys.exit("control: no CUDA device")
    cell = spec.cell(args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for n, row in readings(cell, seed, args.sweeps):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "sweeps": n, "control": row}), flush=True)
        print(json.dumps({"seed": seed,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()

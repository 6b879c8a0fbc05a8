#!/usr/bin/env python3
"""Device time a launch of the codec, stencil and selective-scan kernels
at every shape the port's main paths launch them, for the tree at
``--root``.

    python3 tools/kernel_shapes.py [--root DIR] [--label NAME]

Needs one CUDA device and ``nvcc``; builds the kernels of that tree's
``src/repro_torch`` at first use. Prints the card line (``nvidia-smi``
name and power limit), then one JSON line per (kernel, shape): the
device time a launch from ``torch.profiler`` (the kernel alone), the
CUDA-event time of the Python call, the launches of that shape on the
paths ``chip_smoke.py`` drives and, for the codec and stencil, the byte
bound (each input read once, each output written once, at 3.35 TB/s):

* the out-of-core wave (phases 4-5): code 4 compresses p_prev and vel2
  at 12 planes; at 1152^3, ndiv 8, bt 12 the plan has 9 units of 96
  planes and 6 of 48, at (96, 1152, 1152), bt 1, 9 of 8 and 6 of 4.
  Encode: every compressed unit once when the engine is seeded, p_prev's
  units again after each sweep (one sweep at 1152^3, two at bt 1).
  Decode: both fields' units each sweep, and p_prev's once more when the
  1152^3 run is gathered. 105 launches each, as the smoke counts.
  The single step: the bt 1 engine's blocks, B + 2H = 12 + 8 planes of
  (96, 1152, 1152) at ndiv 8, padded to (28, 1160, 1160), 8 a sweep
  over two sweeps: 16 launches; and the (240, 1152, 1152) block that
  phase 3 checks (not launched on a path). The multistep rung at the
  bt 12 block, (240, 1152, 1152): 16 calls of 12 rungs, 192 launches;
* the Qwen2-1.5B serving slice (phase 7): the chunk-flush encode of a
  (8 slots, 2 KV heads, 64 tokens, 128) window at 16 planes, 2-D blocks,
  every 64 tokens on each of 28 layers' K and V: 224 launches;
* the falcon-mamba-7b slice (phase 9): the scan at (8, 1, 8192, 16) on
  64 layers of 159 decode steps (10176) and at (8, 128, 8192, 16) on
  64 layers of one prefill (64);
* float64, the paper's own type (``chip_smoke.py``'s float64 paper
  sweep: 1152^3, ndiv 8, bt 12, code 4 at 24 planes, one sweep and a
  gather): the float64 codec on the same units, 27 and 18 launches each
  as above, and at 32 planes (codes 2 and 3; not on that path); the
  float64 rung at the (240, 1152, 1152) block, 8 blocks of 12 rungs (96
  launches), and the float64 single step there (not on that path);
  the precision tier's (phase 5p) stencil shapes: the engine's rung on
  its (192, 96, 96) blocks, 2 a sweep of 12 rungs over 360 sweeps of 4
  float64 curves (34560), and the in-core run's single step on (192, 96,
  96) padded, 4,320 a curve (17280).
  Skipped, with a line saying so, on a tree without the float64 kernels.

Run it on two trees in one call to compare them on one card, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

PAPER_UNITS = ((96, 27), (48, 18), (8, 36), (4, 24))  # (depth, launches)
CODEC = [("zfp_decode", (z, 1152, 1152), 12, 3, n) for z, n in PAPER_UNITS]
CODEC += [("zfp_encode", (z, 1152, 1152), 12, 3, n) for z, n in PAPER_UNITS]
CODEC += [("zfp_encode", (8, 2, 64, 128), 16, 2, 224)]
# (kernel, interior shape, launches): the single step on padded fields,
# the multistep rung on interior ones
STENCIL = [("wave_step", (20, 1152, 1152), 16),
           ("wave_step", (240, 1152, 1152), 0),
           ("wave_rung", (240, 1152, 1152), 192)]
SCAN = [((8, 1, 8192, 16), 10176), ((8, 128, 8192, 16), 64)]
CODEC64 = [(k, (z, 1152, 1152), 24, 3, n) for k in ("zfp_decode", "zfp_encode")
           for z, n in PAPER_UNITS[:2]]
CODEC64 += [(k, (96, 1152, 1152), 32, 3, 0)
            for k in ("zfp_decode", "zfp_encode")]
STENCIL64 = [("wave_step", (240, 1152, 1152), 0),
             ("wave_rung", (240, 1152, 1152), 96),
             ("wave_step", (192, 96, 96), 17280),
             ("wave_rung", (192, 96, 96), 34560)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def device_ms(torch, fn, name: str, reps: int) -> float:
    """Device time of one launch of the kernels whose name holds
    ``name``, from ``torch.profiler`` over ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window may come back without device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if name in e.key]
        if found:
            total = sum(e.self_device_time_total for e in found)
            return total / 1e3 / sum(e.count for e in found)
    raise RuntimeError(f"the profiler saw no {name} launch")


def event_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of one call of ``fn``."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = Path(__file__).resolve().parents[1]
    ap.add_argument("--root", default=str(here), help="checkout to time")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))

    import torch

    from repro_torch import _build
    from repro_torch import device as device_mod
    from repro_torch.kernels.sscan import kernel as sscan_kernel
    from repro_torch.kernels.stencil import kernel as stencil_kernel
    from repro_torch.kernels.zfp import kernel as zfp_kernel

    if not torch.cuda.is_available():
        print("kernel_shapes: no CUDA device", file=sys.stderr)
        return 2
    print(device_mod.card_line(), flush=True)
    _build.build_all()

    def emit(kernel, shape, launches, fn, name, **extra):
        dev = device_ms(torch, fn, name, args.reps)
        row = {"label": args.label, "kernel": kernel, "shape": list(shape)}
        row.update(extra)
        row["launches_on_path"] = launches
        row["device_ms"] = dev
        row["event_ms"] = event_ms(torch, fn, args.reps)
        row["path_device_s"] = dev * launches / 1e3
        if "bound_ms" in extra:
            row["path_bound_s"] = extra["bound_ms"] * launches / 1e3
        print(json.dumps(row), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def normal(shape, scale=1.0, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) * scale

    def bound_ms(*tensors) -> float:
        return sum(t.numel() * t.element_size()
                   for t in tensors) / HBM_BYTES_PER_S * 1e3

    def codec(rows, dtype, suffix, tag):
        for kernel, shape, planes, ndim, launches in rows:
            x = normal(shape, 7.3, dtype)
            payload, emax = zfp_kernel.encode(x, planes, ndim)
            bound = bound_ms(x, payload, emax)
            if kernel == "zfp_encode":
                fn = lambda: zfp_kernel.encode(x, planes, ndim)
                name = f"encode{tag}_kernel"
            else:
                # (no dtype argument for float32: older trees lack it)
                kw = {} if dtype == torch.float32 else {"dtype": "float64"}
                fn = lambda: zfp_kernel.decode(payload, emax, shape, planes,
                                               ndim, **kw)
                name = f"decode{tag}_kernel"
            emit(kernel + suffix, shape, launches, fn, name, planes=planes,
                 bound_ms=bound)
            del x, payload, emax
            torch.cuda.empty_cache()

    def stencil(rows, dtype, suffix, tag):
        for kernel, shape, launches in rows:
            v2 = 0.05 + 0.01 * normal(shape, dtype=dtype)
            if kernel == "wave_step":
                padded = tuple(s + 8 for s in shape)
                pp, pc = normal(padded, dtype=dtype), normal(padded,
                                                             dtype=dtype)
                fn = lambda: stencil_kernel.wave_step(pp, pc, v2)
                outs = 2  # p_next, lap
            else:
                pp, pc = normal(shape, dtype=dtype), normal(shape, dtype=dtype)
                fn = lambda: stencil_kernel.wave_multistep(pp, pc, v2, 1)
                outs = 1  # p_next
            emit(kernel + suffix, shape, launches, fn,
                 f"{kernel}{tag}_kernel",
                 bound_ms=bound_ms(pp, pc, v2) + outs * bound_ms(v2))
            del pp, pc, v2
            torch.cuda.empty_cache()

    codec(CODEC, torch.float32, "", "")
    stencil(STENCIL, torch.float32, "", "")
    if "encode_f64" in zfp_kernel.launches:
        codec(CODEC64, torch.float64, "_f64", "64")
        stencil(STENCIL64, torch.float64, "_f64", "64")
    else:
        print(json.dumps({"label": args.label,
                          "skipped": "no float64 kernels in this tree"}),
              flush=True)
    for shape, launches in SCAN:
        bsz, s, d, n = shape
        dt = torch.nn.functional.softplus(normal((bsz, s, d)))
        a = -torch.exp(normal((d, n), 0.3))
        b_in, c_in = normal((bsz, s, n)), normal((bsz, s, n))
        x = normal((bsz, s, d))
        h0 = normal((bsz, d, n), 0.1)
        fn = lambda: sscan_kernel.selective_scan(dt, a, b_in, c_in, x, h0)
        emit("sscan", shape, launches, fn, "sscan_kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main())

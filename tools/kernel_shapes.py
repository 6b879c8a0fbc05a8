#!/usr/bin/env python3
"""Device time a launch of the codec, stencil and selective-scan kernels
at every shape the port's main paths launch them, for the tree at
``--root``.

    python3 tools/kernel_shapes.py [--root DIR] [--label NAME]
                                   [--f64-zlens N ...] [--f64-threads N ...]
                                   [--only KERNEL ...]

Needs one CUDA device and ``nvcc``; builds the kernels of that tree's
``src/repro_torch`` at first use. Prints the card line (``nvidia-smi``
name and power limit), the ``ptxas`` lines of every kernel of the tree
(registers, stack frame, spills) with its static SASS instruction count
(``cuobjdump -sass``, where the toolkit has it), then one JSON line per
(kernel, shape): the
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
* training the ssm family (phase ``train_ssm``, falcon-mamba-7b at 4
  layers, 8 x 512 tokens): the scan's forward with its checkpoints and
  its backward at (8, 512, 8192, 16), 8 and 4 launches a step, on inputs
  drawn as ``chip_smoke.py``'s ``sscan_inputs`` draws them; the
  backward's device time is that of every kernel of its call (the scan
  and the sums of its partials), its byte bound that of
  ``chip_smoke.py``'s ``sscan_bwd_bound``. Both rows call only
  ``selective_scan`` and ``selective_scan_bwd``, so a tree of the
  backward's first design times with the same script; the backward's row
  carries its residency where the tree's wrapper reports one
  (``bwd_residency``);
* float64, the paper's own type (``chip_smoke.py``'s float64 paper
  sweep: 1152^3, ndiv 8, bt 12, code 4 at 24 planes, one sweep and a
  gather): the float64 codec on the same units, encode 27 and 18
  launches (both fields seeded, p_prev after the sweep), decode 18 and 12
  (both fields in the sweep), and at 32 planes (codes 2 and 3; not on
  that path); the precision tier's (phase 5p) codec units, (48, 96, 96)
  and (96, 96, 96) at 24 planes (code 4) and 32 (codes 2 and 3): decode
  1440 and 720 launches at each rate, encode 724 and 362 (its 360 sweeps
  a curve); on a tree whose float64 codec picks its threads a CTA, each
  of its rows carries the count (``threads``), and ``--f64-threads``
  times its rows at 24 planes again with each given count forced; the
  float64 rung at the (240, 1152, 1152) block, 8 blocks of 12 rungs (96
  launches), and the float64 single step there (not on that path);
  the precision tier's (phase 5p) stencil shapes: the engine's rung on
  its (192, 96, 96) blocks, 2 a sweep of 12 rungs over 360 sweeps of 4
  float64 curves (34560), and the in-core run's single step on (192, 96,
  96) padded, 4,320 a curve (17280).
  Skipped, with a line saying so, on a tree without the float64 kernels.
  On a tree whose float64 stencil splits Z into chunks, each of its rows
  carries the chunk length the wrapper chose (``zlen``); ``--f64-zlens``
  times the precision tier's two shapes again with each given length
  forced.

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
TRAIN_SCAN = (8, 512, 8192, 16)  # phase train_ssm: 8 forwards, 4 backwards a step
# (depth, encodes, decodes): the float64 paper sweep's units at 24 planes
# and the precision tier's at each of 24 and 32
PAPER64_UNITS = ((96, 27, 18), (48, 18, 12))
PREC_UNITS = ((48, 724, 1440), (96, 362, 720))
CODEC64 = [("zfp_decode", (z, 1152, 1152), 24, 3, d)
           for z, _, d in PAPER64_UNITS]
CODEC64 += [("zfp_encode", (z, 1152, 1152), 24, 3, e)
            for z, e, _ in PAPER64_UNITS]
CODEC64 += [(k, (96, 1152, 1152), 32, 3, 0)
            for k in ("zfp_decode", "zfp_encode")]
CODEC64 += [(k, (z, 96, 96), planes, 3, d if k == "zfp_decode" else e)
            for planes in (24, 32) for k in ("zfp_decode", "zfp_encode")
            for z, e, d in PREC_UNITS]
STENCIL64 = [("wave_step", (240, 1152, 1152), 0),
             ("wave_rung", (240, 1152, 1152), 96),
             ("wave_step", (192, 96, 96), 17280),
             ("wave_rung", (192, 96, 96), 34560)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def device_ms(torch, fn, names, reps: int):
    """Device time of the kernels whose name holds one of ``names`` over
    ``reps`` calls of ``fn``, from ``torch.profiler``: (ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window may come back without device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(n in e.key for n in names)]
        if found:
            return (sum(e.self_device_time_total for e in found) / 1e3,
                    sum(e.count for e in found))
    raise RuntimeError(f"the profiler saw no launch of {names}")


def ptxas_lines(log: str):
    """Registers, stack frame and spills of each kernel in ``nvcc -Xptxas
    -v`` output."""
    import re

    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = {"entry": m.group(1)}
            out.append(entry)
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("stack_frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores")):
            m = re.search(pat, line)
            if m and entry is not None:
                entry[key] = int(m.group(1))
    return out


def sass_counts(lib: Path):
    """Static SASS instructions of each kernel in the library ``lib``
    (``cuobjdump -sass``), by mangled name; empty without ``cuobjdump``."""
    import re
    import shutil
    import subprocess

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists() or not lib.exists():
        return {}
    out = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]",
                             line):
            counts[fn] += 1
    return counts


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
    ap.add_argument("--f64-zlens", type=int, nargs="*", default=[],
                    help="chunk lengths to force on the float64 stencil at "
                         "the precision tier's shapes")
    ap.add_argument("--f64-threads", type=int, nargs="*", default=[],
                    help="threads a CTA to force on the float64 codec at "
                         "24 planes")
    ap.add_argument("--only", nargs="*", default=[],
                    help="time only the rows of these kernels (zfp, "
                         "stencil, zfp64, stencil64, sscan, sscan_train)")
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
    logs = _build.build_all()
    for name, log in logs.items():
        path = _build.BUILD_DIR / f"{name}.log"
        if not log and path.exists():
            log = path.read_text()
        entries = ptxas_lines(log)
        sass = sass_counts(_build._lib_path(name))
        for e in entries:
            if e["entry"] in sass:
                e["sass_instructions"] = sass[e["entry"]]
        print(json.dumps({"label": args.label, "source": name,
                          "ptxas": entries}), flush=True)

    def wanted(group: str) -> bool:
        return not args.only or group in args.only

    def emit(kernel, shape, launches, fn, name, **extra):
        # one kernel: its time a launch; several (one call's): a call's
        names = name if isinstance(name, tuple) else (name,)
        total, count = device_ms(torch, fn, names, args.reps)
        dev = total / (args.reps if isinstance(name, tuple) else count)
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

    def codec(rows, dtype, suffix, tag, **forced):
        for kernel, shape, planes, ndim, launches in rows:
            extra = dict(forced)
            if suffix and not forced and hasattr(zfp_kernel, "f64_threads"):
                nb = zfp_kernel._geometry(shape, ndim)[2]
                extra["threads"] = zfp_kernel.f64_threads(
                    nb, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
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
                 bound_ms=bound, **extra)
            del x, payload, emax
            torch.cuda.empty_cache()

    def stencil(rows, dtype, suffix, tag, zlen_forced=None):
        for kernel, shape, launches in rows:
            extra = {}
            if zlen_forced is not None:
                extra["zlen_forced"] = zlen_forced
            elif suffix and hasattr(stencil_kernel, "launch_zlen"):
                extra["zlen"] = stencil_kernel.launch_zlen(
                    torch.device("cuda", 0), shape, kernel == "wave_step")
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
                 bound_ms=bound_ms(pp, pc, v2) + outs * bound_ms(v2), **extra)
            del pp, pc, v2
            torch.cuda.empty_cache()

    if wanted("zfp"):
        codec(CODEC, torch.float32, "", "")
    if wanted("stencil"):
        stencil(STENCIL, torch.float32, "", "")
    f64 = wanted("zfp64") or wanted("stencil64")
    if f64 and "encode_f64" in zfp_kernel.launches:
        if wanted("zfp64"):
            codec(CODEC64, torch.float64, "_f64", "64")
        if wanted("stencil64"):
            stencil(STENCIL64, torch.float64, "_f64", "64")
        if args.f64_zlens and hasattr(stencil_kernel, "z_chunk"):
            chosen = stencil_kernel.z_chunk
            for zlen in args.f64_zlens:
                stencil_kernel.z_chunk = lambda *a, zlen=zlen: zlen
                stencil(STENCIL64[2:], torch.float64, "_f64", "64",
                        zlen_forced=zlen)
            stencil_kernel.z_chunk = chosen
        if args.f64_threads and hasattr(zfp_kernel, "f64_threads"):
            chosen = zfp_kernel.f64_threads
            for threads in args.f64_threads:
                zfp_kernel.f64_threads = lambda nb, sms, t=threads: t
                codec([r for r in CODEC64 if r[2] == 24], torch.float64,
                      "_f64", "64", threads_forced=threads)
            zfp_kernel.f64_threads = chosen
    elif f64:
        print(json.dumps({"label": args.label,
                          "skipped": "no float64 kernels in this tree"}),
              flush=True)
    def scan_inputs(shape):
        bsz, s, d, n = shape
        dt = torch.nn.functional.softplus(normal((bsz, s, d)))
        a = -torch.exp(normal((d, n), 0.3))
        b_in, c_in = normal((bsz, s, n)), normal((bsz, s, n))
        x = normal((bsz, s, d))
        return dt, a, b_in, c_in, x, normal((bsz, d, n), 0.1)

    for shape, launches in SCAN if wanted("sscan") else ():
        ins = scan_inputs(shape)
        fn = lambda: sscan_kernel.selective_scan(*ins)
        emit("sscan", shape, launches, fn, "sscan_kernel")
    if wanted("sscan_train"):
        bsz, s, d, n = shape = TRAIN_SCAN
        ins = scan_inputs(shape)
        gy = normal((bsz, s, d))
        states = torch.empty(sscan_kernel.states_shape(*shape),
                             device="cuda")
        # the forward's bytes, its checkpoints written; the backward's:
        # dt, x, gy read and dx, ddt written (B, S, D), B, C, dB, dC, A,
        # dA, dh0 and the checkpoints once
        elems = 4 * (3 * bsz * s * d + 2 * bsz * s * n + 2 * bsz * d * n
                     + d * n) + states.numel() * 4
        fwd = lambda: sscan_kernel.selective_scan(*ins, states_out=states)
        emit("sscan_states", shape, 8, fwd, "sscan_kernel",
             bound_ms=elems / HBM_BYTES_PER_S * 1e3)
        nbytes = 4 * (5 * bsz * s * d + 4 * bsz * s * n + 2 * d * n
                      + bsz * d * n) + states.numel() * 4
        extra = {}
        if hasattr(sscan_kernel, "bwd_residency"):
            extra["residency"] = sscan_kernel.bwd_residency()
        bwd = lambda: sscan_kernel.selective_scan_bwd(*ins, states, gy)
        emit("sscan_bwd", shape, 4, bwd, ("sscan_bwd_kernel",
                                          "sum_parts_kernel"),
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())

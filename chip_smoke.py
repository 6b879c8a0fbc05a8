#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without them, and when run without the rest of the checkout. Phases,
each printing one JSON line; any mismatch raises and the script exits
non-zero:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel built from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all at once);
3. kernels vs their plain PyTorch versions, on the card, at the main
   path's shapes: the codec on a 96-plane common-region unit
   (96, 1152, 1152) at 12 and 16 planes and a ragged (50, 1150, 1149)
   unit (with the codec kernels' device time a launch from
   ``torch.profiler`` and their ``ptxas`` lines: every instance of the
   encoder and of the decoder must show no spill and no stack frame),
   the single step on one fetched block (240, 1152, 1152) and at the
   shape the bt 1 engine launches it, (20, 1152, 1152) padded to
   (28, 1160, 1160), both on random padded fields (a non-zero halo),
   with its device time a launch and its ``ptxas`` line (printed), the
   multistep kernel at 12 steps on the same block (one launch a rung),
   then on the ragged unit at 12 steps and on the block at 5 steps,
   with their launches. Each must be
   bit for bit equal; median kernel and plain times (CUDA events) and
   the bound (bytes over 3.35 TB/s, or float32 operations over 67
   TFLOP/s);
3f. the float64 kernels (``csrc/zfp64.cu``, ``csrc/stencil64.cu``)
   against their plain versions: the codec at the paper's rates 24 and
   32 planes, ndim 1-3, on the unit and on the ragged unit, bit for bit,
   with its device time a launch at the unit (ndim 3); the single step on
   the block and on the precision tier's in-core shape (random halos),
   the rung at 12 steps on the block and at 5 on the ragged unit, bit
   for bit; their ``ptxas`` lines; bounds in bytes or float64 operations
   over 34 TFLOP/s;
4. the slice at the paper's size: 1152^3, ndiv=8, bt=12, one sweep for
   code 4 and for code 1 through ``OutOfCoreWave``; code 1 bit for bit
   equal to the in-core ``fused_temporal_steps(backend="cuda")``, code 4
   within 5e-2 relative error of it; transfer summary against the
   ``BlockPlan`` arithmetic; wall time split into device compute
   (CUDA events around the codec and stencil calls), crc32 and the rest.
   Code 4 then sweeps once more (the live engine's reference);
5. the single-step dispatch through the engine: bt=1 on a Z-reduced
   volume (96, 1152, 1152), code 4, bit for bit against the same engine
   with ``backend="ref"`` on the card;
5b. the live engine, ``AsyncExecutor`` on its H2D, compute and D2H
   streams with pinned staging, schedule depth2, the launch counts
   zeroed first: codes 4 and 1 at 1152^3, ndiv 8, bt 12, two sweeps
   each with the window open across the boundary; code 1 bit for bit
   the in-core run of 24 steps, code 4 bit for bit the synchronous
   engine's two sweeps and within 5e-2 of the in-core run; transfers
   equal to the task graph's (``build_sweep_tasks``) and the summary to
   the plan arithmetic twice. Then write-back residency on the bt 1
   volume of phase 5 with 90% of its working set's bytes: the
   transfer records and residency counters those of the task graph at
   the same budget, wave_step launched once a block a sweep, the fields
   those of phase 5's bt 1 sync engine bit for bit. Each run prints its
   sweep walls, each stream's busy time, crc32 seconds on the host
   threads, on the caller's thread and left on the caller's critical
   path, the window's peak, the pinned bytes and the idle share, beside
   the sync engine's rows;
5f. the paper's float64 cell: 1152^3, ndiv 8, bt 12, code 4 at 24/64
   through ``OutOfCoreWave`` (the host bytes reckoned and printed
   first; Z cut, units kept, only if they do not fit), one sweep: wire
   bytes the plan's, p_cur within 5e-2 relative of the in-core run of 12
   steps, computed on the card in z-slabs, each block with its 48 halo
   planes (a whole-volume float64 run does not fit the card);
5bf. ``AsyncExecutor`` in float64, (288, 576, 576), ndiv 2, bt 12, code
   4 at 24/64, two sweeps: bit for bit the sync engine, transfers the
   task graph's and the plan's;
5p. the precision tier to 4,320 steps (the paper's Fig. 7):
   ``error_curve`` for codes 1-4 in float64 at the paper's rates and
   codes 2 and 4 in float32 at 16/12, on (192, 96, 96), ndiv 2, bt 12,
   360 sweeps sampled every 30: code 1 exactly 0, float64 codes 2-4
   under ``assert_bounded_growth`` with the long tier's ceilings;
6. the fused ZFP-decode attention kernel against its plain version at
   the repo's ``decode_32k`` context (32768 tokens): 16 slots, 2 KV
   heads, 6 queries per KV head, head_dim 128, at 16 and 12 planes and
   lengths 30000, 32704 (chunk-aligned) and 40 (no history); ``m``,
   ``l`` and ``acc`` within rtol = atol = 2e-5; median kernel and plain
   times and the bound (payload, emax, queries and partials over
   3.35 TB/s). No single PyTorch call computes this function. Then the
   kernel and the plain version against a float64 evaluation of the
   same decoded tiles (three seeds, 16 and 12 planes, length 30000):
   which side carries the error, and the kernel within 2e-5 of it;
7. the serving slice at full width: Qwen2-1.5B in bfloat16, depth cut
   to 14 of its 28 layers, with the compressed KV cache at 16 planes, random weights from a seeded
   generator on the card, 8 requests in 8 slots in lockstep (256-token
   prompts, 64 new tokens, greedy) through ``ServeEngine``; wall time,
   tokens/s, cache bytes and the launches of the encode and cdecode
   kernels. The same token streams are then replayed, teacher-forced,
   through an engine with the plain versions (``backend="ref"``) on the
   card, whose logits must agree within 5e-2 of their largest, and
   through a raw-cache engine (printed, not checked). On the cuda
   engine's own cache after its run, cdecode is held to its plain
   version (within 2e-5) on every layer's history with that layer's
   last query, and the chunk-flush encode of every layer's tail to the
   plain codec (bit for bit), with that encode's time and bound at the
   flush shape; the cdecode kernel's own decoded K and V
   tiles of the first chunk against the plain codec's decode (bit for
   bit); the cache's split (``nsplit_per``, CTAs) and the kernel's
   device time per launch (``torch.profiler``) beside its CUDA-event
   time, which includes the host's wrapper. Last, the device time by
   kernel over 64 steady steps from ``torch.profiler``, against the
   wall time of the same 64 steps without it;
8. the Mamba-1 selective-scan kernel against its plain version at the
   falcon-mamba-7b shapes (8 slots, d_inner 8192, N 16): decode
   (S = 1), the slice's prefill (S = 128), prefill at length (S = 4096)
   and a ragged S = 100, each from a non-zero ``h0`` and writing
   ``h_last`` in place over it; ``y`` and ``h_last`` within rtol 1e-4 /
   atol 1e-5; median kernel and plain times, the kernel's device time a
   launch (profiler), its ``ptxas`` line, and the bound (bytes, float32
   operations, and exponentials at the SFU rate). No single PyTorch call
   computes this function. Then the kernel and the plain version against
   a float64 recurrence over every 16th channel at S = 128 and 4096:
   which side carries the error, and the kernel within the tolerance of
   float64;
9. the SSM slice at full width: falcon-mamba-7b in bfloat16, random
   weights from a seeded generator on the card, 8 requests in 8 slots
   (128-token prompts, 32 new tokens, greedy) through ``ServeEngine``;
   wall time, tokens/s, max |logits| and the sscan launches (64 a step).
   Then ``prefill`` (``backend="cuda"``) on the same prompts, with every
   layer's scan held to its plain version on the inputs the prefill gave
   it (rtol 1e-4 / atol 1e-5), and against the decode-fed engine's
   states after the prompt (printed). In bfloat16 the streams are
   replayed, teacher-forced, through the plain versions
   (``backend="ref"``) on the card, and the prefill likewise (printed:
   over 64 random bf16 layers the two drift apart by bf16 rounding as
   far as the prefill and the decode-fed engine do); the device time by
   kernel over 32 decode steps from ``torch.profiler``. Last, the same
   weights in float32: the replay and the prefill through the kernel
   against the plain versions, logits within 5e-2 of their largest,
   every layer's ``h`` within the kernel's tolerance;
10. the kernels line: every kernel with its launches on the main paths
   (the out-of-core wave of phases 4 and 5, the live engine of phase
   5b, the float64 paper sweep, live run and precision tier of phases
   5f, 5bf and 5p, the serving slice of phase 7 and the SSM slice of
   phase 9, each counted from zero), its error and times.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import outofcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core.executor import AsyncExecutor  # noqa: E402
from repro_torch.core.outofcore import (  # noqa: E402
    OOCConfig, OutOfCoreWave, paper_code_fields, to_host,
)
from repro_torch.core.taskgraph import (  # noqa: E402
    build_sweep_tasks, unit_wire_bytes, wire_totals,
)
from repro_torch.kernels.cdecode import kernel as cdecode_kernel  # noqa: E402
from repro_torch.kernels.cdecode import ops as cdecode_ops  # noqa: E402
from repro_torch.kernels.cdecode import ref as cdecode_ref  # noqa: E402
from repro_torch.kernels.sscan import kernel as sscan_kernel  # noqa: E402
from repro_torch.kernels.sscan import ops as sscan_ops  # noqa: E402
from repro_torch.kernels.sscan import ref as sscan_ref  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models.layers import scale_in  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.kernels.stencil import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil import ops as stencil_ops  # noqa: E402
from repro_torch.kernels.stencil import ref as stencil_ref  # noqa: E402
from repro_torch.kernels.zfp import kernel as zfp_kernel  # noqa: E402
from repro_torch.kernels.zfp import ops as zfp_ops  # noqa: E402
from repro_torch.kernels.zfp import ref as zfp_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SFU_PER_CLOCK_SM = 16  # exponentials a clock an SM (sm_90 SFU)
STENCIL_FLOPS = 33  # floating-point operations per point per step
FP64_FLOP_PER_S = 34e12  # H100 SXM data sheet, float64 outside tensor cores
F64 = torch.float64
SEED = 0
PAPER = (1152, 1152, 1152)
NDIV, BT = 8, 12
UNIT = (96, 1152, 1152)  # a common region C_i at the paper's size
RAGGED = (50, 1150, 1149)
BLOCK = (240, 1152, 1152)  # one fetched block, B + 2H planes
# the bt 1 engine's block: B + 2H = 12 + 8 planes of SMALL_Z at ndiv 8
STEP_PATH = (20, 1152, 1152)
SMALL_Z = 96  # phase 5's volume depth (bt=1)
# phase 5b: the live engine
LIVE_SCHEDULE, LIVE_SWEEPS = "depth2", 2
# phase 6: the fused attention kernel at the decode_32k context
CTX = SHAPES["decode_32k"].seq_len
CD_SLOTS, CD_KVH, CD_QPK, CD_D = 16, 2, 6, 128
CD_LENGTHS = (30000, CTX - kvcache.CHUNK, 40)
CD_TOL = 2e-5  # tests/test_cdecode_kernel.py's own bound
# phase 7: the serving slice
SERVE_ARCH, SERVE_PLANES = "qwen2-1.5b", 16
# depth cut to 14 of Qwen2-1.5B's 28 layers (full width) since the float64
# phases joined: the smoke keeps within its time limit on a slow host
SERVE_LAYERS = 14
SERVE_SLOTS, PROMPT, MAX_NEW, SERVE_MAX_LEN = 8, 256, 64, 1024
SERVE_TOL = 5e-2  # tests/test_kvcache.py's bound against the raw cache
# phases 8-9: the SSM slice
SSM_ARCH = "falcon-mamba-7b"
SSM_SLOTS, SSM_PROMPT, SSM_NEW = 8, 128, 32
SSM_MAX_LEN = SSM_PROMPT + SSM_NEW
SSCAN_SHAPES = ((8, 1, 8192, 16), (8, 128, 8192, 16), (8, 4096, 8192, 16),
                (8, 100, 8192, 16))  # (B, S, D, N)
SSCAN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_sscan_kernel.py's bound
SSCAN_CHUNK = 64  # the plain version's chunk (the configs' ssm_chunk)
SSCAN_WITNESS = ((8, 128, 8192, 16), (8, 4096, 8192, 16))
SSCAN_WITNESS_STRIDE = 16  # the float64 recurrence's channels: 512 of 8192
SSM_WINDOW = (16, 32)  # profiled decode steps: warm-up, then the window
# the float64 phases: the paper's own type and rates (32/64, 24/64)
F64_PLANES = (24, 32)
F64_RAGGED = (50, 1150, 1149)
F64_LIVE = (288, 576, 576)  # live vs sync: ndiv 2, bt 12, block 144
# the precision tier to 4,320 steps (Fig. 7): 360 sweeps of bt 12; block
# 96 = 2 x the 48-plane halo and y a multiple of 48, so the engine runs
# the multistep kernel
PREC_SHAPE, PREC_NDIV, PREC_SWEEPS, PREC_EVERY = (192, 96, 96), 2, 360, 30
# tests/test_precision_loss.py's REL_TOL_SLOW; code 3 (vel2 at the 2:1
# rate of code 2) is held to code 2's
PREC_TOL = {2: 0.030, 3: 0.030, 4: 0.350}


class SmokeFailure(AssertionError):
    """A phase found a mismatch."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
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


def kernel_device_ms(fn, name: str, reps: int):
    """Device time of one launch of the kernels whose name holds
    ``name``: from ``torch.profiler`` (CUPTI) over ``reps`` calls of
    ``fn``, the kernel alone without the host's wrapper around it
    (``device_ms_by`` "profiler"). The profiler has come back without the
    kernel's records in three windows running; then the time is CUDA
    events around ``reps`` back-to-back calls, over ``reps``
    ("events_batch": the device time where a launch outlasts the host's
    call, the host's where it does not), with the keys the profiler saw.
    Returns a dict for the caller's record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        found = [e for e in events if name in e.key]
        if found:
            return {"device_ms": sum(e.self_device_time_total for e in found)
                    / 1e3 / sum(e.count for e in found),
                    "device_ms_by": "profiler"}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / reps,
            "device_ms_by": "events_batch",
            "profiler_keys": [e.key[:60] for e in events][:8]}


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``csrc/<name>.cu``
    (when this run found the library built already)."""
    path = _build.BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def ptxas_summary(log: str):
    """Registers, static shared memory, stack frame and spills of each
    kernel from ``nvcc -Xptxas -v`` output (dynamic shared memory is not
    in it)."""
    import re

    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = {"entry": m.group(1)}
            out.append(entry)
        elif entry is not None:
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                entry["stack_frame"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entry["spill_stores"] = int(m.group(1))
                entry["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                entry["static_smem"] = int(m.group(1)) if m else 0
    return out


def bound_ms(nbytes: float, flops: float = 0.0, exps: float = 0.0,
             flop_rate: float = FP32_FLOP_PER_S):
    """The least time for the work: bytes over the memory rate,
    floating-point operations over ``flop_rate`` (float32's unless
    given) and exponentials over the SFU rate, whichever is largest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flop_rate, exps / sfu_per_s() if exps else 0.0)
    t_ops *= 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def sfu_per_s() -> float:
    """Exponentials a second: 16 a clock an SM (the SFU rate of sm_90)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_SM * sms * sm_clock_hz()


def kernel_ptxas(source: str, entry: str):
    """The ptxas lines of the kernels of ``csrc/<source>.cu`` whose
    mangled name holds ``entry``."""
    return [e for e in ptxas_summary(build_log(source)) if entry in e["entry"]]


def path_counts():
    """The codec and stencil launch counts, by counter name."""
    return {**{f"zfp_{k}": v for k, v in zfp_kernel.launches.items()},
            **stencil_kernel.launches}


def reset_counts():
    zfp_kernel.reset_launches()
    stencil_kernel.reset_launches()


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit equal (any 4- or 8-byte type, through int32 views)."""
    return a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; equal entries count 0 (so -inf against -inf)."""
    if a.dtype in (torch.uint32, torch.int32):
        a, b = bits(a).to(torch.int64), bits(b).to(torch.int64)
    d = torch.where(a == b, 0, (a - b).abs())
    return float(d.max()) if a.numel() else 0.0


def normal(shape, gen, scale=7.3, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=dtype) * scale


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------


def codec_case(shape, planes, gen, results):
    x = normal(shape, gen)
    payload, emax = zfp_kernel.encode(x, planes)
    xb = zfp_ref.blockify(x, 3)
    rp, re = zfp_ref.encode_blocks(xb, planes, 3)
    enc_ok = same_bits(payload, rp) and same_bits(emax, re)
    y = zfp_kernel.decode(payload, emax, shape, planes)
    ry = zfp_ref.unblockify(zfp_ref.decode_blocks(rp, re, planes, 3), shape, 3)
    dec_ok = same_bits(y, ry)
    nb = emax.numel()
    in_bytes = x.numel() * 4
    out_bytes = payload.numel() * 4 + nb * 4
    enc_fn = lambda: zfp_kernel.encode(x, planes)
    dec_fn = lambda: zfp_kernel.decode(payload, emax, shape, planes)
    enc = {
        "max_abs_err": max(max_abs(payload, rp), max_abs(emax, re)),
        "ms": median_ms(enc_fn, 10),
        **kernel_device_ms(enc_fn, "encode_kernel", 10),
        "plain_ms": median_ms(
            lambda: zfp_ref.encode_blocks(zfp_ref.blockify(x, 3), planes, 3), 3),
        "bound": bound_ms(in_bytes + out_bytes),
    }
    dec = {
        "max_abs_err": max_abs(y, ry),
        "ms": median_ms(dec_fn, 10),
        **kernel_device_ms(dec_fn, "decode_kernel", 10),
        "plain_ms": median_ms(lambda: zfp_ref.unblockify(
            zfp_ref.decode_blocks(payload, emax, planes, 3), shape, 3), 3),
        "bound": bound_ms(in_bytes + out_bytes),
    }
    # both kernels keep their block in registers: no spill, no stack frame
    enc_ptxas = kernel_ptxas("zfp", "encode_kernel")
    dec_ptxas = kernel_ptxas("zfp", "decode_kernel")
    for name, r, ok, ptxas in (("zfp_encode", enc, enc_ok, enc_ptxas),
                               ("zfp_decode", dec, dec_ok, dec_ptxas)):
        emit({"phase": "kernel_vs_plain", "kernel": name,
              "shape": list(shape), "planes": planes,
              "stream_order": zfp_kernel.stream_order(planes, 3),
              "bitwise": ok, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
              "device_ms": r["device_ms"], "device_ms_by": r["device_ms_by"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1], "ptxas": ptxas})
        check(ok, f"{name} differs from its plain version at {shape}, "
                  f"{planes} planes")
        results.setdefault((name, shape, planes), r)
    for name, ptxas in (("encode_kernel", enc_ptxas),
                        ("decode_kernel", dec_ptxas)):
        # ndim 3 and 2 in both stream orders, ndim 1 in one
        check(len(ptxas) == 5 and all(
            e.get("spill_stores", 0) == 0 and e.get("stack_frame", 0) == 0
            for e in ptxas), f"zfp {name} spills or keeps a stack frame: "
                             f"{ptxas}")


def wave_step_case(shape, gen, results):
    """The single step on random padded fields (halo included) of the
    interior ``shape``: bit for bit ``ref.wave_step``, with its times and
    bound (both padded inputs, vel2 and both outputs once)."""
    n = math.prod(shape)
    pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
    pp, pc = normal(pad, gen, 1.0), normal(pad, gen, 1.0)
    v2 = 0.05 + 0.01 * normal(shape, gen, 1.0)
    kn, kl = stencil_kernel.wave_step(pp, pc, v2)
    rn, rl = stencil_ref.wave_step(pp, pc, v2)
    ok = same_bits(kn, rn) and same_bits(kl, rl)
    fn = lambda: stencil_kernel.wave_step(pp, pc, v2)
    r = {
        "max_abs_err": max(max_abs(kn, rn), max_abs(kl, rl)),
        "ms": median_ms(fn, 10),
        **kernel_device_ms(fn, "wave_step_kernel", 10),
        "plain_ms": median_ms(lambda: stencil_ref.wave_step(pp, pc, v2), 3),
        "bound": bound_ms(2 * pp.numel() * 4 + 3 * n * 4, STENCIL_FLOPS * n),
    }
    results[("wave_step", shape, 1)] = r
    emit({"phase": "kernel_vs_plain", "kernel": "wave_step",
          "shape": list(shape), "padded": list(pad), "bitwise": ok,
          "max_abs_err": r["max_abs_err"], "ms": r["ms"],
          "device_ms": r["device_ms"], "device_ms_by": r["device_ms_by"],
          "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
          "bound_by": r["bound"][1],
          "ptxas": kernel_ptxas("stencil", "wave_step_kernel")})
    check(ok, f"wave_step differs from its plain version at {shape}")
    del pp, pc, v2, kn, kl, rn, rl
    torch.cuda.empty_cache()


def stencil_cases(gen, results):
    for shape in (BLOCK, STEP_PATH):
        wave_step_case(shape, gen, results)
    z, y, x = BLOCK
    n = z * y * x
    v2 = 0.05 + 0.01 * normal(BLOCK, gen, 1.0)
    steps = BT
    pp, pc = normal(BLOCK, gen, 1.0), normal(BLOCK, gen, 1.0)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, steps)
    ok, err, launched = multistep_check(pp, pc, v2, rp, rc, steps)
    r = {
        "max_abs_err": err,
        "ms": median_ms(lambda: stencil_kernel.wave_multistep(
            pp, pc, v2, steps), 5),
        "plain_ms": median_ms(
            lambda: stencil_ref.ladder_steps(pp, pc, v2, steps), 3),
        "bound": bound_ms(5 * n * 4, STENCIL_FLOPS * n * steps),
        "launches_per_call": launched,
    }
    results[("wave_multistep", BLOCK, steps)] = r
    emit({"phase": "kernel_vs_plain", "kernel": "wave_multistep",
          "shape": list(BLOCK), "steps": steps, "launches_per_call": launched,
          "bitwise": ok, "max_abs_err": err, "ms": r["ms"],
          "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
          "bound_by": r["bound"][1],
          # what one launch must move: p_prev, p_cur, vel2 in, p_next out
          "bound_ms_a_launch": bound_ms(4 * n * 4, STENCIL_FLOPS * n)[0]})
    del pp, pc, rp, rc, v2
    torch.cuda.empty_cache()
    multistep_ragged(gen)


def multistep_check(pp, pc, v2, rp, rc, steps):
    """The multistep kernel over ``steps`` steps against the ladder's
    (rp, rc): (bit for bit, max |d|, launches); raises on a mismatch or
    a launch count other than one a step."""
    stencil_kernel.reset_launches()
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, steps)
    launched = stencil_kernel.launches["wave_multistep"]
    ok = same_bits(kp, rp) and same_bits(kc, rc)
    err = max(max_abs(kp, rp), max_abs(kc, rc))
    check(ok, f"wave_multistep differs from its plain version at "
              f"{tuple(pp.shape)}, {steps} steps")
    check(launched == steps, f"{launched} multistep launches for {steps} "
                             f"steps")
    return ok, err, launched


def multistep_ragged(gen):
    """The multistep kernel on a ragged unit (tiles cut in y and x) at
    12 steps and on the block at 5 steps: bit for bit the ladder."""
    out = []
    for shape, steps in ((RAGGED, BT), (BLOCK, 5)):
        pp, pc = normal(shape, gen, 1.0), normal(shape, gen, 1.0)
        v2 = 0.05 + 0.01 * normal(shape, gen, 1.0)
        rp, rc = stencil_ref.ladder_steps(pp, pc, v2, steps)
        ok, err, launched = multistep_check(pp, pc, v2, rp, rc, steps)
        out.append({"shape": list(shape), "steps": steps,
                    "launches": launched, "bitwise": ok, "max_abs_err": err})
        del pp, pc, v2, rp, rc
        torch.cuda.empty_cache()
    emit({"phase": "multistep_ragged", "cases": out})


# ----------------------------------------------------------------------
# phase 3f: the float64 kernels against their plain versions
# ----------------------------------------------------------------------


def codec64_case(shape, gen, results):
    """The float64 codec at the paper's rates and ndim 1-3 on ``shape``
    (ndim 2 and 1 take the leading axes as batch): encode and decode bit
    for bit the plain version. At ndim 3 (the engine's) also the times
    and the bound: the unit in, payload and emax out."""
    x = normal(shape, gen, 7.3, F64)
    for planes in F64_PLANES:
        for ndim in (3, 2, 1):
            payload, emax = zfp_kernel.encode(x, planes, ndim)
            rp, re = zfp_ref.encode_blocks(zfp_ref.blockify(x, ndim), planes,
                                           ndim)
            enc_ok = same_bits(payload, rp) and same_bits(emax, re)
            y = zfp_kernel.decode(payload, emax, shape, planes, ndim,
                                  "float64")
            ry = zfp_ref.unblockify(zfp_ref.decode_blocks(
                rp, re, planes, ndim, "float64"), shape, ndim)
            dec_ok = same_bits(y, ry)
            errs = {"zfp_encode_f64": max(max_abs(payload, rp),
                                          max_abs(emax, re)),
                    "zfp_decode_f64": max_abs(y, ry)}
            del rp, re, ry
            row = {"phase": "kernel_vs_plain_f64", "shape": list(shape),
                   "planes": planes, "ndim": ndim,
                   "stream_order": zfp_kernel.stream_order(planes, ndim, 64),
                   "encode_bitwise": enc_ok, "decode_bitwise": dec_ok}
            if ndim == 3 and shape == UNIT:
                nbytes = (x.numel() * 8 + payload.numel() * 4
                          + emax.numel() * 4)
                enc_fn = lambda: zfp_kernel.encode(x, planes)
                dec_fn = lambda: zfp_kernel.decode(payload, emax, shape,
                                                   planes, 3, "float64")
                for name, fn, key, plain in (
                        ("zfp_encode_f64", enc_fn, "encode64_kernel",
                         lambda: zfp_ref.encode_blocks(
                             zfp_ref.blockify(x, 3), planes, 3)),
                        ("zfp_decode_f64", dec_fn, "decode64_kernel",
                         lambda: zfp_ref.unblockify(zfp_ref.decode_blocks(
                             payload, emax, planes, 3, "float64"), shape,
                             3))):
                    r = {"max_abs_err": errs[name], "ms": median_ms(fn, 10),
                         **kernel_device_ms(fn, key, 10),
                         "plain_ms": median_ms(plain, 3),
                         "bound": bound_ms(nbytes)}
                    results[(name, shape, planes)] = r
                    row[name] = {k: v for k, v in r.items() if k != "bound"}
                    row[name].update(bound_ms=r["bound"][0],
                                     bound_by=r["bound"][1])
            emit(row)
            check(enc_ok and dec_ok, f"float64 codec differs from its plain "
                                     f"version at {shape}, {planes} planes, "
                                     f"ndim {ndim}")
            del payload, emax, y
            torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()


def stencil64_cases(gen, results):
    """The float64 single step on random padded fields (a non-zero halo)
    at the block and at the precision tier's in-core shape, and the
    float64 rung at 12 steps on the block: bit for bit ``ref.wave_step``
    and ``ref.ladder_steps``, with times and bounds (bytes, or float64
    operations at the float64 rate)."""
    for shape in (BLOCK, PREC_SHAPE):
        n = math.prod(shape)
        pad = tuple(s + 2 * stencil_ref.HALO for s in shape)
        pp, pc = normal(pad, gen, 1.0, F64), normal(pad, gen, 1.0, F64)
        v2 = 0.05 + 0.01 * normal(shape, gen, 1.0, F64)
        kn, kl = stencil_kernel.wave_step(pp, pc, v2)
        rn, rl = stencil_ref.wave_step(pp, pc, v2)
        ok = same_bits(kn, rn) and same_bits(kl, rl)
        fn = lambda: stencil_kernel.wave_step(pp, pc, v2)
        r = {"max_abs_err": max(max_abs(kn, rn), max_abs(kl, rl)),
             "ms": median_ms(fn, 10),
             **kernel_device_ms(fn, "wave_step64_kernel", 10),
             "plain_ms": median_ms(lambda: stencil_ref.wave_step(pp, pc, v2),
                                   3),
             "bound": bound_ms(2 * pp.numel() * 8 + 3 * n * 8,
                               STENCIL_FLOPS * n, flop_rate=FP64_FLOP_PER_S)}
        results[("wave_step_f64", shape, 1)] = r
        emit({"phase": "kernel_vs_plain_f64", "kernel": "wave_step_f64",
              "shape": list(shape), "padded": list(pad), "bitwise": ok,
              **{k: v for k, v in r.items() if k != "bound"},
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "ptxas": kernel_ptxas("stencil64", "wave_step64_kernel")})
        check(ok, f"float64 wave_step differs from its plain version at "
                  f"{shape}")
        del pp, pc, v2, kn, kl, rn, rl
        torch.cuda.empty_cache()
    n = math.prod(BLOCK)
    pp, pc = normal(BLOCK, gen, 1.0, F64), normal(BLOCK, gen, 1.0, F64)
    v2 = 0.05 + 0.01 * normal(BLOCK, gen, 1.0, F64)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, BT)
    stencil_kernel.reset_launches()
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, BT)
    launched = stencil_kernel.launches["wave_multistep_f64"]
    ok = same_bits(kp, rp) and same_bits(kc, rc)
    err = max(max_abs(kp, rp), max_abs(kc, rc))
    del kp, kc, rp, rc
    torch.cuda.empty_cache()
    fn = lambda: stencil_kernel.wave_multistep(pp, pc, v2, BT)
    r = {"max_abs_err": err, "ms": median_ms(fn, 3),
         **kernel_device_ms(fn, "wave_rung64_kernel", 2),
         "plain_ms": median_ms(
             lambda: stencil_ref.ladder_steps(pp, pc, v2, BT), 2),
         "bound": bound_ms(5 * n * 8, STENCIL_FLOPS * n * BT,
                           flop_rate=FP64_FLOP_PER_S),
         "launches_per_call": launched}
    results[("wave_multistep_f64", BLOCK, BT)] = r
    emit({"phase": "kernel_vs_plain_f64", "kernel": "wave_multistep_f64",
          "shape": list(BLOCK), "steps": BT, "bitwise": ok,
          **{k: v for k, v in r.items() if k != "bound"},
          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
          # what one launch must move: p_prev, p_cur, vel2 in, p_next out
          "bound_ms_a_launch": bound_ms(4 * n * 8, STENCIL_FLOPS * n,
                                        flop_rate=FP64_FLOP_PER_S)[0],
          "ptxas": kernel_ptxas("stencil64", "wave_rung64_kernel")})
    check(ok, "float64 wave_multistep differs from its plain version")
    check(launched == BT, f"{launched} float64 rung launches for {BT} steps")
    del pp, pc, v2
    torch.cuda.empty_cache()
    # the ladder on a ragged unit (tiles cut in y and x)
    pp, pc = (normal(F64_RAGGED, gen, 1.0, F64) for _ in range(2))
    v2 = 0.05 + 0.01 * normal(F64_RAGGED, gen, 1.0, F64)
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, 5)
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, 5)
    ok = same_bits(kp, rp) and same_bits(kc, rc)
    emit({"phase": "multistep_ragged_f64", "shape": list(F64_RAGGED),
          "steps": 5, "bitwise": ok})
    check(ok, "float64 wave_multistep differs on the ragged unit")
    del pp, pc, v2, kp, kc, rp, rc
    torch.cuda.empty_cache()


def kernels64(gen, results):
    """Phase 3f: the float64 codec on the unit and on a ragged shape, the
    float64 stencil, and the ptxas lines of the float64 kernels."""
    codec64_case(UNIT, gen, results)
    codec64_case(F64_RAGGED, gen, results)
    emit({"phase": "ptxas_f64",
          "zfp64": ptxas_summary(build_log("zfp64")),
          "stencil64": ptxas_summary(build_log("stencil64"))})
    stencil64_cases(gen, results)


# ----------------------------------------------------------------------
# phase 4-5: the engine
# ----------------------------------------------------------------------


class DeviceClock:
    """CUDA events around the engines' codec and stencil calls, and a
    host clock around their crc32 digests, by wrapping the module
    attributes they call through; ``restore`` undoes it. The events are
    recorded on the stream current at the call: the caller's for the
    synchronous engine, the compute stream for the live engine. Digests
    on the caller's thread add to ``crc_s``, those on other threads (the
    live engine's host threads) to ``crc_thread_s``; both are the
    digests' own seconds, summed. How much of the host threads' digests
    the caller waited on is the engine's own ``crc_wait_s``."""

    def __init__(self):
        self.events = []
        self.crc_s = 0.0
        self.crc_thread_s = 0.0
        self._caller = threading.get_ident()
        self._lock = threading.Lock()
        self._saved = []
        for mod, name in ((zfp_ops, "compress"), (zfp_ops, "decompress"),
                          (stencil_ops, "fused_temporal_steps")):
            self._wrap_device(mod, name)
        self._wrap_crc()

    def _wrap_device(self, mod, name):
        fn = getattr(mod, name)
        self._saved.append((mod, name, fn))

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(mod, name, timed)

    def _wrap_crc(self):
        fn = outofcore.unit_checksum
        self._saved.append((outofcore, "unit_checksum", fn))

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with self._lock:
                if threading.get_ident() == self._caller:
                    self.crc_s += dt
                else:
                    self.crc_thread_s += dt
            return out

        outofcore.unit_checksum = timed

    def device_s(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def expected_summary(cfg: OOCConfig):
    """The transfer summary of one sweep from ``BlockPlan`` arithmetic:
    every unit fetched once per field and written back once per
    read-write field; compressed units carry W words (of the field
    type's width) and a 2-byte emax header per 4^3 block."""
    plan = cfg.plan
    z, y, x = cfg.shape
    itemsize = np.dtype(cfg.dtype).itemsize
    plane = y * x * itemsize
    blocks_of = lambda planes: (-(-planes // 4)) * (-(-y // 4)) * (-(-x // 4))
    tot = {"h2d_raw": 0, "h2d_wire": 0, "d2h_raw": 0, "d2h_wire": 0,
           "h2d_count": 0, "d2h_count": 0}
    h2d_planes = sum(plan.h2d_planes(i) for i in range(plan.ndiv))
    d2h_planes = sum(plan.d2h_planes(i) for i in range(plan.ndiv))
    check(h2d_planes == z and d2h_planes == z, "plan does not cover Z")
    for name, spec in cfg.fields.items():
        wire = 0
        for _, _, (lo, hi) in plan.units():
            if spec.compressed:
                w = zfp_ref.payload_words(3, spec.planes, 8 * itemsize)
                wire += blocks_of(hi - lo) * (4 * w + 2)
            else:
                wire += (hi - lo) * plane
        dirs = ("h2d", "d2h") if spec.role == "rw" else ("h2d",)
        for d, planes in (("h2d", h2d_planes), ("d2h", d2h_planes)):
            if d not in dirs:
                continue
            tot[f"{d}_raw"] += planes * plane
            tot[f"{d}_wire"] += wire
            tot[f"{d}_count"] += len(plan.units())
    return tot


def initial_fields(shape, dtype=torch.float32):
    """The example's initial condition, built on the card and brought
    to the host: Ricker p_cur, p_prev = 0.97 p_cur, vel2 = 0.06."""
    p_cur = stencil_ref.ricker_source(shape, dtype=dtype, device="cuda")
    host = {"p_cur": to_host(p_cur)}
    host["p_prev"] = to_host(0.97 * p_cur)
    del p_cur
    host["vel2"] = np.full(shape, 0.06, host["p_cur"].dtype)
    return host


def run_engine(cfg, fields, label, eng=None):
    """One sweep of the synchronous engine (seeded here unless ``eng``
    is given), with its wall, device compute and crc32 seconds."""
    clock = DeviceClock()
    try:
        t0 = time.perf_counter()
        if eng is None:
            eng = OutOfCoreWave(cfg, fields["p_prev"], fields["p_cur"],
                                fields["vel2"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dev0, crc0 = clock.device_s(), clock.crc_s
        eng.sweep()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dev1, crc1 = clock.device_s() - dev0, clock.crc_s - crc0
    finally:
        clock.restore()
    wall = t2 - t1
    row = {"phase": label, "seed_s": t1 - t0, "sweep_wall_s": wall,
           "sweep_device_compute_s": dev1, "sweep_crc32_s": crc1,
           "sweep_host_other_s": wall - dev1 - crc1,
           "idle_share": 1.0 - dev1 / wall,
           "transfer_summary": eng.transfer_summary()}
    emit(row)
    eng.smoke_rows = getattr(eng, "smoke_rows", []) + [row]
    return eng


def paper_slice():
    """Phase 4. Returns what the live engine's phase is held to: the
    host fields, the in-core run of 2 BT steps, code 4's gathered fields
    after two sweeps of the synchronous engine, and the engine's rows."""
    fields = initial_fields(PAPER)
    # the in-core ground truth, before the launch counts are zeroed:
    # BT steps, and BT more from there (the live phase's 2 sweeps)
    dev_in = {k: torch.from_numpy(v).cuda() for k, v in fields.items()}
    ref_pp, ref_pc = stencil_ops.fused_temporal_steps(
        dev_in["p_prev"], dev_in["p_cur"], dev_in["vel2"], steps=BT,
        backend="cuda")
    del dev_in["p_prev"], dev_in["p_cur"]
    ref2 = dict(zip(("p_prev", "p_cur"), stencil_ops.fused_temporal_steps(
        ref_pp, ref_pc, dev_in["vel2"], steps=BT, backend="cuda")))
    del dev_in
    torch.cuda.synchronize()
    emit({"phase": "incore_reference", "shape": list(PAPER),
          "steps": [BT, 2 * BT],
          "finite": bool(torch.isfinite(ref_pc).all()
                         and torch.isfinite(ref2["p_cur"]).all())})
    reset_counts()
    sync_rows, sync4 = {}, {}
    for code in (4, 1):
        cfg = OOCConfig(PAPER, NDIV, BT, paper_code_fields(code))
        eng = run_engine(cfg, fields, f"paper_code{code}")
        summary = eng.transfer_summary()
        want = expected_summary(cfg)
        got = {k: summary[k] for k in want}
        check(got == want, f"code {code} transfer summary {got} != {want}")
        out = {}
        for name, ref in (("p_cur", ref_pc), ("p_prev", ref_pp)):
            g = torch.from_numpy(eng.gather(name)).cuda()
            check(tuple(g.shape) == PAPER and bool(torch.isfinite(g).all()),
                  f"code {code} {name} not finite or misshapen")
            scale = float(ref.abs().max())
            out[name] = {"bitwise": same_bits(g, ref),
                         "max_rel_err": float((g - ref).abs().max()) / scale}
            del g
        emit({"phase": f"paper_code{code}_check", **out,
              "summary_matches_plan": True})
        if code == 1:
            check(out["p_cur"]["bitwise"] and out["p_prev"]["bitwise"],
                  "code 1 is not bit for bit the in-core run")
        else:
            check(out["p_cur"]["max_rel_err"] < 5e-2,
                  f"code {code} rel err {out['p_cur']['max_rel_err']}")
            # a second sweep: the live engine's code 4 is held to it
            run_engine(cfg, fields, f"paper_code{code}_sweep2", eng)
            sync4 = {n: torch.from_numpy(eng.gather(n)).cuda()
                     for n in ("p_prev", "p_cur")}
        sync_rows[code] = eng.smoke_rows
        del eng
    del ref_pp, ref_pc, ref
    return fields, ref2, sync4, sync_rows


# ----------------------------------------------------------------------
# phase 5b: the live engine (AsyncExecutor on three streams)
# ----------------------------------------------------------------------


def run_live(cfg, fields, label, **kw):
    """Seed the live engine and run LIVE_SWEEPS sweeps, the window open
    across each boundary (drained after the last). Its row: the wall of
    each sweep (host clock; the last includes the drain), each stream's
    busy seconds (CUDA events around the engine's copies and compute
    spans), device compute (events around the codec and stencil calls,
    on the compute stream), crc32 seconds on the host threads and on the
    caller's thread, the caller's seconds blocked on the host threads and
    the crc32 left on its critical path: measured, the part of those
    waits in which the job waited on was digesting (``crc32_wait_s``),
    and pro rata, the waits times crc32's share of the jobs' seconds
    (``crc32_wait_share_s``); the window's peak, the pinned bytes and the
    idle share, 1 - compute-stream busy / wall."""
    clock = DeviceClock()
    try:
        t0 = time.perf_counter()
        eng = AsyncExecutor(cfg, fields["p_prev"], fields["p_cur"],
                            fields["vel2"], schedule=LIVE_SCHEDULE, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dev0, crc0, thr0 = clock.device_s(), clock.crc_s, clock.crc_thread_s
        walls = []
        for k in range(LIVE_SWEEPS):
            ts = time.perf_counter()
            eng.sweep()
            if k == LIVE_SWEEPS - 1:
                eng.finish()
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts)
        dev = clock.device_s() - dev0
        crc, thr = clock.crc_s - crc0, clock.crc_thread_s - thr0
    finally:
        clock.restore()
    wall = sum(walls)
    busy = eng.lanes.busy_s()
    st = eng.stats()
    row = {"phase": label, "engine": "live", "schedule": LIVE_SCHEDULE,
           "shape": list(cfg.shape), "bt": cfg.bt, "sweeps": LIVE_SWEEPS,
           "seed_s": t1 - t0, "sweep_wall_s": walls, "wall_s": wall,
           "stream_busy_s": busy, "device_compute_s": dev,
           "crc32_thread_s": thr, "crc32_caller_s": crc,
           "host_job_s": st["lanes"]["host_job_s"],
           "host_wait_s": st["lanes"]["host_wait_s"],
           "crc32_wait_s": st["lanes"]["crc_wait_s"],
           "crc32_wait_share_s": st["lanes"]["host_wait_s"] * thr
           / st["lanes"]["host_job_s"],
           "host_threads": eng.lanes.threads,
           "max_inflight": st["max_inflight"],
           "streams": st["lanes"]["streams"],
           "pinned_bytes": st["lanes"]["pinned_bytes"],
           "idle_share": 1.0 - busy["compute"] / wall,
           "cache": {k: st["cache"][k] for k in
                     ("hits", "misses", "evictions", "flushes",
                      "d2h_elided")},
           "transfer_summary": eng.transfer_summary()}
    check(st["lanes"]["streams"] == 3 and st["lanes"]["pinned_bytes"] > 0,
          f"{label}: not on three streams with pinned staging")
    check(busy["h2d"] > 0 and busy["compute"] > 0,
          f"{label}: a stream did no work: {busy}")
    return eng, row


def live_log(eng):
    return sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                   t.wire_bytes if t.flush else None)
                  for t in eng.transfers)


def model_log(tasks):
    return sorted((t.kind, t.field, t.unit, t.sweep, t.flush,
                   int(t.amount) if t.flush else None)
                  for t in tasks if t.kind in ("h2d", "d2h"))


def live_paper(fields, ref2, sync4, sync_rows):
    """Codes 4 and 1 at 1152^3 through the live engine, two sweeps each:
    code 1 bit for bit the in-core run of 2 BT steps, code 4 bit for bit
    the synchronous engine's two sweeps and within 5e-2 of the in-core
    run; the transfer summary that of the task graph and of the plan
    arithmetic, twice."""
    for code in (4, 1):
        cfg = OOCConfig(PAPER, NDIV, BT, paper_code_fields(code))
        eng, row = run_live(cfg, fields, f"live_code{code}")
        summary = eng.transfer_summary()
        want = {k: LIVE_SWEEPS * v for k, v in expected_summary(cfg).items()}
        tasks = build_sweep_tasks(cfg, sweeps=LIVE_SWEEPS,
                                  schedule=LIVE_SCHEDULE)
        modeled = wire_totals(tasks)
        check({k: summary[k] for k in want} == want,
              f"live code {code} summary {summary} != {want}")
        check(all(round(modeled[d]) == summary[f"{d}_wire"]
                  for d in ("h2d", "d2h")),
              f"live code {code} wire {summary} != graph {modeled}")
        check(model_log(tasks) == live_log(eng),
              f"live code {code}: transfers differ from the task graph")
        eng.close()
        out = {}
        for name in ("p_cur", "p_prev"):
            g = torch.from_numpy(eng.gather(name)).cuda()
            ref = ref2[name]
            check(bool(torch.isfinite(g).all()),
                  f"live code {code} {name} not finite")
            out[name] = {
                "bitwise_incore": same_bits(g, ref),
                "max_rel_err_incore": float((g - ref).abs().max())
                / float(ref.abs().max()),
            }
            if code == 4:
                out[name]["bitwise_sync"] = same_bits(g, sync4[name])
            del g
        row["sync"] = sync_rows[code]
        row["check"] = out
        emit(row)
        if code == 1:
            check(all(v["bitwise_incore"] for v in out.values()),
                  "live code 1 is not bit for bit the in-core run")
        else:
            check(all(v["bitwise_sync"] for v in out.values()),
                  "live code 4 is not bit for bit the sync engine")
            check(out["p_cur"]["max_rel_err_incore"] < 5e-2,
                  f"live code 4 rel err {out['p_cur']}")
        del eng
        torch.cuda.empty_cache()


def live_residency(fields, want, sync_rows):
    """Write-back residency at (96, 1152, 1152), bt 1, code 4, with 90%
    of the working set's bytes: the transfer records (h2d, d2h,
    flushes) those of the task graph with the same budget, the residency
    counters its, wave_step launched once a block a sweep, and the
    gathered fields ``want``, the bt 1 sync engine's after the same 2
    sweeps from the same ``fields`` (``single_step_dispatch``), bit for
    bit."""
    shape = (SMALL_Z,) + PAPER[1:]
    cfg = OOCConfig(shape, NDIV, 1, paper_code_fields(4))
    _, y, x = shape
    ws = sum(unit_wire_bytes(spec, (hi - lo, y, x), 4)
             for spec in cfg.fields.values()
             for _, _, (lo, hi) in cfg.plan.units())
    # LRU over a cyclic sweep keeps nothing a sweep later below ~80% of
    # the working set (the task graph says so); at 90% part of the
    # units hit and the rest are evicted and flushed
    budget = ws * 9 // 10
    before = stencil_kernel.launches["wave_step"]
    eng, row = run_live(cfg, fields, "live_residency", cache_bytes=budget)
    steps = stencil_kernel.launches["wave_step"] - before
    stats = {}
    tasks = build_sweep_tasks(cfg, sweeps=LIVE_SWEEPS,
                              schedule=LIVE_SCHEDULE, cache_bytes=budget,
                              policy="write-back", stats=stats)
    same_log = model_log(tasks) == live_log(eng)
    cache = eng.stats()["cache"]
    same_cache = all(cache[k] == stats[k] for k in
                     ("hits", "evictions", "flushes", "d2h_elided"))
    eng.close()
    same = {n: bool(np.array_equal(eng.gather(n), want[n]))
            for n in ("p_prev", "p_cur", "vel2")}
    row.update(budget_bytes=budget, working_set_bytes=ws,
               transfers_equal_graph=same_log,
               cache_equal_graph=same_cache, bitwise_sync=same,
               wave_step_launches=steps, sync=sync_rows)
    emit(row)
    check(steps == LIVE_SWEEPS * NDIV,
          f"live residency launched wave_step {steps} times")
    check(same_log and same_cache,
          "live residency: transfers differ from the task graph")
    check(cache["hits"] > 0 and row["transfer_summary"]["h2d_count"] > 0,
          "live residency: the budget kept nothing or everything")
    check(all(same.values()), "live residency: differs from sync engine")


def live_slice(fields, ref2, sync4, sync_rows, bt1):
    live_paper(fields, ref2, sync4, sync_rows)
    live_residency(*bt1)
    return path_counts()


def single_step_dispatch():
    """The bt 1 sync engine, 2 sweeps at (96, 1152, 1152), code 4, on
    the kernels and on the plain versions, bit for bit. Returns the
    path's launch counts, and the fields, the kernels' engine's gathered
    fields and its rows, which the live residency run is held to."""
    shape = (SMALL_Z,) + PAPER[1:]
    fields = initial_fields(shape)
    engines = {}
    for backend in ("cuda", "ref"):
        cfg = OOCConfig(shape, NDIV, 1, paper_code_fields(4),
                        backend=backend)
        before = dict(stencil_kernel.launches)
        engines[backend] = run_engine(cfg, fields, f"bt1_{backend}")
        run_engine(cfg, fields, f"bt1_{backend}_sweep2", engines[backend])
        if backend == "cuda":
            launched = (stencil_kernel.launches["wave_step"]
                        - before["wave_step"])
            check(launched == 2 * NDIV,
                  f"bt=1 engine launched wave_step {launched} times")
            counts = path_counts()
    want = {name: engines["cuda"].gather(name)
            for name in ("p_prev", "p_cur", "vel2")}
    same = {name: bool(np.array_equal(want[name],
                                      engines["ref"].gather(name)))
            for name in want}
    emit({"phase": "bt1_cuda_vs_ref", "shape": list(shape), "sweeps": 2,
          "bitwise": same})
    check(all(same.values()), "bt=1 engine: cuda and ref backends differ")
    return counts, (fields, want, engines["cuda"].smoke_rows)


# ----------------------------------------------------------------------
# phases 5f-5p: float64, the paper's configuration
# ----------------------------------------------------------------------


def mem_available() -> int:
    """The host's available bytes (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def f64_paper_config():
    """The float64 paper cell, code 4 at 24/64, and the host bytes it
    holds at once (sized from the shapes): the three initial fields, the
    slab reference's p_cur, the engine's store while seeding, then a
    gathered field. Z is cut (ndiv with it, the units' shapes kept) only
    if that exceeds 85% of the host's available bytes."""
    avail = mem_available()
    ndiv = NDIV
    block = PAPER[0] // NDIV
    while True:
        shape = (block * ndiv,) + PAPER[1:]
        cfg = OOCConfig(shape, ndiv, BT, paper_code_fields(4, f32=False),
                        dtype="float64")
        field = math.prod(shape) * 8
        store = sum(unit_wire_bytes(spec, (hi - lo,) + shape[1:], 8)
                    for spec in cfg.fields.values()
                    for _, _, (lo, hi) in cfg.plan.units())
        peak = 3 * field + field + store
        if peak <= 0.85 * avail or ndiv <= 3:
            break
        ndiv -= 1
    row = {"phase": "paper_f64_host_bytes", "shape": list(shape),
           "ndiv": ndiv, "fields_bytes": 3 * field, "store_bytes": store,
           "reference_bytes": field, "gathered_bytes": field,
           "peak_bytes": peak, "mem_available_bytes": avail,
           "z_cut": shape != PAPER}
    emit(row)
    check(peak <= 0.85 * avail, f"the float64 paper cell does not fit the "
                                f"host: {row}")
    return cfg


def incore_slabs(fields, cfg):
    """The in-core run of ``cfg.bt`` steps in z-slabs on the card: each
    block with its bt * HALO planes of halo on either side (the zero
    boundary past them creeps in HALO planes a step and stops short of
    the block), through the multistep kernel. p_cur, on the host."""
    z = cfg.shape[0]
    block, halo = z // cfg.ndiv, stencil_ref.HALO * cfg.bt
    out = np.empty(cfg.shape, np.float64)
    for i in range(cfg.ndiv):
        s, e = i * block, (i + 1) * block
        lo, hi = max(0, s - halo), min(z, e + halo)
        dev = {k: torch.from_numpy(v[lo:hi]).cuda() for k, v in fields.items()}
        _, pc = stencil_ops.fused_temporal_steps(
            dev["p_prev"], dev["p_cur"], dev["vel2"], steps=cfg.bt,
            backend="cuda")
        out[s:e] = to_host(pc[s - lo:e - lo])
        del dev, pc
    torch.cuda.empty_cache()
    return out


def compare_slabs(got: np.ndarray, want: np.ndarray, slab: int):
    """(max |got - want|, max |want|, all finite), slab by slab on the
    card."""
    err = scale = 0.0
    finite = True
    for s in range(0, got.shape[0], slab):
        g = torch.from_numpy(got[s:s + slab]).cuda()
        w = torch.from_numpy(want[s:s + slab]).cuda()
        finite &= bool(torch.isfinite(g).all())
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
        del g, w
    return err, scale, finite


def paper_f64():
    """Phase 5f: the float64 paper cell through the sync engine, one
    sweep of code 4 at 24/64: wire bytes the plan's, p_cur against the
    slab-wise in-core run. Returns the path's launch counts (seeding,
    the sweep and the gather)."""
    cfg = f64_paper_config()
    t0 = time.perf_counter()
    fields = initial_fields(cfg.shape, torch.float64)
    t1 = time.perf_counter()
    ref_pc = incore_slabs(fields, cfg)
    t2 = time.perf_counter()
    emit({"phase": "paper_f64_reference", "shape": list(cfg.shape),
          "fields_s": t1 - t0, "incore_slabs_s": t2 - t1,
          "slab_halo_planes": stencil_ref.HALO * cfg.bt})
    reset_counts()
    t0 = time.perf_counter()
    eng = OutOfCoreWave(cfg, fields["p_prev"], fields["p_cur"],
                        fields["vel2"])
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    fields.clear()  # the store holds its own copies
    run_engine(cfg, None, "paper_f64_code4", eng)
    summary = eng.transfer_summary()
    want = expected_summary(cfg)
    got = {k: summary[k] for k in want}
    check(got == want, f"float64 code 4 transfer summary {got} != {want}")
    t0 = time.perf_counter()
    g = eng.gather("p_cur")
    gather_s = time.perf_counter() - t0
    counts = path_counts()
    err, scale, finite = compare_slabs(g, ref_pc, cfg.shape[0] // cfg.ndiv)
    del g, ref_pc, eng
    emit({"phase": "paper_f64_code4_check", "seed_s": seed_s,
          "gather_s": gather_s, "summary_matches_plan": True,
          "finite": finite, "max_abs_err": err, "ref_scale": scale,
          "max_rel_err": err / scale})
    check(finite and err / scale < 5e-2,
          f"float64 code 4: finite {finite}, rel err {err / scale}")
    for name in ("zfp_encode_f64", "zfp_decode_f64", "wave_multistep_f64"):
        check(counts[name] > 0, f"the float64 paper sweep never launched "
                                f"{name}")
    return counts


def live_f64():
    """Phase 5bf: ``AsyncExecutor`` on a float64 volume, code 4 at 24/64,
    two sweeps with the window open across the boundary: bit for bit the
    sync engine's two sweeps, transfers the task graph's and the plan's.
    Returns the live run's launch counts."""
    cfg = OOCConfig(F64_LIVE, 2, BT, paper_code_fields(4, f32=False),
                    dtype="float64")
    fields = initial_fields(F64_LIVE, torch.float64)
    sync = OutOfCoreWave(cfg, fields["p_prev"], fields["p_cur"],
                         fields["vel2"])
    sync.run(LIVE_SWEEPS * BT)
    want = {n: sync.gather(n) for n in ("p_prev", "p_cur", "vel2")}
    del sync
    reset_counts()
    eng, row = run_live(cfg, fields, "live_f64")
    counts = path_counts()
    tasks = build_sweep_tasks(cfg, sweeps=LIVE_SWEEPS, schedule=LIVE_SCHEDULE)
    summary = eng.transfer_summary()
    plan = {k: LIVE_SWEEPS * v for k, v in expected_summary(cfg).items()}
    same_log = model_log(tasks) == live_log(eng)
    eng.close()
    same = {n: bool(np.array_equal(eng.gather(n), want[n])) for n in want}
    row.update(bitwise_sync=same, transfers_equal_graph=same_log,
               summary_matches_plan={k: summary[k] for k in plan} == plan)
    emit(row)
    check(all(same.values()), f"live float64 differs from sync: {same}")
    check(same_log and row["summary_matches_plan"],
          "live float64: transfers differ from the task graph or the plan")
    for name in ("zfp_encode_f64", "zfp_decode_f64", "wave_multistep_f64"):
        check(counts[name] > 0, f"the live float64 run never launched {name}")
    return counts


def precision_tier():
    """Phase 5p: the paper's Fig. 7 on the card. ``error_curve`` for
    codes 1-4 in float64 at the paper's rates, and codes 2 and 4 in
    float32 at 16/12 for comparison, on PREC_SHAPE, ndiv 2, bt 12, 360
    sweeps (4,320 steps), sampled every 30: code 1 exactly 0, codes 2-4
    within PREC_TOL under ``assert_bounded_growth``. Returns the launch
    counts of the curves."""
    from repro_torch.core.precision import assert_bounded_growth, \
        error_curve

    reset_counts()
    t_all = time.perf_counter()
    for dtype, codes in (("float64", (1, 2, 3, 4)), ("float32", (2, 4))):
        for code in codes:
            t0 = time.perf_counter()
            rows = error_curve(code, shape=PREC_SHAPE, ndiv=PREC_NDIV, bt=BT,
                               sweeps=PREC_SWEEPS, sample_every=PREC_EVERY,
                               dtype=dtype)
            wall = time.perf_counter() - t0
            emit({"phase": "precision_curve", "dtype": dtype, "code": code,
                  "shape": list(PREC_SHAPE), "bt": BT, "wall_s": wall,
                  "rows": [{k: r[k] for k in ("steps", "max_abs", "rms",
                                              "ref_scale", "rel_max")}
                           for r in rows],
                  "units_last": rows[-1]["units"]})
            check(rows[-1]["steps"] == PREC_SWEEPS * BT,
                  f"the curve stops at {rows[-1]['steps']} steps")
            if code == 1:
                check(all(r["max_abs"] == 0.0 for r in rows),
                      f"{dtype} code 1 is not exact on the card")
            elif dtype == "float64":
                assert_bounded_growth(rows, PREC_TOL[code])
    counts = path_counts()
    emit({"phase": "precision_tier", "wall_s": time.perf_counter() - t_all,
          "steps": PREC_SWEEPS * BT, "tol": PREC_TOL})
    for name in ("zfp_encode_f64", "zfp_decode_f64", "wave_multistep_f64",
                 "wave_step_f64"):
        check(counts[name] > 0, f"the precision tier never launched {name}")
    return counts


# ----------------------------------------------------------------------
# phase 6: the fused ZFP-decode attention kernel at decode_32k
# ----------------------------------------------------------------------


def cdecode_bound(args):
    """Bytes that one cdecode call must move for ``args`` (payload and
    emax of the live chunks, the queries, the merged partials) and its
    bound: the larger of those bytes over the memory rate and its
    float32 operations (q.K and p.V) over the float32 rate."""
    pay, q, hist = args[0], args[4], args[5]
    rows, nb, w = pay.shape
    qpk, d = q.shape[1:]
    nbc = kvcache._nb_per_chunk(d)
    live = cdecode_ref.live_chunks(hist, nb // nbc)
    nbytes = (2 * rows * live * nbc * (4 * w + 4)  # payload + emax
              + q.numel() * 4 + rows * qpk * (d + 2) * 4)
    flops = 2 * 2 * rows * qpk * hist * d
    return nbytes, bound_ms(nbytes, flops)


def cdecode_cases(gen, results):
    """Kernel partials against the plain version on one cache per rate:
    every chunk of the 32k context encoded by the codec kernel from
    normal K and V (the cache's own layout, ``_encode_chunk`` over all
    chunks at once)."""
    rows, d = CD_SLOTS * CD_KVH, CD_D
    for planes in (16, 12):
        pay, em = [], []
        for _ in range(2):  # K, then V
            x = torch.randn((CD_SLOTS, CD_KVH, CTX, d), generator=gen,
                            device="cuda")
            p, e = zfp_kernel.encode(x, planes, 2)
            pay.append(p.view(rows, -1, p.shape[-1]))
            em.append(e.view(rows, -1))
            del x
        for length in CD_LENGTHS:
            hist = (length // kvcache.CHUNK) * kvcache.CHUNK
            q = torch.randn((rows, CD_QPK, d), generator=gen, device="cuda")
            q = q * scale_in(d, torch.float32)
            args = (pay[0], em[0], pay[1], em[1], q, hist)
            kw = dict(planes=planes, head_dim=d, qpk=CD_QPK)
            got = cdecode_kernel.fused_cdecode_attention(*args, **kw)
            want = cdecode_ref.fused_cdecode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            ok = all(bool(torch.allclose(g, w_, rtol=CD_TOL, atol=CD_TOL))
                     for g, w_ in zip(got, want))
            err = max(max_abs(g, w_) for g, w_ in zip(got, want))
            # per output: largest |d| / (atol + rtol |want|), 1 at the bound
            ratio = {k: float(((g - w_).abs().nan_to_num(0)
                               / (CD_TOL + CD_TOL * w_.abs())).max())
                     for k, g, w_ in zip(("m", "l", "acc"), got, want)}
            nbytes, bound = cdecode_bound(args)
            r = {
                "max_abs_err": err,
                "ms": median_ms(lambda: cdecode_kernel.fused_cdecode_attention(
                    *args, **kw), 20),
                "plain_ms": median_ms(
                    lambda: cdecode_ref.fused_cdecode_attention_ref(
                        *args, **kw), 2),
                "bound": bound,
            }
            results[("cdecode", (CD_SLOTS, CD_KVH, CTX), (planes, length))] = r
            emit({"phase": "kernel_vs_plain", "kernel": "cdecode",
                  "slots": CD_SLOTS, "kv_heads": CD_KVH, "qpk": CD_QPK,
                  "head_dim": d, "max_len": CTX, "length": length,
                  "hist_len": hist, "planes": planes, "within_tol": ok,
                  "tol": CD_TOL, "max_abs_err": err,
                  "tol_ratio": ratio, "ms": r["ms"],
                  "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                  "bound_by": r["bound"][1], "bound_bytes": nbytes,
                  "library_ms": None,
                  "library_note": "no single PyTorch call decodes ZFP "
                                  "and attends"})
            check(ok, f"cdecode differs from its plain version at planes "
                      f"{planes}, length {length} (max |d| {err})")
        del pay, em


def cdecode_f64_witness():
    """Which side of the kernel/plain comparison carries the error: at
    ``decode_32k``, 16 and 12 planes, length 30000, on three seeds,
    the kernel's and the plain version's (m, l, acc) against a float64
    evaluation of the same decoded tiles (the codec's plain decode),
    each at its own m: per output the largest |d| / (atol + rtol |f64|)
    with CD_TOL, 1 at the bound. The kernel must lie within the bound of
    the float64 values."""
    rows, d = CD_SLOTS * CD_KVH, CD_D
    hist = (CD_LENGTHS[0] // kvcache.CHUNK) * kvcache.CHUNK
    nb = (hist // kvcache.CHUNK) * kvcache._nb_per_chunk(d)
    cases = []
    for seed in (SEED + 1, SEED + 2, SEED + 3):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for planes in (16, 12):
            pay, em = [], []
            for _ in range(2):
                x = torch.randn((rows, hist, d), generator=gen, device="cuda")
                p, e = zfp_kernel.encode(x, planes, 2)
                pay.append(p.view(rows, -1, p.shape[-1]))
                em.append(e.view(rows, -1))
                del x
            q = torch.randn((rows, CD_QPK, d), generator=gen, device="cuda")
            q = q * scale_in(d, torch.float32)
            args = (pay[0], em[0], pay[1], em[1], q, hist)
            kw = dict(planes=planes, head_dim=d, qpk=CD_QPK)
            sides = {
                "kernel": cdecode_kernel.fused_cdecode_attention(*args, **kw),
                "plain": cdecode_ref.fused_cdecode_attention_ref(*args, **kw)}
            k64, v64 = (cdecode_ref.decode_tiles(p[:, :nb], e[:, :nb], planes,
                                                 d).double()
                        for p, e in zip(pay, em))
            logits = torch.einsum("gqd,gtd->gqt", q.double(), k64)
            m64 = logits.amax(-1)
            case = {"seed": seed, "planes": planes, "hist_len": hist}
            for side, (m, l, acc) in sides.items():
                p = torch.exp(logits - m.double()[..., None])
                want = (m64, p.sum(-1), torch.einsum("gqt,gtd->gqd", p, v64))
                case[side] = {k: float(((g.double() - w).abs()
                                        / (CD_TOL + CD_TOL * w.abs())).max())
                              for k, g, w in zip(("m", "l", "acc"),
                                                 (m, l, acc), want)}
                del p
            cases.append(case)
            del pay, em, k64, v64, logits, sides
            torch.cuda.empty_cache()
    worst = {side: {k: max(c[side][k] for c in cases)
                    for k in ("m", "l", "acc")}
             for side in ("kernel", "plain")}
    emit({"phase": "cdecode_f64_witness", "tol": CD_TOL, "cases": cases,
          "worst": worst})
    check(max(worst["kernel"].values()) < 1.0,
          f"cdecode is not within {CD_TOL} of float64: {worst['kernel']}")


# ----------------------------------------------------------------------
# phase 7: the serving slice at full width
# ----------------------------------------------------------------------


def record_logits(eng):
    """Keep every step's logits (float32, on the host) by wrapping the
    engine's decode-step function."""
    logs, inner = [], eng._step

    def step(*args):
        logits, cache = inner(*args)
        logs.append(logits.float().cpu())
        return logits, cache

    eng._step = step
    return logs


def serve(cfg, params, prompts, max_new, backend, *, slots=SERVE_SLOTS,
          max_len=SERVE_MAX_LEN, on_engine=None):
    eng = ServeEngine(cfg, params, slots=slots, max_len=max_len,
                      device="cuda", backend=backend)
    logs = record_logits(eng)
    if on_engine is not None:
        on_engine(eng)
    rids = [eng.submit(p, max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(set(done) == set(rids), f"{backend} engine left requests unanswered")
    return [done[r] for r in rids], torch.stack(logs), wall, eng


def replay_ratio(logits, ref_logits):
    """Per step: max |d logits| / max |logits| over the slots."""
    diff = (logits - ref_logits).abs().amax(dim=(1, 2))
    return (diff / ref_logits.abs().amax(dim=(1, 2))).tolist()


@contextlib.contextmanager
def last_attention_inputs(layers):
    """Keep the ``(q, ckv)`` of the last ``layers`` calls of the
    compressed attention (the last step's, one per layer) by wrapping
    ``cdecode_ops.fused_compressed_decode_attention`` for the duration.
    The cache tensors are views that later steps update in place; after
    the run they hold what the last step read."""
    seen = collections.deque(maxlen=layers)
    inner = cdecode_ops.fused_compressed_decode_attention

    def record(q, ckv, **kw):
        seen.append((q, ckv))
        return inner(q, ckv, **kw)

    cdecode_ops.fused_compressed_decode_attention = record
    try:
        yield seen
    finally:
        cdecode_ops.fused_compressed_decode_attention = inner


def serve_kernels_on_cache(cfg, eng, seen):
    """The serving path's kernels against their plain versions at the
    shapes it gives them, on the engine's own cache after the run:
    cdecode on every layer's compressed history with that layer's q of
    the last step (within CD_TOL), and the chunk-flush encode of every
    layer's K and V tail window (bit for bit). ``ms`` times the launch
    as the path makes it (unmerged splits), ``merged_ms`` with the
    splits merged (the reference's contract). Not counted as launches
    of the path: the counts were read before."""
    check(len(seen) == cfg.num_layers, f"recorded {len(seen)} layers")
    ok, err = True, 0.0
    for q, ckv in seen:
        args, kw = cdecode_ops.history_inputs(q, ckv)
        kw["planes"] = SERVE_PLANES
        got = cdecode_kernel.fused_cdecode_attention(*args, **kw)
        want = cdecode_ref.fused_cdecode_attention_ref(*args, **kw)
        ok &= all(bool(torch.allclose(g, w, rtol=CD_TOL, atol=CD_TOL))
                  for g, w in zip(got, want))
        err = max(err, max(max_abs(g, w) for g, w in zip(got, want)))
    args, kw = cdecode_ops.history_inputs(*seen[0])
    kw["planes"] = SERVE_PLANES
    nbytes, bound = cdecode_bound(args)
    rows = args[0].shape[0]
    split = cdecode_kernel.split_plan(rows, cdecode_kernel.live_bands(
        args[5], args[0].shape[1] // cfg.head_dim))
    # the kernel's decoded K and V of the first chunk, against the plain
    # codec's decode of it
    tiles = cdecode_kernel.decoded_tiles(
        *args[:4], planes=SERVE_PLANES, head_dim=cfg.head_dim, band0=0,
        nbands=cdecode_kernel.BANDS_PER_CHUNK)
    nbc = kvcache._nb_per_chunk(cfg.head_dim)
    codec = [zfp_ref.unblockify(zfp_ref.decode_blocks(
                 p[:, :nbc].reshape(-1, p.shape[-1]), e[:, :nbc].reshape(-1),
                 SERVE_PLANES, 2), (rows, kvcache.CHUNK, cfg.head_dim), 2)
             for p, e in ((args[0], args[1]), (args[2], args[3]))]
    tiles_ok = all(same_bits(a, b) for a, b in zip(tiles, codec))
    same = True
    for i in range(cfg.num_layers):
        for tail in (eng.cache.tail_k[i], eng.cache.tail_v[i]):
            a = kvcache._encode_chunk(tail, SERVE_PLANES, "cuda")
            b = kvcache._encode_chunk(tail, SERVE_PLANES, "ref")
            same &= same_bits(a[0], b[0]) and same_bits(a[1], b[1])
    # the chunk-flush encode as the path launches it: one (B, KVH, CHUNK,
    # D) window, 2-D blocks
    xt = eng.cache.tail_k[0].movedim(2, 1).float().contiguous()
    flush = lambda: zfp_kernel.encode(xt, SERVE_PLANES, 2)
    fp, fe = flush()
    flush_bound = bound_ms(xt.numel() * 4 + fp.numel() * 4 + fe.numel() * 4)
    encode_flush = {
        "shape": list(xt.shape), "planes": SERVE_PLANES,
        "ms": median_ms(flush, 20),
        **kernel_device_ms(flush, "encode_kernel", 20),
        "plain_ms": median_ms(lambda: zfp_ref.encode_blocks(
            zfp_ref.blockify(xt, 2), SERVE_PLANES, 2), 5),
        "bound_ms": flush_bound[0], "bound_by": flush_bound[1]}
    emit({"phase": "serve_kernels_on_cache", "layers": len(seen),
          "cdecode_rows": args[0].shape[0], "max_len": SERVE_MAX_LEN,
          "length": seen[0][1].length, "hist_len": args[5],
          "nsplit_per": list(split), "ctas": rows * split[0],
          "decoded_tiles_bitwise": tiles_ok, "within_tol": ok, "tol": CD_TOL,
          "max_abs_err": err,
          "ms": median_ms(lambda: cdecode_kernel.cdecode_partials(
              *args, **kw), 20),
          **kernel_device_ms(lambda: cdecode_kernel.cdecode_partials(
              *args, **kw), "cdecode_kernel", 20),
          "merged_ms": median_ms(
              lambda: cdecode_kernel.fused_cdecode_attention(*args, **kw), 20),
          "plain_ms": median_ms(lambda: cdecode_ref.fused_cdecode_attention_ref(
              *args, **kw), 5),
          "bound_ms": bound[0], "bound_by": bound[1], "bound_bytes": nbytes,
          "smem_bytes": cdecode_kernel.smem_bytes(
              cfg.head_dim, kw["qpk"], args[0].shape[-1]),
          "encode_shape": list(eng.cache.tail_k[0].movedim(2, 1).shape),
          "encode_bitwise": same, "encode_flush": encode_flush})
    check(ok, f"cdecode differs from its plain version on the serving "
              f"cache (max |d| {err})")
    check(tiles_ok, "cdecode's decoded tiles differ from the codec's decode")
    check(same, "the chunk-flush encode differs from the plain codec")


def serving_slice():
    base = dataclasses.replace(get_config(SERVE_ARCH),
                               num_layers=SERVE_LAYERS)
    cfg = dataclasses.replace(base, kv_compress_planes=SERVE_PLANES)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(SERVE_SLOTS, PROMPT)).tolist()

    zfp_kernel.reset_launches()
    cdecode_kernel.reset_launches()
    with last_attention_inputs(cfg.num_layers) as seen:
        outs, logits, wall, eng = serve(cfg, params, prompts, MAX_NEW, "cuda")
    counts = {"zfp_encode": zfp_kernel.launches["encode"],
              "zfp_decode": zfp_kernel.launches["decode"],
              "cdecode": cdecode_kernel.launches["cdecode"]}
    check(all(len(o) == MAX_NEW for o in outs), "a request fell short")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    steps = PROMPT + MAX_NEW - 1
    check(tuple(logits.shape) == (steps, SERVE_SLOTS, cfg.vocab_size),
          f"logits {tuple(logits.shape)}")
    check(counts["zfp_encode"] > 0 and counts["cdecode"] > 0,
          f"the serving path missed a kernel: {counts}")
    raw_bytes = (2 * cfg.num_layers * SERVE_SLOTS * SERVE_MAX_LEN
                 * cfg.num_kv_heads * cfg.head_dim
                 * torch.finfo(lm.dtype_of(cfg)).bits // 8)
    comp_bytes = kvcache.compressed_bytes(eng.cache)
    gen_tokens = sum(len(o) for o in outs)
    emit({"phase": "serve_cuda", "arch": SERVE_ARCH, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "kv_planes": SERVE_PLANES, "slots": SERVE_SLOTS, "prompt": PROMPT,
          "max_new": MAX_NEW, "max_len": SERVE_MAX_LEN, "steps": steps,
          "wall_s": wall, "new_tokens": gen_tokens,
          "new_tokens_per_s": gen_tokens / wall,
          "fed_tokens_per_s": SERVE_SLOTS * steps / wall,
          "compressed_cache_bytes": comp_bytes, "raw_cache_bytes": raw_bytes,
          "raw_over_compressed": raw_bytes / comp_bytes, "launches": counts})
    serve_kernels_on_cache(cfg, eng, seen)
    del eng, seen
    torch.cuda.empty_cache()

    # teacher-forced replays of the same streams
    forced = [p + o[:-1] for p, o in zip(prompts, outs)]
    chosen = torch.tensor(outs).T  # (MAX_NEW, slots)
    for label, rcfg, backend in (("ref", cfg, "ref"), ("raw_cache", base,
                                                          "cuda")):
        _, ref_logits, rwall, reng = serve(rcfg, params, forced, 1, backend)
        del reng
        ratio = replay_ratio(logits, ref_logits)
        agree = (ref_logits[PROMPT - 1:].argmax(-1) == chosen).float().mean()
        emit({"phase": f"serve_replay_{label}", "backend": backend,
              "kv_planes": rcfg.kv_compress_planes, "wall_s": rwall,
              "max_ratio": max(ratio), "median_ratio": statistics.median(ratio),
              "greedy_agreement": float(agree)})
        if label == "ref":
            check(max(ratio) < SERVE_TOL,
                  f"cuda engine vs ref engine: ratio {max(ratio)}")
        torch.cuda.empty_cache()
    serve_profile(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    return counts


def serve_profile(cfg, params, prompts):
    """Device time by kernel over one chunk's worth of steady decode
    steps (positions 64-127, one chunk flush, every slot still reading
    its prompt)."""
    eng = ServeEngine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                      device="cuda")
    for p in prompts:
        eng.submit(p[:2 * kvcache.CHUNK + 1], max_new=1)
    profile_window(eng, kvcache.CHUNK, kvcache.CHUNK, "serve_profile")


def profile_window(eng, warm, steps, label):
    """Device time by kernel over ``steps`` decode steps after ``warm``
    steps, from ``torch.profiler`` (CUPTI), against the wall time of the
    same steps run first without the profiler on the same engine, whose
    cache and positions are then restored. Every slot must still be
    reading its prompt at the window's end."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        eng.step()
    torch.cuda.synchronize()
    pos = eng.pos.copy()
    snap = eng.cache._replace(**{
        f: t.clone() for f, t in eng.cache._asdict().items()
        if isinstance(t, torch.Tensor)})

    def window():
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps

    step_s = window()
    eng.pos, eng.cache = pos, snap
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_s = window()
    check(all(r is not None and not r.out for r in eng.active.values()),
          "a request left its prompt inside the profiled window")
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(device), "the profiler saw no device time")
    busy_step = sum(e.self_device_time_total for e in device) / 1e6 / steps
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": label, "steps": steps, "first_position": warm,
          "device_busy_per_step_s": busy_step,
          "unprofiled_wall_per_step_s": step_s,
          "profiled_wall_per_step_s": profiled_s,
          "idle_share": 1 - busy_step / step_s,
          "top_kernels": [{"name": e.key[:80], "count": e.count,
                           "total_ms": e.self_device_time_total / 1e3}
                          for e in top]})
    del eng, snap
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 8: the selective-scan kernel at the falcon-mamba shapes
# ----------------------------------------------------------------------


def sscan_bound(bsz, s, d, n):
    """Bytes one scan must move (dt, x and y; B and C; A; h0 and h_last,
    each once) and its bound: the largest of those bytes over the memory
    rate, its float32 operations (dt*x per (b, t, d); per (b, t, d, n):
    dt*A, B*(dt x), decay*h +, C*h +) over the float32 rate, and its
    exponentials (one per (b, t, d, n)) over the SFU rate."""
    nbytes = 4 * (3 * bsz * s * d + 2 * bsz * s * n + d * n + 2 * bsz * d * n)
    elems = bsz * s * d * n
    return nbytes, bound_ms(nbytes, 6 * elems + bsz * s * d, elems)


def sscan_inputs(shape, gen):
    """((dt, a, b_in, c_in, x), h0) on the card, distributed as
    ``tests/test_sscan_kernel.py`` draws them, with a non-zero ``h0``."""
    bsz, s, d, n = shape
    dt = torch.nn.functional.softplus(normal((bsz, s, d), gen, 1.0))
    a = -torch.exp(normal((d, n), gen, 0.3))
    b_in, c_in = normal((bsz, s, n), gen, 1.0), normal((bsz, s, n), gen, 1.0)
    x = normal((bsz, s, d), gen, 1.0)
    return (dt, a, b_in, c_in, x), normal((bsz, d, n), gen, 0.1)


def sscan_cases(gen, results):
    """The kernel against its plain version, from a non-zero ``h0`` that
    the kernel overwrites in place with ``h_last``; the kernel's device
    time a launch (profiler) beside the CUDA-event time of the call."""
    ptxas = kernel_ptxas("sscan", "sscan_kernel")
    for shape in SSCAN_SHAPES:
        bsz, s, d, n = shape
        args, h0 = sscan_inputs(shape, gen)
        want_y, want_h = sscan_ref.selective_scan_ref(*args, h0, SSCAN_CHUNK)
        h_io = h0.clone()
        y, h = sscan_kernel.selective_scan(*args, h_io, h_out=h_io)
        torch.cuda.synchronize()
        ok = (h is h_io and bool(torch.allclose(y, want_y, **SSCAN_TOL))
              and bool(torch.allclose(h_io, want_h, **SSCAN_TOL)))
        err = max(max_abs(y, want_y), max_abs(h_io, want_h))
        nbytes, bound = sscan_bound(*shape)
        long = s > 1000
        call = lambda: sscan_kernel.selective_scan(*args, h0)
        r = {
            "max_abs_err": err,
            "ms": median_ms(call, 5 if long else 20),
            **kernel_device_ms(call, "sscan_kernel", 5 if long else 20),
            "plain_ms": median_ms(lambda: sscan_ref.selective_scan_ref(
                *args, h0, SSCAN_CHUNK), 2 if long else 5),
            "bound": bound,
        }
        results[("sscan", shape, SSCAN_CHUNK)] = r
        emit({"phase": "kernel_vs_plain", "kernel": "sscan",
              "shape_bsdn": list(shape), "within_tol": ok, "tol": SSCAN_TOL,
              "max_abs_err": err, "ms": r["ms"], "device_ms": r["device_ms"],
              "device_ms_by": r["device_ms_by"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "bound_bytes": nbytes,
              "sfu_per_s": sfu_per_s(), "library_ms": None,
              "library_note": "no single PyTorch call computes the "
                              "selective scan", "ptxas": ptxas})
        check(ok, f"sscan differs from its plain version at {shape} "
                  f"(max |d| {err})")
        del args, h0, h_io, y, want_y, want_h
        torch.cuda.empty_cache()


def sscan_f64_witness(gen):
    """Which side of the kernel/plain comparison carries the error: at
    falcon-mamba's widths, S = 128 and 4096, the kernel's and the plain
    version's y and h_last against the float64 recurrence
    (``ref.selective_scan_f64``) over every SSCAN_WITNESS_STRIDE-th
    channel (a slice of every CTA): per output the largest
    |d| / (atol + rtol |f64|) with SSCAN_TOL, 1 at the bound. The kernel
    must lie within the bound of float64. The mean of the same ratio
    is printed beside the largest."""
    cases = []
    for shape in SSCAN_WITNESS:
        bsz, s, d, n = shape
        args, h0 = sscan_inputs(shape, gen)
        sides = {"kernel": sscan_kernel.selective_scan(*args, h0),
                 "plain": sscan_ref.selective_scan_ref(*args, h0,
                                                       SSCAN_CHUNK)}
        sl = slice(0, d, SSCAN_WITNESS_STRIDE)
        dt, a, b_in, c_in, x = args
        want = sscan_ref.selective_scan_f64(dt[:, :, sl], a[sl], b_in, c_in,
                                            x[:, :, sl], h0[:, sl])
        case = {"shape_bsdn": list(shape), "channels": want[1].shape[1]}
        for side, (y, h) in sides.items():
            case[side] = {}
            for k, g, w in (("y", y[:, :, sl], want[0]),
                            ("h", h[:, sl], want[1])):
                r = ((g.double() - w).abs()
                     / (SSCAN_TOL["atol"] + SSCAN_TOL["rtol"] * w.abs()))
                case[side][k] = float(r.max())
                case[side][f"{k}_mean"] = float(r.mean())
        case["carries"] = {k: max(("kernel", "plain"),
                                  key=lambda side: case[side][k])
                           for k in ("y", "h")}
        cases.append(case)
        del args, h0, sides, want, dt, a, b_in, c_in, x
        torch.cuda.empty_cache()
    worst = {side: {k: max(c[side][k] for c in cases) for k in ("y", "h")}
             for side in ("kernel", "plain")}
    emit({"phase": "sscan_f64_witness", "tol": SSCAN_TOL,
          "channel_stride": SSCAN_WITNESS_STRIDE, "cases": cases,
          "worst": worst})
    check(max(worst["kernel"].values()) < 1.0,
          f"sscan is not within {SSCAN_TOL} of float64: {worst['kernel']}")


# ----------------------------------------------------------------------
# phase 9: the SSM slice at full width
# ----------------------------------------------------------------------


def states_after(eng, steps, snap):
    """Copy the engine's SSM states into ``snap`` after its ``steps``-th
    decode step (by wrapping its decode-step function)."""
    inner, count = eng._step, [0]

    def step(*args):
        logits, cache = inner(*args)
        count[0] += 1
        if count[0] == steps:
            snap["conv"], snap["h"] = cache.conv.clone(), cache.h.clone()
        return logits, cache

    eng._step = step


@contextlib.contextmanager
def scan_calls():
    """Keep every call of ``sscan_ops.selective_scan`` (its arguments and
    results) for the duration."""
    seen = []
    inner = sscan_ops.selective_scan

    def record(*args, **kw):
        y, h = inner(*args, **kw)
        seen.append((args, kw, y, h))
        return y, h

    sscan_ops.selective_scan = record
    try:
        yield seen
    finally:
        sscan_ops.selective_scan = inner


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|, in float32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def prefill_layers_check(cfg, calls, label):
    """Every layer's scan of one prefill against the plain version on
    the inputs the prefill gave it (recorded by ``scan_calls``)."""
    check(len(calls) == cfg.num_layers, f"recorded {len(calls)} scans")
    ok, err = True, 0.0
    with torch.inference_mode():
        for args, kw, y, h in calls:
            want_y, want_h = sscan_ref.selective_scan_ref(*args, kw["chunk"])
            ok &= bool(torch.allclose(y, want_y, **SSCAN_TOL)) and bool(
                torch.allclose(h, want_h, **SSCAN_TOL))
            err = max(err, max_abs(y, want_y), max_abs(h, want_h))
    check(ok, f"{label}: sscan differs from its plain version inside the "
              f"prefill (max |d| {err})")
    return {"layers_within_tol": ok, "tol": SSCAN_TOL, "max_abs_err": err,
            "scan_shape_bsdn": list(calls[0][0][0].shape) + [cfg.ssm_state]}


def prefill_cuda(cfg, params, toks, pos):
    """``prefill`` through the kernel, every layer's scan then held to
    the plain version: (wall s, logits, states, the check's numbers)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with scan_calls() as calls:
        logits, states = lm.prefill(cfg, params, toks, pos, backend="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, logits, states, prefill_layers_check(cfg, calls, cfg.dtype)


def prefill_vs_ref(cfg, params, toks, pos, k_logits, k_states):
    """The kernel's prefill (``k_logits``, ``k_states``) against
    ``prefill`` through the plain version on the card."""
    r_logits, r_states = lm.prefill(cfg, params, toks, pos, backend="ref")
    h_ok = [bool(torch.allclose(k_states.h[i], r_states.h[i], **SSCAN_TOL))
            for i in range(cfg.num_layers)]
    return {"logits_rel": rel(k_logits, r_logits),
            "greedy_agreement": float((k_logits.argmax(-1)
                                       == r_logits.argmax(-1)).float().mean()),
            "h_within_tol_layers": sum(h_ok),
            "conv_equal_layer0": bool(torch.equal(k_states.conv[0],
                                                  r_states.conv[0])),
            "h_rel_max_over_layers": max(rel(k_states.h[i], r_states.h[i])
                                         for i in range(cfg.num_layers)),
            "conv_rel": rel(k_states.conv, r_states.conv)}


def ssm_slice():
    cfg = get_config(SSM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(SSM_SLOTS, SSM_PROMPT)).tolist()
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    pos = torch.arange(SSM_PROMPT, dtype=torch.int32,
                       device="cuda").expand(SSM_SLOTS, -1)
    fed = {}
    serve_kw = dict(slots=SSM_SLOTS, max_len=SSM_MAX_LEN)

    # the path: serve, then prefill, through the kernel, counted from 0
    reset_counts()
    cdecode_kernel.reset_launches()
    sscan_kernel.reset_launches()
    outs, logits, wall, eng = serve(
        cfg, params, prompts, SSM_NEW, "cuda",
        on_engine=lambda e: states_after(e, SSM_PROMPT, fed), **serve_kw)
    serve_launches = sscan_kernel.launches["sscan"]
    p_wall, p_logits, p_states, p_check = prefill_cuda(cfg, params, toks, pos)
    counts = {"sscan": sscan_kernel.launches["sscan"],
              "zfp_encode": zfp_kernel.launches["encode"],
              "zfp_decode": zfp_kernel.launches["decode"],
              "cdecode": cdecode_kernel.launches["cdecode"],
              **stencil_kernel.launches}
    del eng
    torch.cuda.empty_cache()

    steps = SSM_PROMPT + SSM_NEW - 1
    check(all(len(o) == SSM_NEW for o in outs), "a request fell short")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(tuple(logits.shape) == (steps, SSM_SLOTS, cfg.vocab_size),
          f"logits {tuple(logits.shape)}")
    check(serve_launches == cfg.num_layers * steps,
          f"sscan launched {serve_launches} times over {steps} steps")
    check(counts["sscan"] == cfg.num_layers * (steps + 1),
          f"prefill launched sscan {counts['sscan'] - serve_launches} times")
    gen_tokens = sum(len(o) for o in outs)
    emit({"phase": "ssm_serve_cuda", "arch": SSM_ARCH, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
          "slots": SSM_SLOTS, "prompt": SSM_PROMPT, "max_new": SSM_NEW,
          "steps": steps, "wall_s": wall, "new_tokens": gen_tokens,
          "new_tokens_per_s": gen_tokens / wall,
          "fed_tokens_per_s": SSM_SLOTS * steps / wall,
          "max_abs_logits": float(logits.abs().max()),
          "sscan_launches": serve_launches,
          "params_bytes": sum(t.numel() * t.element_size()
                              for t in params.parameters())})
    check(bool(torch.isfinite(p_logits).all()), "non-finite prefill logits")
    last = logits[SSM_PROMPT - 1].to(p_logits.device)
    emit({"phase": "ssm_prefill_cuda", "tokens": [SSM_SLOTS, SSM_PROMPT],
          "wall_s": p_wall, **p_check,
          "vs_decode_fed_engine": {
              "logits_rel": rel(p_logits, last),
              "greedy_agreement": float((p_logits.argmax(-1)
                                         == last.argmax(-1)).float().mean()),
              "h_rel": rel(p_states.h, fed["h"]),
              "conv_rel": rel(p_states.conv, fed["conv"])}})
    del fed
    torch.cuda.empty_cache()

    # the plain versions on the card, bf16: printed. Over 64 random bf16
    # layers the two sides drift apart by bf16 rounding as far as the
    # prefill and the decode-fed engine (both through the kernel) do.
    forced = [p + o[:-1] for p, o in zip(prompts, outs)]
    chosen = torch.tensor(outs).T  # (SSM_NEW, slots)
    _, ref_logits, rwall, _ = serve(cfg, params, forced, 1, "ref", **serve_kw)
    ratio = replay_ratio(logits, ref_logits)
    agree = (ref_logits[SSM_PROMPT - 1:].argmax(-1) == chosen).float().mean()
    emit({"phase": "ssm_serve_replay_ref", "dtype": cfg.dtype,
          "wall_s": rwall, "max_ratio": max(ratio),
          "median_ratio": statistics.median(ratio),
          "greedy_agreement": float(agree),
          "ratios": [round(r, 6) for r in ratio]})
    del ref_logits
    emit({"phase": "ssm_prefill_vs_ref", "dtype": cfg.dtype,
          **prefill_vs_ref(cfg, params, toks, pos, p_logits, p_states)})
    del p_states
    torch.cuda.empty_cache()

    eng = ServeEngine(cfg, params, device="cuda", **serve_kw)
    for p in prompts:
        eng.submit(p, max_new=1)
    profile_window(eng, *SSM_WINDOW, "ssm_profile")
    del eng

    # the same weights in float32, where bf16 rounding does not mask the
    # scan: kernel against plain version, checked
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = params.float()
    _, k_logits, _, _ = serve(cfg32, params, forced, 1, "cuda", **serve_kw)
    _, r_logits, _, _ = serve(cfg32, params, forced, 1, "ref", **serve_kw)
    ratio32 = replay_ratio(k_logits, r_logits)
    agree32 = (k_logits.argmax(-1) == r_logits.argmax(-1)).float().mean()
    del k_logits, r_logits
    _, k_logits, k_states, check32 = prefill_cuda(cfg32, params, toks, pos)
    info32 = prefill_vs_ref(cfg32, params, toks, pos, k_logits, k_states)
    emit({"phase": "ssm_float32_vs_ref", "replay_max_ratio": max(ratio32),
          "replay_median_ratio": statistics.median(ratio32),
          "replay_greedy_agreement": float(agree32),
          "prefill": {**check32, **info32}})
    check(max(ratio32) < SERVE_TOL, f"float32 ssm cuda engine vs ref engine: "
                                    f"ratio {max(ratio32)}")
    check(info32["logits_rel"] < SERVE_TOL,
          f"float32 prefill cuda vs ref: ratio {info32['logits_rel']}")
    check(info32["h_within_tol_layers"] == cfg.num_layers
          and info32["conv_equal_layer0"],
          f"float32 prefill: h within tolerance on "
          f"{info32['h_within_tol_layers']} of {cfg.num_layers} layers")
    del params, k_states
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    card = device_mod.card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "card": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(k for k, v in logs.items() if v),
          "ptxas": {k: ptxas_summary(v or build_log(k))
                    for k, v in logs.items()}})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for planes in (12, 16):
        codec_case(UNIT, planes, gen, results)
    codec_case(RAGGED, 12, gen, results)
    stencil_cases(gen, results)
    torch.cuda.empty_cache()
    kernels64(gen, results)

    # the float64 paper cell first, while the host's memory is free (the
    # later phases leave some of it cached)
    f64_counts = paper_f64()
    emit({"phase": "launches", "path": "ooc_f64", **f64_counts})
    torch.cuda.empty_cache()

    fields, ref2, sync4, sync_rows = paper_slice()
    torch.cuda.empty_cache()
    counts, bt1 = single_step_dispatch()
    emit({"phase": "launches", "path": "ooc_wave", **counts})
    torch.cuda.empty_cache()
    reset_counts()
    live_counts = live_slice(fields, ref2, sync4, sync_rows, bt1)
    emit({"phase": "launches", "path": "ooc_live", **live_counts})
    for name in ("zfp_encode", "zfp_decode", "wave_multistep", "wave_step"):
        check(live_counts[name] > 0,
              f"the live engine never launched {name}")
    del fields, ref2, sync4, bt1
    torch.cuda.empty_cache()

    live64_counts = live_f64()
    emit({"phase": "launches", "path": "ooc_live_f64", **live64_counts})
    torch.cuda.empty_cache()
    prec_counts = precision_tier()
    emit({"phase": "launches", "path": "precision", **prec_counts})
    torch.cuda.empty_cache()

    cdecode_cases(gen, results)
    cdecode_f64_witness()
    torch.cuda.empty_cache()
    serve_counts = serving_slice()
    emit({"phase": "launches", "path": "serving", **serve_counts})
    torch.cuda.empty_cache()

    sscan_cases(gen, results)
    sscan_f64_witness(gen)
    ssm_counts = ssm_slice()
    emit({"phase": "launches", "path": "ssm_serving", **ssm_counts})

    rows = [
        ("zfp_encode", "zfp_encode", "src/repro/kernels/zfp/kernel.py:90",
         "src/repro_torch/csrc/zfp.cu", (UNIT, 12)),
        ("zfp_decode", "zfp_decode", "src/repro/kernels/zfp/kernel.py:133",
         "src/repro_torch/csrc/zfp.cu", (UNIT, 12)),
        ("wave_step", "wave_step", "src/repro/kernels/stencil/kernel.py:69",
         "src/repro_torch/csrc/stencil.cu", (STEP_PATH, 1)),
        ("wave_multistep", "wave_multistep",
         "src/repro/kernels/stencil/kernel.py:149",
         "src/repro_torch/csrc/stencil.cu", (BLOCK, BT)),
    ]
    rows += [
        ("zfp_encode_f64", "zfp_encode_f64",
         "src/repro/kernels/zfp/kernel.py:90",
         "src/repro_torch/csrc/zfp64.cu", (UNIT, 24)),
        ("zfp_decode_f64", "zfp_decode_f64",
         "src/repro/kernels/zfp/kernel.py:133",
         "src/repro_torch/csrc/zfp64.cu", (UNIT, 24)),
        ("wave_step_f64", "wave_step_f64",
         "src/repro/kernels/stencil/kernel.py:69",
         "src/repro_torch/csrc/stencil64.cu", (PREC_SHAPE, 1)),
        ("wave_multistep_f64", "wave_multistep_f64",
         "src/repro/kernels/stencil/kernel.py:149",
         "src/repro_torch/csrc/stencil64.cu", (BLOCK, BT)),
    ]
    rows.append(("cdecode", "cdecode", "src/repro/kernels/cdecode/kernel.py:90",
                 "src/repro_torch/csrc/cdecode.cu",
                 ((CD_SLOTS, CD_KVH, CTX), (16, CD_LENGTHS[0]))))
    rows.append(("sscan", "sscan", "src/repro/kernels/sscan/kernel.py:66",
                 "src/repro_torch/csrc/sscan.cu",
                 (SSCAN_SHAPES[0], SSCAN_CHUNK)))
    kernels = []
    for name, counter, replaces, source, (shape, arg) in rows:
        r = results[(name, shape, arg)]
        by_path = {"ooc_wave": counts.get(counter, 0),
                   "ooc_live": live_counts.get(counter, 0),
                   "ooc_f64": f64_counts.get(counter, 0),
                   "ooc_live_f64": live64_counts.get(counter, 0),
                   "precision": prec_counts.get(counter, 0),
                   "serving": serve_counts.get(counter, 0),
                   "ssm_serving": ssm_counts.get(counter, 0)}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "shape": [list(shape), arg],
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
            **({k: r[k] for k in ("device_ms", "device_ms_by")}
               if "device_ms" in r else {}),
            **({"launches_per_call": r["launches_per_call"],
                "ms_per": "call"} if "launches_per_call" in r else {}),
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the path")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

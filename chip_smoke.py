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
   32 planes, ndim 1-3, on the unit, on the ragged unit and on the
   precision tier's (96, 96, 96) unit (its inputs from a generator of its
   own), bit for bit, with its device time a launch at the unit and at
   the precision unit (ndim 3), and its ``ptxas`` lines (every instance
   of the encoder and of the decoder must show no spill and no stack
   frame); the single step on
   the block and on the precision tier's in-core shape (random halos),
   the rung at 12 steps on the block and on the precision tier's blocks
   (192, 96, 96) (timed a call of 12 and a launch) and at 5 on the
   ragged unit, bit for bit, the rung's inputs unmodified, with their
   chunk lengths; their ``ptxas`` lines (both stencil kernels must show
   no spill and no stack frame); bounds in bytes or float64 operations
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
5c. checkpoint, restore and recovery of the live engine, the launch
   counts zeroed first (path ``ooc_ckpt``), the snapshots under
   ``build/smoke_ckpt`` (removed after): (a) 1152^3, ndiv 8, bt 12, code
   4, no residency, in a run of its own: sweep, the overlapped cut (raw
   shards), sweep; both fields bit for bit phase 4's two sweeps, the
   transfers the task graph's with ``ckpt_every=1``; restored on the card
   and swept once, bit for bit again; the snapshot's bytes reckoned
   beside the disk's free bytes first (Z cut, whole blocks kept, only if
   one snapshot does not fit); its boundary, drain, shard crc32 and
   write seconds, the load seconds and the cut sweep's wall beside phase
   5b's uncut one. (b) the bt 1 volume at 90% of its working set, a cut
   at both boundaries: the cut pins dirty residents and their snapshot
   D2H runs on the d2h stream; fields bit for bit phase 5's, the transfer
   log (``ckpt`` records included) and the pin and snapshot-flush
   counters the task graph's; the first snapshot restored and swept
   once, bit for bit. (c) ``run`` with a cut a sweep and recovery, under
   a crash at boundary 1 and a shard-write fault healed by retry: bit for
   bit, one rollback, every staging slot back in the pool. (d) a lossy
   checkpoint of (b)'s engine at 16 planes: the raw float32 units through
   the ``zfp.cu`` kernels at ndim 1, the shards byte for byte those the
   plain codec writes from the same leaves, the kernels' decode bit for
   bit the plain one;
5s. the sharded engine, ``ShardedExecutor``, its shards on the one card
   (each an ``AsyncExecutor`` with its own streams, pinned pool and host
   threads; the held slice crossing their compute streams, the unit halo
   leaving its exporter's card on the d2h stream after the encode), the
   launch counts zeroed first (path ``ooc_sharded``): (a) the paper's
   cell, 1152^3, ndiv 8, bt 12, code 4, 2 shards, depth2, 2 sweeps, from
   phase 4's fields (the host's bytes reckoned first): both fields bit
   for bit phase 4's two sweeps, each shard's transfers those of
   ``build_sharded_tasks`` for it, halos included, the wire bytes the
   plan's plus the boundary fetches and the halos' the graph's; (b) the
   bt 1 volume of phase 5 with 4 shards, each with a quarter of 90% of
   the working set: bit for bit phase 5's fields, each shard's transfers
   and residency counters the merged graph's, wave_step once a block a
   sweep; (c) 5bf's float64 cell with 2 shards: bit for bit the float64
   sync engine's two sweeps. Each prints its round walls, device compute,
   crc32 seconds, idle share, the halo count and bytes, and by shard its
   streams' busy time, pinned bytes and host threads;
5t. multi-tenant serving, ``serving.ooc.TenantScheduler``: tenants'
   live engines, each with its own streams, pinned pool and host
   threads, under one shared residency budget, the launch counts zeroed
   first (path ``ooc_tenancy``), the host's bytes reckoned first. (a)
   the latency tenant A, the paper's cell (1152^3, ndiv 8, bt 12, code
   4, depth2, 2 sweeps, priority 10, half its working set reserved,
   phase 4's fields) and the batch tenant B, phase 5's bt 1 volume
   (depth2, 2 sweeps, priority 0, no reserve, phase 5's fields), under
   55% of their working sets: A bit for bit phase 4's two sweeps, B
   phase 5's; each tenant's transfers (flush bytes included) those of
   ``build_tenant_tasks`` for it and its counters the graph's; flushes
   routed in both directions; no deposit of B's pulls A below its
   reserve; every pool whole after ``run()``. By tenant its round
   walls, compute-stream busy time, crc32 seconds on its host threads,
   idle share, hits, evictions, flushes, routed flushes and their
   bytes, pinned bytes and host threads; the card's peak allocation
   beside the budget. (b) the launcher, ``serve.main(["--ooc",
   "--tenants", "3", "--shape", "48", "1152", "1152", "--blocks", "2",
   "--sweeps", "2"])``: tenants depth2, temporal2 and unitgrain, code 2,
   bt 1, budget 1.5 x the largest working set; each tenant's transfers
   and counters the merged graph's, the temporal2 tenant bit for bit a
   solo ``AsyncExecutor`` of its schedule on the same fields (the other
   two solo runs were cut for time). Prints ``tenancy_seconds``;
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
   ``error_curve`` for codes 1-4 in float64 at the paper's rates, on
   (192, 96, 96), ndiv 2, bt 12, 360 sweeps sampled every 30: code 1
   exactly 0, codes 2-4 under ``assert_bounded_growth`` with the long
   tier's ceilings;
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
   to 4 of its 28 layers, with the compressed KV cache at 16 planes, random weights from a seeded
   generator on the card, 8 requests in 8 slots in lockstep (256-token
   prompts, 64 new tokens, greedy) through ``ServeEngine``; wall time,
   tokens/s, cache bytes and the launches of the encode and cdecode
   kernels. The first 192 steps of the same token streams (three chunk
   flushes; all 319 until phases hybrid and embeds joined) are then
   replayed through an engine with the plain versions
   (``backend="ref"``) on the card, whose logits must agree within 5e-2
   of their largest at every step (a replay
   through a raw-cache engine, printed and never checked, was cut to make
   room for phase 5s). On the cuda
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
8. the Mamba-1 selective-scan kernel against the float64 recurrence
   (``ref.selective_scan_f64``, step by step) at the falcon-mamba-7b
   shapes (8 slots, d_inner 8192, N 16): decode (S = 1), the slice's
   prefill (S = 128), prefill at length (S = 4096) and a ragged
   S = 100, each from a non-zero ``h0`` and writing ``h_last`` in place
   over it; ``y`` and ``h_last`` within rtol 1e-4 / atol 1e-5 of it;
   printed beside it (not checked), the float32 plain version's
   distance from float64 and from the kernel, as a share of that bound;
   median kernel and plain times, the kernel's device time a launch
   (profiler), its ``ptxas`` line, and the bound (bytes, float32
   operations, and exponentials at the SFU rate). No single PyTorch call
   computes this function;
9. the SSM slice at full width: falcon-mamba-7b in bfloat16, depth cut
   to 16 of its 64 layers, random
   weights from a seeded generator on the card, 8 requests in 8 slots
   (128-token prompts, 32 new tokens, greedy) through ``ServeEngine``;
   wall time, tokens/s, max |logits| and the sscan launches (one a layer
   a step).
   Then ``prefill`` (``backend="cuda"``) on the same prompts, with every
   layer's scan held to its plain version on the inputs the prefill gave
   it (rtol 1e-4 / atol 1e-5), and against the decode-fed engine's
   states after the prompt (printed). In bfloat16 the streams are
   replayed, teacher-forced, through the plain versions
   (``backend="ref"``) on the card, and the prefill likewise (printed:
   over random bf16 layers the two drift apart by bf16 rounding as
   far as the prefill and the decode-fed engine do); the device time by
   kernel over 32 decode steps from ``torch.profiler``. Last, the same
   weights in float32: the replay and the prefill through the kernel
   against the plain versions, logits within 5e-2 of their largest,
   every layer's ``h`` within the kernel's tolerance;
9m. moe, the MoE family at full width (the launch counts zeroed first,
   path ``moe_serving``): Qwen3-MoE in bfloat16 (d 4096, 128 experts of
   1536, top-8, capacity factor 1.25), depth cut to 4 of its 94 layers,
   the compressed KV cache at 16 planes, random weights from a seeded
   generator on the card (the earlier phases' memory freed first): (a) 8
   requests in 8 slots in lockstep (128-token prompts, 64 new tokens,
   greedy, ``max_len`` 256) through ``ServeEngine`` with the kernels:
   wall, tokens/s, cache bytes, the encode and cdecode launches, and on
   the engine's cache cdecode within 2e-5 of its plain version and the
   flush encode bit for bit, as phase 7; (b) the streams replayed,
   teacher-forced, through the plain versions on the card: per step and
   layer whether the two engines routed each token to the same experts,
   every flip with its score gap (8th against 9th) in each engine and
   the token's largest score difference between them (a flip whose gap
   that difference cannot explain fails the phase; printed: whether the
   flip is clean, no earlier layer of its slot having flipped, and
   within bf16 rounding of the scores, and each layer's score
   differences), and the logits within 5e-2 of their largest on every
   step whose routings all agree; (c) ``moe_ffn`` in float32 on
   layer 0's weights against a float64 oracle (the kept set by a host
   loop over the port's own routing) on the last decode step's 8 tokens
   (no drop) and on the prefill's 1,024 (capacity 80, assignments
   dropped): the kept set exactly, ``y`` within 1e-4 of its largest, two
   calls bit for bit (and two bf16 calls on the prefill's tokens); (d)
   ``prefill`` on the same prompts against the decode-fed engine after
   the prompt (printed); (e) the device time by kernel over 32 steady
   decode steps, the idle share and the expert ``bmm``s' share
   (``torch.profiler`` with input shapes), and the peak allocation;
9h. hybrid, the zamba2 family at full width and depth (the launch counts
   zeroed first, path ``hybrid_serving``): zamba2-2.7b in float32 (54
   Mamba-2 layers in 9 groups, d 2560, 80 SSD heads of 64, N 64, the
   shared attention block after each group; 2.42B parameters, 9.7 GB),
   random weights from a seeded generator on the card: (a) 8 requests in
   8 slots in lockstep (64-token prompts, 32 new tokens, greedy,
   ``max_len`` 128) through ``ServeEngine``: wall, new and fed tokens/s,
   max |logits|; (b) ``prefill`` of the same prompts (SSD at chunk 64)
   against the engine's state after the prompt (fed one token a step,
   chunk 1): the last prompt position's logits, every layer's ``h`` and
   ``conv`` and every group's K/V within 1e-3 of their largest; (c) the
   device time by kernel over 32 steady decode steps and the idle share
   (``torch.profiler``); ``ssd_chunked`` at one layer's shapes (8 slots,
   80 heads of 64, N 64, chunk 64; S 64 and a ragged 100) against the
   recurrence step by step in float64, within 1e-4 of the largest |y| and
   |h_last|; the peak allocation. (d) No kernel of the repo runs on this
   path (the reference's hybrid is XLA): its launch counts must read 0;
9e. embeds, the vision-language and audio front ends at full width
   (the launch counts zeroed before each model, paths ``vlm_decode`` and
   ``audio_decode``): qwen2-vl-7b (d 3584, 28 heads over 4 KV heads of
   128, M-RoPE) and musicgen-medium (d 1536, 24 heads over 24 KV heads of
   64, layernorm), each bf16 with 4 layers (of 28 and 48) over the
   16-plane compressed cache, random weights from a seeded generator: 191
   lockstep steps of ``decode_step`` in 8 slots (as 128 prompt positions
   and 64 new tokens through an engine), fed seeded random embeddings
   (B, 1, d); qwen2-vl's positions (3, B, 1) with the temporal, height
   and width streams p, p // 8 and p % 8 for p < 64, then equal. cdecode
   launched once a layer a step and the ndim-2 encode of K and V a layer
   at each 64-token flush; on the cache after the run cdecode within 2e-5
   of its plain version and the flush encode bit for bit (as phase 7);
   the same steps through the plain versions (``backend="ref"``), the
   logits within 5e-2 of their largest at every step;
10. train, the trainer (the launch counts zeroed first, path ``train``):
   (a) ``launch.train.main`` at the lm-100m preset, 20 steps, gradients
   at 8 planes with error feedback, a checkpoint every 10 under
   ``build/smoke_train`` (removed after), then a second ``main`` resumed
   from step 10's checkpoint: losses and weights after step 20 within
   1e-5 relative of the uninterrupted run's (whether bit for bit is
   printed), the manifest's keys the reference's tree's, the codec's
   launches (ndim 1) the quantized leaves a step times the steps. (b)
   Qwen2-1.5B at full width, float32, 4 of its 28 layers (as phase 7),
   compressed remat (12 planes) and 8-plane gradients with error
   feedback, batch 8 x 512 from ``SyntheticLM(seed=0)``, 3 steps of
   ``make_train_step`` from seeded random weights on the card: step 1's
   loss bit for bit remat none's; every residual step 1 saved (payload
   and emax) and every quantized gradient of step 1 bit for bit the
   plain codec's on the same leaf, on the card; the 3 steps replayed
   from the same weights with ``backend="ref"``, losses and gradient
   norms within 1e-4 relative (the largest weight difference printed);
   encode and decode launches a step the code's count (13 residuals a
   layer, one a quantized leaf). Printed: step walls, tokens/s, the
   device idle share of the last step (``torch.profiler``), residual
   bytes a layer against raw, the peak allocation of one step under
   remat none, full and compressed, step 1's gradient distance
   (compressed against none) by leaf, and the codec's time a launch,
   bound and plain time at the largest residual leaf and at the
   largest gradient leaf (233M values), bit for bit;
10s. train_ssm, training the ssm family (the launch counts zeroed first,
   path ``train_ssm``): the scan's backward kernel at the training shape
   (8, 512, 8192, 16) against float64 autograd of the plain version
   (in channel slices), each gradient within ``SSCAN_BWD_TOL`` of its
   largest value, the forward that saves its states bit for bit the
   forward that does not, both timed beside their bounds and plain
   versions; the backward's kernels (``sscan_bwd_kernel`` and
   ``sum_parts_kernel``) must show no spill and no stack frame, and its
   line carries its residency and the bytes of its partials; (a)
   falcon-mamba-7b at full width, 4 of 64 layers,
   float32, compressed remat, batch 8 x 512, 3 steps of
   ``make_train_step`` from seeded weights: a step launches the scan
   twice a layer and its backward once a layer, two runs bit for bit,
   each step replayed on the plain versions from the same weights and
   AdamW state, losses and gradient norms within 1e-4 relative (a
   replay left to run on by itself leaves the run: AdamW's first steps
   move every weight by about the learning rate, so rounding in a
   gradient's sign moves it by twice that); printed: losses, step
   walls, the last
   step's idle share (``torch.profiler``), the peak allocation; (b)
   zamba2-2.7b at full width, 12 of 54 layers (two groups: the shared
   block's gradient sums two applications), float32, compressed remat,
   2 steps: no scan launch, the shared block trained; (c) one falcon
   step under ``distributed.sharding.use_rules`` on a one-rank (1, 1)
   ``launch.mesh`` mesh (a gloo group of one) bit for bit the step
   without;
11. the kernels line: every kernel with its launches on the main paths
   (the out-of-core wave of phases 4 and 5, the live engine of phase
   5b, its checkpoints of phase 5c, the sharded engine of phase 5s, the
   tenants of phase 5t, the
   float64 paper sweep, live run
   and precision tier of phases 5f, 5bf and 5p, the serving slice of
   phase 7, the SSM slice of phase 9, the MoE slice of phase 9m, the
   hybrid of phase 9h, the front ends of phase 9e and the trainers of
   phases 10 and 10s, each
   counted from zero), its error and times; the float32 codec's rows
   give their launches by ndim, one row for the unit (every path but
   train and train_ssm) and one for the training gradient leaf (those
   two); the scan has a row at the decode shape (the serving paths)
   and one at the training shape (train_ssm), its backward one
   (train_ssm).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import _build  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.core import outofcore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core.executor import (  # noqa: E402
    AsyncExecutor, CheckpointPolicy, RecoveryPolicy,
)
from repro_torch.distributed.fault import (  # noqa: E402
    FaultInjector, FaultPlan, FaultSpec, RetryPolicy,
)
from repro_torch.core.outofcore import (  # noqa: E402
    OOCConfig, OutOfCoreWave, paper_code_fields, to_host,
)
from repro_torch.core.sharded import ShardedExecutor  # noqa: E402
from repro_torch.core.taskgraph import (  # noqa: E402
    build_sharded_tasks, build_sweep_tasks, build_tenant_tasks,
    unit_wire_bytes, wire_totals,
)
from repro_torch.kernels.cdecode import kernel as cdecode_kernel  # noqa: E402
from repro_torch.kernels.cdecode import ops as cdecode_ops  # noqa: E402
from repro_torch.kernels.cdecode import ref as cdecode_ref  # noqa: E402
from repro_torch.kernels.sscan import kernel as sscan_kernel  # noqa: E402
from repro_torch.kernels.sscan import ops as sscan_ops  # noqa: E402
from repro_torch.kernels.sscan import ref as sscan_ref  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import model as lm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.layers import scale_in  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.kernels.stencil import kernel as stencil_kernel  # noqa: E402
from repro_torch.kernels.stencil import ops as stencil_ops  # noqa: E402
from repro_torch.kernels.stencil import ref as stencil_ref  # noqa: E402
from repro_torch.kernels.zfp import kernel as zfp_kernel  # noqa: E402
from repro_torch.kernels.zfp import ops as zfp_ops  # noqa: E402
from repro_torch.kernels.zfp import ref as zfp_ref  # noqa: E402
from repro_torch.core import remat  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

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
UNIT48 = (48, 1152, 1152)  # the float64 engine's other storage unit
RAGGED = (50, 1150, 1149)
BLOCK = (240, 1152, 1152)  # one fetched block, B + 2H planes
# the bt 1 engine's block: B + 2H = 12 + 8 planes of SMALL_Z at ndiv 8
STEP_PATH = (20, 1152, 1152)
SMALL_Z = 96  # phase 5's volume depth (bt=1)
# phase 5b: the live engine
LIVE_SCHEDULE, LIVE_SWEEPS = "depth2", 2
# phase 5s: the sharded engine's shards (4 on the bt 1 volume)
SHARDS = 2
# phase 6: the fused attention kernel at the decode_32k context
CTX = SHAPES["decode_32k"].seq_len
CD_SLOTS, CD_KVH, CD_QPK, CD_D = 16, 2, 6, 128
CD_LENGTHS = (30000, CTX - kvcache.CHUNK, 40)
CD_TOL = 2e-5  # tests/test_cdecode_kernel.py's own bound
# phase 7: the serving slice
SERVE_ARCH, SERVE_PLANES = "qwen2-1.5b", 16
# depth cut to 4 of Qwen2-1.5B's 28 layers (full width): 14 since the float64
# phases joined, 4 since phase 5t did; the smoke keeps within its time limit
# on a slow host
SERVE_LAYERS = 4
SERVE_SLOTS, PROMPT, MAX_NEW, SERVE_MAX_LEN = 8, 256, 64, 1024
SERVE_TOL = 5e-2  # tests/test_kvcache.py's bound against the raw cache
# the plain replay's steps: three chunk flushes (cut from all 319 to keep
# the smoke within its time limit once phases hybrid and embeds joined)
SERVE_REPLAY_STEPS = 3 * kvcache.CHUNK
# phases 8-9: the SSM slice
SSM_ARCH = "falcon-mamba-7b"
# depth cut to 16 of its 64 layers (full width) to pay for phase moe
SSM_LAYERS = 16
SSM_SLOTS, SSM_PROMPT, SSM_NEW = 8, 128, 32
SSM_MAX_LEN = SSM_PROMPT + SSM_NEW
SSCAN_SHAPES = ((8, 1, 8192, 16), (8, 128, 8192, 16), (8, 4096, 8192, 16),
                (8, 100, 8192, 16))  # (B, S, D, N)
SSCAN_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_sscan_kernel.py's bound
SSCAN_CHUNK = 64  # the plain version's chunk (the configs' ssm_chunk)
SSM_WINDOW = (16, 32)  # profiled decode steps: warm-up, then the window
# phase moe: Qwen3-MoE at full width, its depth cut to 4 of 94 layers (as the
# Qwen2 slice's 4 of 28): 11.2B parameters, 22.4 GB in bf16
MOE_ARCH, MOE_LAYERS = "qwen3-moe-235b-a22b", 4
MOE_SLOTS, MOE_PROMPT, MOE_NEW, MOE_MAX_LEN = 8, 128, 64, 256
MOE_WINDOW = (64, 32)  # profiled decode steps: warm-up, then the window
MOE_ORACLE_TOL = 1e-4  # max |y - oracle| / max |oracle|, float32 moe_ffn
BF16_SCORE_ROUNDING = 2.0 ** -8  # a router score's relative bf16 rounding
# the float64 phases: the paper's own type and rates (32/64, 24/64)
F64_PLANES = (24, 32)
F64_RAGGED = (50, 1150, 1149)
F64_LIVE = (288, 576, 576)  # live vs sync: ndiv 2, bt 12, block 144
# the precision tier to 4,320 steps (Fig. 7): 360 sweeps of bt 12; block
# 96 = 2 x the 48-plane halo and y a multiple of 48, so the engine runs
# the multistep kernel
PREC_SHAPE, PREC_NDIV, PREC_SWEEPS, PREC_EVERY = (192, 96, 96), 2, 360, 30
PREC_UNIT = (96, 96, 96)  # its larger storage unit
PREC_UNIT48 = (48, 96, 96)  # its other: 6912 blocks, 32 threads a CTA
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
    return {**events_batch_ms(fn, reps),
            "profiler_keys": [e.key[:60] for e in events][:8]}


def events_batch_ms(fn, reps: int):
    """CUDA events around ``reps`` back-to-back calls of ``fn``, over
    ``reps``: the device time where a launch outlasts the host's call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / reps,
            "device_ms_by": "events_batch"}


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
    """The codec and stencil launch counts, by counter name, the float64
    codec's by counter, unit shape and planes, and the float32 codec's by
    counter and ndim."""
    return {**{f"zfp_{k}": v for k, v in zfp_kernel.launches.items()},
            **{f"zfp_{k}": v for k, v in zfp_kernel.f64_shapes.items()},
            **{f"zfp_{k}": v for k, v in zfp_kernel.f32_ndims.items()},
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
    for bit the plain version. At ndim 3 (the engine's) on the unit and
    the precision unit also the times and the bound: the unit in, payload
    and emax out. Returns the threads a CTA of each (planes, ndim)."""
    x = normal(shape, gen, 7.3, F64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads = {}
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
            threads[(planes, ndim)] = zfp_kernel.f64_threads(emax.numel(),
                                                             sms)
            errs = {"zfp_encode_f64": max(max_abs(payload, rp),
                                          max_abs(emax, re)),
                    "zfp_decode_f64": max_abs(y, ry)}
            del rp, re, ry
            row = {"phase": "kernel_vs_plain_f64", "shape": list(shape),
                   "planes": planes, "ndim": ndim,
                   "stream_order": zfp_kernel.stream_order(planes, ndim, 64),
                   "threads": threads[(planes, ndim)],
                   "encode_bitwise": enc_ok, "decode_bitwise": dec_ok}
            if ndim == 3 and shape in (UNIT, PREC_UNIT):
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
    return threads


def stencil64_cases(gen, results):
    """The float64 single step on random padded fields (a non-zero halo)
    at the block and at the precision tier's in-core shape, and the
    float64 rung at 12 steps on the block and on the precision tier's
    blocks: bit for bit ``ref.wave_step`` and ``ref.ladder_steps``, with
    times and bounds (bytes, or float64 operations at the float64 rate);
    the rung timed a call of 12 steps on the block and one launch at the
    precision shape. Both kernels must show no spill and no stack frame."""
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
              "zlen": stencil_kernel.launch_zlen(pp.device, shape, True),
              "ptxas": kernel_ptxas("stencil64", "wave_step64_kernel")})
        check(ok, f"float64 wave_step differs from its plain version at "
                  f"{shape}")
        del pp, pc, v2, kn, kl, rn, rl
        torch.cuda.empty_cache()
    rung64_case(BLOCK, BT, gen, results)
    rung64_case(PREC_SHAPE, 1, gen, results)
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
    # both stream their planes through registers and shared memory
    for entry in ("wave_step64_kernel", "wave_rung64_kernel"):
        ptxas = kernel_ptxas("stencil64", entry)
        check(len(ptxas) == 1 and ptxas[0].get("spill_stores", 0) == 0
              and ptxas[0].get("stack_frame", 0) == 0,
              f"stencil64 {entry} spills or keeps a stack frame: {ptxas}")


def rung64_case(shape, timed_steps, gen, results):
    """The float64 rung on interior fields of ``shape``: 12 steps (the
    engine's call) bit for bit the ladder with one launch a step, the
    inputs left as they were; then a call of ``timed_steps`` timed
    against its plain version and its bound (3 fields in, p_prev and
    p_cur out, once; one step's p_prev out is its p_cur in)."""
    n = math.prod(shape)
    pp, pc = normal(shape, gen, 1.0, F64), normal(shape, gen, 1.0, F64)
    v2 = 0.05 + 0.01 * normal(shape, gen, 1.0, F64)
    inputs = [t.clone() for t in (pp, pc, v2)]
    rp, rc = stencil_ref.ladder_steps(pp, pc, v2, BT)
    stencil_kernel.reset_launches()
    kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, BT)
    launched = stencil_kernel.launches["wave_multistep_f64"]
    ok = same_bits(kp, rp) and same_bits(kc, rc) and all(
        same_bits(a, b) for a, b in zip((pp, pc, v2), inputs))
    err = max(max_abs(kp, rp), max_abs(kc, rc))
    per_call = launched
    if timed_steps != BT:
        rp, rc = stencil_ref.ladder_steps(pp, pc, v2, timed_steps)
        stencil_kernel.reset_launches()
        kp, kc = stencil_kernel.wave_multistep(pp, pc, v2, timed_steps)
        per_call = stencil_kernel.launches["wave_multistep_f64"]
        ok = ok and same_bits(kp, rp) and same_bits(kc, rc)
        err = max(err, max_abs(kp, rp), max_abs(kc, rc))
    del kp, kc, rp, rc, inputs
    torch.cuda.empty_cache()
    fn = lambda: stencil_kernel.wave_multistep(pp, pc, v2, timed_steps)
    reps = 10 if timed_steps == 1 else 2
    arrays = 3 + min(timed_steps, 2)
    r = {"max_abs_err": err, "ms": median_ms(fn, reps + 1),
         **kernel_device_ms(fn, "wave_rung64_kernel", reps),
         "plain_ms": median_ms(
             lambda: stencil_ref.ladder_steps(pp, pc, v2, timed_steps), 2),
         "bound": bound_ms(arrays * n * 8, STENCIL_FLOPS * n * timed_steps,
                           flop_rate=FP64_FLOP_PER_S),
         "launches_per_call": per_call}
    results[("wave_multistep_f64", shape, timed_steps)] = r
    emit({"phase": "kernel_vs_plain_f64", "kernel": "wave_multistep_f64",
          "shape": list(shape), "steps": BT, "timed_steps": timed_steps,
          "launches_12_steps": launched, "bitwise": ok,
          **{k: v for k, v in r.items() if k != "bound"},
          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
          # what one launch must move: p_prev, p_cur, vel2 in, p_next out
          "bound_ms_a_launch": bound_ms(4 * n * 8, STENCIL_FLOPS * n,
                                        flop_rate=FP64_FLOP_PER_S)[0],
          "zlen": stencil_kernel.launch_zlen(pp.device, shape, False),
          "ptxas": kernel_ptxas("stencil64", "wave_rung64_kernel")})
    check(ok, f"float64 wave_multistep differs from its plain version at "
              f"{shape} or modified its inputs")
    check(launched == BT, f"{launched} float64 rung launches for {BT} steps")
    check(per_call == timed_steps,
          f"{per_call} float64 rung launches for {timed_steps} steps")
    del pp, pc, v2
    torch.cuda.empty_cache()


def kernels64(gen, results):
    """Phase 3f: the float64 codec on the unit, on a ragged shape, on the
    engine's other unit and on the precision tier's two units (these three
    from generators of their own: the phases after keep their inputs),
    the float64 stencil, and the ptxas lines of the float64 kernels."""
    codec64_case(UNIT, gen, results)
    codec64_case(F64_RAGGED, gen, results)
    own = lambda k: torch.Generator(device="cuda").manual_seed(SEED + k)
    codec64_case(PREC_UNIT, own(1), results)
    codec64_case(UNIT48, own(2), results)
    # the precision tier's 48-plane unit is its only one at 32 threads a
    # CTA: held here bit for bit at the engine's ndim 3
    threads48 = codec64_case(PREC_UNIT48, own(3), results)
    check(all(threads48[(planes, 3)] == 32 for planes in F64_PLANES),
          f"the float64 codec takes {threads48} threads a CTA on "
          f"{PREC_UNIT48}, not 32 at ndim 3")
    emit({"phase": "ptxas_f64",
          "zfp64": ptxas_summary(build_log("zfp64")),
          "stencil64": ptxas_summary(build_log("stencil64"))})
    # the codec keeps its block in registers on every route: 13 instances
    # of each kernel ((ndim, order, route) as kernel.f64_route gives them,
    # and the paper's two rates at ndim 3 with compile-time tables)
    for entry in ("encode64_kernel", "decode64_kernel"):
        ptxas = kernel_ptxas("zfp64", entry)
        check(len(ptxas) == 13 and all(
            e.get("spill_stores", 0) == 0 and e.get("stack_frame", 0) == 0
            for e in ptxas), f"zfp64 {entry} spills or keeps a stack frame: "
                             f"{ptxas}")
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


def run_live(cfg, fields, label, cut=None, **kw):
    """Seed the live engine and run LIVE_SWEEPS sweeps, the window open
    across each boundary (drained after the last); ``cut(eng)`` runs at
    each boundary (a checkpoint cut; its seconds in ``cut_s``). Its
    row: the wall of
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
        walls, cuts = [], []
        for k in range(LIVE_SWEEPS):
            ts = time.perf_counter()
            eng.sweep()
            if cut is not None:
                tc = time.perf_counter()
                cut(eng)
                cuts.append(time.perf_counter() - tc)
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
           **({"cut_s": cuts} if cut is not None else {}),
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
    arithmetic, twice. Returns code 4's row."""
    rows = {}
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
        rows[code] = row
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
    return rows[4]


def residency_cell():
    """The bt 1 volume's config, its working set's bytes and the
    residency budget, 90% of them: LRU over a cyclic sweep keeps nothing
    a sweep later below ~80% of the working set (the task graph says
    so); at 90% part of the units hit and the rest are evicted and
    flushed."""
    shape = (SMALL_Z,) + PAPER[1:]
    cfg = OOCConfig(shape, NDIV, 1, paper_code_fields(4))
    _, y, x = shape
    ws = sum(unit_wire_bytes(spec, (hi - lo, y, x), 4)
             for spec in cfg.fields.values()
             for _, _, (lo, hi) in cfg.plan.units())
    return cfg, ws, ws * 9 // 10


def live_residency(fields, want, sync_rows):
    """Write-back residency at (96, 1152, 1152), bt 1, code 4, with 90%
    of the working set's bytes: the transfer records (h2d, d2h,
    flushes) those of the task graph with the same budget, the residency
    counters its, wave_step launched once a block a sweep, and the
    gathered fields ``want``, the bt 1 sync engine's after the same 2
    sweeps from the same ``fields`` (``single_step_dispatch``), bit for
    bit."""
    cfg, ws, budget = residency_cell()
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
    return row


def live_slice(fields, ref2, sync4, sync_rows, bt1):
    """Phase 5b. Returns its launch counts and the rows of live code 4
    and of the residency run (phase 5c's uncut runs)."""
    rows = {"paper": live_paper(fields, ref2, sync4, sync_rows),
            "residency": live_residency(*bt1)}
    return path_counts(), rows


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
# phase 5c: checkpoint, restore and recovery of the live engine
# ----------------------------------------------------------------------

# inside the checkout (``build/`` is not committed); removed after the phase
CKPT_DIR = Path(__file__).resolve().parent / "build" / "smoke_ckpt"


def snapshot_reckoning(cfg):
    """The bytes a raw snapshot of ``cfg``'s store writes, by field: a
    raw unit's float32 planes, a compressed unit's uint32 payload and its
    int32 emax a 4^3 block (the store's leaves), from the plan."""
    _, y, x = cfg.shape
    out = {}
    for name, spec in cfg.fields.items():
        n = 0
        for _, _, (lo, hi) in cfg.plan.units():
            if spec.compressed:
                nb = -(-(hi - lo) // 4) * -(-y // 4) * -(-x // 4)
                n += nb * 4 * (zfp_ref.payload_words(3, spec.planes) + 1)
            else:
                n += (hi - lo) * y * x * 4
        out[name] = n
    out["total"] = sum(out.values())
    return out


def ckpt_log(eng):
    return sorted((t.direction, t.field, t.unit, t.sweep, t.flush, t.ckpt,
                   t.wire_bytes if t.flush or t.ckpt else None)
                  for t in eng.transfers)


def ckpt_model_log(tasks):
    return sorted((t.kind, t.field, t.unit, t.sweep, t.flush, t.ckpt,
                   int(t.amount) if t.flush or t.ckpt else None)
                  for t in tasks if t.kind in ("h2d", "d2h"))


def gathered_equal(eng, want):
    """Each field of ``eng`` bit for bit ``want``'s (numpy or card)."""
    out = {}
    for name, ref in want.items():
        g = eng.gather(name)
        out[name] = (same_bits(torch.from_numpy(g).cuda(), ref)
                     if isinstance(ref, torch.Tensor)
                     else bool(np.array_equal(g, ref)))
        del g
    return out


def ckpt_paper(fields, sync4, uncut):
    """5c (a): the 1152^3 code-4 cell through the live engine with its
    own snapshot: sweep, the overlapped cut (raw shards), sweep, finish;
    both fields bit for bit phase 4's two sweeps, the transfers the task
    graph's with ``ckpt_every=1``; then a restore on the card and one
    sweep, bit for bit again. The snapshot is reckoned first beside the
    disk's free bytes; Z is cut, whole blocks kept, only if one snapshot
    does not fit."""
    cfg = OOCConfig(PAPER, NDIV, BT, paper_code_fields(4))
    root = CKPT_DIR / "paper"
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    need = snapshot_reckoning(cfg)
    z_cut = None
    if free < 1.1 * need["total"]:
        block = PAPER[0] // NDIV
        for n in range(NDIV - 1, 1, -1):
            cfg = OOCConfig((block * n,) + PAPER[1:], n, BT,
                            paper_code_fields(4))
            if free >= 1.1 * snapshot_reckoning(cfg)["total"]:
                break
        z_cut = cfg.shape[0]
        check(free >= 1.1 * snapshot_reckoning(cfg)["total"],
              f"the disk ({free} bytes free) holds no snapshot")
        fields = {k: np.ascontiguousarray(v[:z_cut])
                  for k, v in fields.items()}
        sync = OutOfCoreWave(cfg, fields["p_prev"], fields["p_cur"],
                             fields["vel2"])
        sync.run(LIVE_SWEEPS * BT)
        sync4 = {n: torch.from_numpy(sync.gather(n)).cuda()
                 for n in ("p_prev", "p_cur")}
        del sync
    emit({"phase": "ckpt_paper_reckoning", "shape": list(cfg.shape),
          "snapshot_bytes": need, "disk_free_bytes": free,
          "z_cut": z_cut, "reason": None if z_cut is None else
          "the disk cannot hold one snapshot of 1152^3",
          "cut_snapshot_bytes": None if z_cut is None
          else snapshot_reckoning(cfg)})

    def cut(eng):
        if eng.sweeps_done == 1:
            eng.begin_checkpoint(str(root), zstd_level=0, keep=1)

    eng, row = run_live(cfg, fields, "ckpt_paper", cut=cut)
    st = eng.stats()["checkpoint"]
    tasks = build_sweep_tasks(cfg, sweeps=LIVE_SWEEPS,
                              schedule=LIVE_SCHEDULE, ckpt_every=1)
    same_log = ckpt_model_log(tasks) == ckpt_log(eng)
    path = eng.last_checkpoint_path
    eng.close()
    cut_bits = gathered_equal(eng, sync4)
    del eng
    gc.collect()
    t0 = time.perf_counter()
    back = AsyncExecutor.restore(str(root), device="cuda", backend="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back.sweep()
    back.finish()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    back.close()
    back_bits = gathered_equal(back, sync4)
    restored_at = back.sweeps_done - 1
    del back
    gc.collect()
    shutil.rmtree(root)
    row.update(
        snapshot_bytes=need["total"], shard_bytes=st["shard_bytes"],
        boundary_block_s=row["cut_s"][0], drain_s=st["drain_s"],
        snapshot_s=row["cut_s"][0] + st["drain_s"],
        shard_crc32_s=st["shard_crc32_s"], shard_write_s=st["shard_write_s"],
        load_s=t1 - t0, restored_sweep_s=t2 - t1,
        cut_sweep_wall_s=row["sweep_wall_s"][1],
        uncut_sweep_wall_s=uncut["sweep_wall_s"][1] if z_cut is None
        else None,
        transfers_equal_graph=same_log, bitwise_sync=cut_bits,
        restored_bitwise_sync=back_bits, checkpoint=Path(path).name)
    emit(row)
    check(st["overlapped"] == 1 and Path(path).name == "step_0000000001",
          f"5c (a): no snapshot was published at boundary 1: {st}")
    check(same_log, "5c (a): transfers differ from the task graph")
    check(all(cut_bits.values()), f"5c (a): cut run differs: {cut_bits}")
    check(restored_at == 1 and all(back_bits.values()),
          f"5c (a): restored run differs: {back_bits}")


def ckpt_residency(fields, want, uncut):
    """5c (b)-(d) on the bt 1 volume at 90% of its working set. (b):
    sweep, the overlapped cut, sweep, the cut again, finish: the cut pins
    dirty residents and their snapshot D2H runs on the d2h stream; the
    fields ``want`` bit for bit, the transfer log with its ``ckpt``
    records and the pin and snapshot-flush counters the task graph's with
    ``ckpt_every=1``; the first snapshot restored and swept once, bit for
    bit. (c): ``run`` with periodic cuts and recovery under a crash at
    boundary 1 and a shard-write fault healed by retry: bit for bit, one
    rollback, the pool whole. (d): a lossy checkpoint (16 planes) of the
    (b) engine codes its raw float32 units with the ``zfp.cu`` kernels at
    ndim 1: shards byte for byte those the plain codec writes from the
    same leaves on the CPU, and the kernels' decode bit for bit the plain
    codec's (run on the card)."""
    cfg, ws, budget = residency_cell()
    root = CKPT_DIR / "residency"

    def cut(eng):
        eng.begin_checkpoint(str(root), zstd_level=0, keep=2)

    eng, row = run_live(cfg, fields, "ckpt_residency", cut=cut,
                        cache_bytes=budget)
    stats = {}
    tasks = build_sweep_tasks(cfg, sweeps=LIVE_SWEEPS,
                              schedule=LIVE_SCHEDULE, cache_bytes=budget,
                              policy="write-back", ckpt_every=1, stats=stats)
    cache = eng.stats()["cache"]
    same_log = ckpt_model_log(tasks) == ckpt_log(eng)
    counters = ("pins", "pin_releases", "cow_shadows", "ckpt_flushes",
                "ckpt_flush_wire_bytes", "hits", "evictions", "flushes")
    same_cache = {k: cache[k] == stats[k] for k in counters}
    ckpt_d2h = sum(t.ckpt for t in eng.transfers)
    st = eng.stats()["checkpoint"]
    bits = gathered_equal(eng, want)
    back = AsyncExecutor.restore(str(root / "step_0000000001"),
                                 device="cuda", backend="cuda")
    back.sweep()
    back.close()
    back_bits = gathered_equal(back, want)
    del back
    row.update(budget_bytes=budget, working_set_bytes=ws,
               cache={k: cache[k] for k in counters},
               ckpt_d2h_records=ckpt_d2h, boundary_block_s=row["cut_s"],
               drain_s=st["drain_s"], shard_bytes=st["shard_bytes"],
               shard_crc32_s=st["shard_crc32_s"],
               shard_write_s=st["shard_write_s"],
               cut_sweep_wall_s=row["sweep_wall_s"][1],
               uncut_sweep_wall_s=uncut["sweep_wall_s"][1],
               transfers_equal_graph=same_log, cache_equal_graph=same_cache,
               bitwise_sync=bits, restored_bitwise_sync=back_bits)
    emit(row)
    check(cache["pins"] > 0 and ckpt_d2h == cache["ckpt_flushes"] > 0,
          f"5c (b): the cut pinned nothing: {cache}")
    check(same_log and all(same_cache.values()),
          f"5c (b): transfers or counters differ from the graph: "
          f"{same_cache}")
    check(all(bits.values()) and all(back_bits.values()),
          f"5c (b): differs from the sync engine: {bits} {back_bits}")
    lossy_leaves(eng)
    eng.close()
    del eng
    recovery(cfg, fields, want, budget)
    shutil.rmtree(CKPT_DIR)


def plain_leaf_decode(path, entry):
    """A raw lossy shard (``zfp+raw``: block count, uint32 payload, int16
    emax) decoded by the plain codec on the card."""
    blob = (path / entry["file"]).read_bytes()
    n, w = int.from_bytes(blob[:8], "little"), entry["payload_words"]
    payload = np.frombuffer(blob[8:8 + n * w * 4], np.int32).reshape(n, w)
    emax = np.frombuffer(blob[8 + n * w * 4:], np.int16).astype(np.int32)
    size = math.prod(entry["shape"])
    c = zfp_ref.Compressed(
        torch.from_numpy(payload.copy()).cuda().view(torch.uint32),
        torch.from_numpy(emax).cuda(), (-(-size // 4) * 4,),
        entry["planes"], 1, "float32")
    out = zfp_ops.decompress(c, backend="ref").cpu().numpy()
    return out[:size].reshape(entry["shape"])


def lossy_leaves(eng):
    """5c (d), on the engine of (b) after its run."""
    before = dict(zfp_kernel.f32_ndims)
    t0 = time.perf_counter()
    path = Path(eng.checkpoint(str(CKPT_DIR / "lossy"), lossy_planes=16,
                               zstd_level=0))
    t1 = time.perf_counter()
    encodes = zfp_kernel.f32_ndims["encode ndim1"] - before.get(
        "encode ndim1", 0)
    leaves, _ = eng.store.state_dict()
    plain = Path(ckpt.save(str(CKPT_DIR / "lossy_plain"), eng.sweeps_done,
                           leaves, lossy_planes=16, zstd_level=0,
                           device="cpu"))
    t2 = time.perf_counter()
    names = sorted(f.name for f in path.iterdir() if f.name != "manifest.json")
    same_files = names == sorted(f.name for f in plain.iterdir()
                                 if f.name != "manifest.json") and all(
        (path / n).read_bytes() == (plain / n).read_bytes() for n in names)
    table = ckpt.read_manifest(str(path))["leaves"]
    same_table = table == ckpt.read_manifest(str(plain))["leaves"]
    lossy = [k for k, e in table.items() if e["codec"].startswith("zfp+")]
    t3 = time.perf_counter()
    _, kernel_out, _ = ckpt.load(str(path), device="cuda")
    t4 = time.perf_counter()
    decodes = zfp_kernel.f32_ndims["decode ndim1"] - before.get(
        "decode ndim1", 0)
    same_decode = all(np.array_equal(
        kernel_out[k].view(np.uint8),
        plain_leaf_decode(path, table[k]).view(np.uint8)) for k in lossy)
    t5 = time.perf_counter()
    err = max((float(np.abs(kernel_out[k] - leaves[k]).max())
               for k in lossy), default=None)
    emit({"phase": "ckpt_lossy", "planes": 16, "lossy_leaves": len(lossy),
          "lossy_values": sum(int(np.prod(table[k]["shape"]))
                              for k in lossy),
          "encode_ndim1_launches": encodes, "decode_ndim1_launches": decodes,
          "shards_equal_plain": same_files, "table_equal_plain": same_table,
          "decode_equal_plain": same_decode, "max_abs_err": err,
          "kernel_save_s": t1 - t0, "plain_save_s": t2 - t1,
          "kernel_load_s": t4 - t3, "plain_decode_card_s": t5 - t4})
    check(lossy and encodes == decodes == len(lossy),
          f"5c (d): {encodes} encodes, {decodes} decodes for "
          f"{len(lossy)} lossy leaves")
    check(same_files and same_table,
          "5c (d): the kernels' lossy shards differ from the plain codec's")
    check(same_decode, "5c (d): the kernels' decode differs from the plain")


def recovery(cfg, fields, want, budget):
    """5c (c)."""
    root = CKPT_DIR / "recovery"
    plan = FaultPlan([FaultSpec(kind="crash", sweep=1),
                      FaultSpec(kind="shard", field="p_cur", unit="R0")])
    eng = AsyncExecutor(cfg, fields["p_prev"], fields["p_cur"],
                        fields["vel2"], schedule=LIVE_SCHEDULE,
                        cache_bytes=budget, retry=RetryPolicy(attempts=2),
                        injector=FaultInjector(plan))
    t0 = time.perf_counter()
    eng.run(LIVE_SWEEPS, ckpt_policy=CheckpointPolicy(
        str(root), every_sweeps=1, zstd_level=0),
        recovery=RecoveryPolicy(str(root), zstd_level=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    whole = st["lanes"]["free_slots"] == len(eng.lanes._slots)
    eng.close()
    bits = gathered_equal(eng, want)
    log = [dict(e, checkpoint=Path(e["checkpoint"]).name)
           for e in eng.recovery_log]
    emit({"phase": "ckpt_recovery", "wall_s": wall, "recovery_log": log,
          "injected": st["injected"],
          "recoveries": st["cache"]["recoveries"],
          "replayed_sweeps": st["cache"]["replayed_sweeps"],
          "shard_retries": st["cache"]["shard_retries"],
          "checkpoint": st["checkpoint"], "pool_whole": whole,
          "bitwise_sync": bits})
    check(len(log) == 1 and st["cache"]["recoveries"] == 1
          and st["injected"].get("crashes") == 1,
          f"5c (c): expected one rollback: {log}")
    check(st["cache"]["shard_retries"] > 0, "5c (c): no shard write retried")
    check(whole, "5c (c): staging slots still held after the run")
    check(all(bits.values()), f"5c (c): differs from the sync engine: {bits}")


def ckpt_slice(fields, sync4, bt1, uncut_rows):
    """Phase 5c. Returns its launch counts."""
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ckpt_paper(fields, sync4, uncut_rows["paper"])
    torch.cuda.empty_cache()
    ckpt_residency(bt1[0], bt1[1], uncut_rows["residency"])
    return path_counts()


# ----------------------------------------------------------------------
# phase 5s: the sharded engine (ShardedExecutor), its shards on one card
# ----------------------------------------------------------------------


def run_sharded(cfg, fields, label, nshards, **kw):
    """Seed the sharded engine (``nshards`` shards on the card, each an
    ``AsyncExecutor`` with its own streams, pool and host threads) and
    run LIVE_SWEEPS rounds of one sweep, the windows open across each
    boundary (drained after the last). Its row: each round's wall (host
    clock; the last includes the drain), device compute (events around
    the codec and stencil calls, on the shards' compute streams), crc32
    seconds on the host threads and on the caller's thread, the idle
    share (1 - device compute / wall), the halo count and bytes, and by
    shard its blocks, its streams' busy seconds, pinned bytes, host
    threads, host-job and wait seconds and window peak."""
    clock = DeviceClock()
    try:
        t0 = time.perf_counter()
        eng = ShardedExecutor(cfg, fields["p_prev"], fields["p_cur"],
                              fields["vel2"], nshards=nshards,
                              schedule=LIVE_SCHEDULE, **kw)
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
    summary = eng.transfer_summary()
    shards = []
    for spec, ex in zip(eng.specs, eng.shards):
        st = ex.stats()
        shards.append({
            "index": spec.index, "blocks": [spec.block_lo, spec.block_hi],
            "device": str(ex.device), "stream_busy_s": ex.lanes.busy_s(),
            "pinned_bytes": st["lanes"]["pinned_bytes"],
            "host_threads": ex.lanes.threads,
            "host_job_s": st["lanes"]["host_job_s"],
            "host_wait_s": st["lanes"]["host_wait_s"],
            "crc32_wait_s": st["lanes"]["crc_wait_s"],
            "max_inflight": st["max_inflight"],
            "halo_count": st["cache"]["halo_count"],
            "halo_wire_bytes": st["cache"]["halo_wire_bytes"],
        })
        check(st["lanes"]["streams"] == 3
              and st["lanes"]["pinned_bytes"] > 0,
              f"{label} shard {spec.index}: not on three streams with "
              f"pinned staging")
    computes = {ex.lanes.streams["compute"].cuda_stream for ex in eng.shards}
    check(len(computes) == nshards,
          f"{label}: the shards share a compute stream")
    row = {"phase": label, "engine": "sharded", "nshards": nshards,
           "schedule": LIVE_SCHEDULE, "shape": list(cfg.shape), "bt": cfg.bt,
           "dtype": cfg.dtype, "sweeps": LIVE_SWEEPS, "seed_s": t1 - t0,
           "sweep_wall_s": walls, "wall_s": wall, "device_compute_s": dev,
           "crc32_thread_s": thr, "crc32_caller_s": crc,
           "idle_share": 1.0 - dev / wall,
           "halo_count": summary["halo_count"],
           "halo_raw_bytes": summary["halo_raw"],
           "halo_wire_bytes": summary["halo_wire"],
           "pinned_bytes": sum(r["pinned_bytes"] for r in shards),
           "host_threads": sum(r["host_threads"] for r in shards),
           "shards": shards,
           "transfer_summary": {k: v for k, v in summary.items()
                                if k != "per_device"}}
    return eng, row


def sharded_logs(eng, tasks):
    """Each shard's transfer log and the merged graph's tasks of that
    shard (halos included; flush and halo records with their bytes)."""
    live = [sorted((t.direction, t.field, t.unit, t.sweep, t.flush,
                    t.wire_bytes if t.flush or t.direction == "halo"
                    else None) for t in ex.transfers)
            for ex in eng.shards]
    model = [sorted((t.kind, t.field, t.unit, t.sweep, t.flush,
                     int(t.amount) if t.flush or t.kind == "halo" else None)
                    for t in tasks if t.kind in ("h2d", "d2h", "halo")
                    and t.resource.startswith(f"s{d}:"))
             for d in range(eng.nshards)]
    return live, model


def boundary_fetch_wire(cfg, specs):
    """The wire bytes a round adds to the plan's: each non-first shard's
    first block fetches its left common, which one engine carries."""
    _, y, x = cfg.shape
    itemsize = np.dtype(cfg.dtype).itemsize
    n = 0
    for spec in specs[1:]:
        lo, hi = cfg.plan.common(spec.block_lo - 1)
        n += sum(unit_wire_bytes(sp, (hi - lo, y, x), itemsize)
                 for sp in cfg.fields.values())
    return n


def sharded_paper(fields, sync4, live_row):
    """5s (a): the paper's cell, 1152^3, ndiv 8, bt 12, code 4, through
    ``ShardedExecutor`` with 2 shards on the card, depth2, 2 sweeps; both
    fields bit for bit phase 4's two sweeps (``sync4``), each shard's
    transfers those of ``build_sharded_tasks`` for it, halos included,
    and the wire bytes the plan's plus the boundary fetches, and the
    halos' the graph's. The host's bytes are reckoned first."""
    cfg = OOCConfig(PAPER, NDIV, BT, paper_code_fields(4))
    field = math.prod(PAPER) * 4
    store = sum(unit_wire_bytes(spec, (hi - lo,) + PAPER[1:], 4)
                for spec in cfg.fields.values()
                for _, _, (lo, hi) in cfg.plan.units())
    # each shard's pool is the single engine's, and a shard's first
    # block fetches one unit a field more: one slot each, of the
    # largest unit's raw bytes
    slot = max(hi - lo for _, _, (lo, hi) in cfg.plan.units()) * (
        PAPER[1] * PAPER[2] * 4)
    pinned = (SHARDS * live_row["pinned_bytes"]
              + (SHARDS - 1) * len(cfg.fields) * slot)
    avail = mem_available()
    # the fields held, the stores, the pools, a gathered field
    need = store + pinned + field
    emit({"phase": "sharded_host_bytes", "fields_bytes": 3 * field,
          "store_bytes": store, "pinned_bytes_estimate": pinned,
          "gathered_bytes": field, "need_bytes": need,
          "mem_available_bytes": avail})
    check(need <= 0.85 * avail, "5s (a) does not fit the host")
    eng, row = run_sharded(cfg, fields, "sharded_paper", SHARDS)
    tasks = build_sharded_tasks(cfg, SHARDS, sweeps=LIVE_SWEEPS,
                                schedule=LIVE_SCHEDULE)
    live, model = sharded_logs(eng, tasks)
    summary = eng.transfer_summary()
    plan = {k: LIVE_SWEEPS * v for k, v in expected_summary(cfg).items()}
    extra = LIVE_SWEEPS * boundary_fetch_wire(cfg, eng.specs)
    wire = {"h2d": summary["h2d_wire"] == plan["h2d_wire"] + extra,
            "d2h": summary["d2h_wire"] == plan["d2h_wire"],
            "halo": summary["halo_wire"] == sum(
                int(t.amount) for t in tasks if t.kind == "halo")}
    eng.close()
    bits = gathered_equal(eng, sync4)
    row.update(transfers_equal_graph=[a == b for a, b in zip(live, model)],
               wire_equal_plan=wire, boundary_fetch_wire=extra,
               bitwise_sync=bits, live_sweep_wall_s=live_row["sweep_wall_s"])
    emit(row)
    check(all(row["transfers_equal_graph"]),
          "5s (a): a shard's transfers differ from the sharded graph")
    check(all(wire.values()), f"5s (a): wire bytes off the plan: {wire}")
    check(row["halo_count"] > 0, "5s (a): no halo crossed")
    check(all(bits.values()), f"5s (a): differs from the sync engine: {bits}")


def sharded_residency(fields, want):
    """5s (b): the bt 1 volume of phase 5 with 4 shards on the card, each
    with a quarter of 90% of the working set's bytes: the fields ``want``
    (phase 5's bt 1 sync engine) bit for bit, each shard's residency
    counters and transfers those of the merged graph for it, wave_step
    launched once a block a sweep."""
    cfg, ws, budget = residency_cell()
    nshards = 4
    before = stencil_kernel.launches["wave_step"]
    eng, row = run_sharded(cfg, fields, "sharded_residency", nshards,
                           cache_bytes=budget // nshards)
    steps = stencil_kernel.launches["wave_step"] - before
    stats = {}
    tasks = build_sharded_tasks(cfg, nshards, sweeps=LIVE_SWEEPS,
                                schedule=LIVE_SCHEDULE,
                                cache_bytes=budget // nshards,
                                policy="write-back", stats=stats)
    live, model = sharded_logs(eng, tasks)
    keys = ("hits", "evictions", "flushes", "d2h_elided")
    caches = [ex.stats()["cache"] for ex in eng.shards]
    same_cache = [all(c[k] == stats["per_device"][d][k] for k in keys)
                  for d, c in enumerate(caches)]
    eng.close()
    bits = gathered_equal(eng, want)
    row.update(budget_bytes=budget, working_set_bytes=ws,
               cache=[{k: c[k] for k in keys} for c in caches],
               transfers_equal_graph=[a == b for a, b in zip(live, model)],
               cache_equal_graph=same_cache, wave_step_launches=steps,
               bitwise_sync=bits)
    emit(row)
    check(steps == LIVE_SWEEPS * NDIV,
          f"5s (b): wave_step launched {steps} times")
    check(all(row["transfers_equal_graph"]) and all(same_cache),
          "5s (b): transfers or counters differ from the sharded graph")
    check(sum(c["hits"] for c in caches) > 0,
          "5s (b): the budgets kept nothing")
    check(all(bits.values()), f"5s (b): differs from the sync engine: {bits}")


def sharded_f64(want):
    """5s (c): the float64 cell of phase 5bf, (288, 576, 576), ndiv 2,
    bt 12, code 4 at 24/64, with 2 shards (one block each): bit for bit
    ``want``, the sync engine's two sweeps from the same fields (5bf
    holds its live engine to the same), transfers the graph's."""
    cfg = OOCConfig(F64_LIVE, 2, BT, paper_code_fields(4, f32=False),
                    dtype="float64")
    fields = initial_fields(F64_LIVE, torch.float64)
    eng, row = run_sharded(cfg, fields, "sharded_f64", SHARDS)
    tasks = build_sharded_tasks(cfg, SHARDS, sweeps=LIVE_SWEEPS,
                                schedule=LIVE_SCHEDULE)
    live, model = sharded_logs(eng, tasks)
    eng.close()
    bits = gathered_equal(eng, want)
    row.update(transfers_equal_graph=[a == b for a, b in zip(live, model)],
               bitwise_sync=bits)
    emit(row)
    check(all(row["transfers_equal_graph"]),
          "5s (c): a shard's transfers differ from the sharded graph")
    check(all(bits.values()), f"5s (c): differs from the sync engine: {bits}")


def f64_live_reference():
    """The float64 sync engine's two sweeps at F64_LIVE (5bf's reference),
    for 5s (c)."""
    cfg = OOCConfig(F64_LIVE, 2, BT, paper_code_fields(4, f32=False),
                    dtype="float64")
    fields = initial_fields(F64_LIVE, torch.float64)
    sync = OutOfCoreWave(cfg, fields["p_prev"], fields["p_cur"],
                         fields["vel2"])
    sync.run(LIVE_SWEEPS * BT)
    return {n: sync.gather(n) for n in ("p_prev", "p_cur", "vel2")}


def sharded_slice(fields, sync4, bt1, live_rows):
    """Phase 5s. Prints its seconds (host clock, references included);
    returns its launch counts (path ``ooc_sharded``)."""
    t0 = time.perf_counter()
    want64 = f64_live_reference()
    torch.cuda.empty_cache()
    reset_counts()
    sharded_paper(fields, sync4, live_rows["paper"])
    torch.cuda.empty_cache()
    sharded_residency(bt1[0], bt1[1])
    torch.cuda.empty_cache()
    sharded_f64(want64)
    emit({"phase": "sharded_seconds", "seconds": time.perf_counter() - t0})
    return path_counts()


# ----------------------------------------------------------------------
# phase 5t: multi-tenant serving (TenantScheduler on the card)
# ----------------------------------------------------------------------

# 55% of the two tenants' working sets: the merged graph routes flushes
# both ways here (at 50% A's deposits evict B's entries, and B's never
# reach past its own slack to A's burst)
TENANT_BUDGET = (11, 20)


def route_counter(sched):
    """Wrap each tenant view's router: the routed flushes counted by
    (depositor, victim), with their bytes."""
    counts = collections.Counter()
    nbytes = collections.Counter()
    route = sched._route_flush
    current = {"who": None}

    def counted(tenant, key, ent):
        counts[(current["who"], tenant)] += 1
        nbytes[(current["who"], tenant)] += ent.nbytes
        route(tenant, key, ent)

    for name, run in sched.tenants.items():
        run.executor.cache.router = counted
    return counts, nbytes, current


def reserve_guard(sched):
    """Wrap the shared manager's deposit: after every deposit of one
    tenant, every other tenant holds at least min(its reserve, what it
    held before). Returns the list of violations (empty when held)."""
    mgr = sched.manager
    deposit = mgr.deposit
    broken = []

    def guarded(key, *a, **kw):
        before = dict(mgr.tenant_bytes)
        res = deposit(key, *a, **kw)
        for t, b in mgr.tenant_bytes.items():
            if t != key[0]:
                floor = min(mgr.arbiter.reserve_of(t), before.get(t, 0))
                if b < floor:
                    broken.append((key[0], t, b, floor))
        return res

    mgr.deposit = guarded
    return broken


def run_tenants(sched, label):
    """Run every tenant to its target through ``sched.run()``, timed:
    each round's wall by tenant (host clock around ``advance_round``),
    the whole run's wall (with the drains), each tenant's compute-stream
    busy seconds, crc32 seconds on its host threads, idle share (1 -
    busy / its rounds' walls), residency counters, routed flushes and
    bytes, pinned bytes and host threads; the card's peak allocation.
    Returns the row and the routed-flush counts by (depositor,
    victim)."""
    counts, nbytes, current = route_counter(sched)
    walls = collections.defaultdict(list)
    for name, run in sched.tenants.items():
        advance = run.executor.advance_round

        def timed(target, _advance=advance, _name=name):
            current["who"] = _name
            t0 = time.perf_counter()
            try:
                return _advance(target)
            finally:
                walls[_name].append(time.perf_counter() - t0)
                current["who"] = None

        run.executor.advance_round = timed
    crc = collections.Counter()
    lock = threading.Lock()
    digest = outofcore.unit_checksum

    def counted_crc(*a, **kw):
        t0 = time.perf_counter()
        try:
            return digest(*a, **kw)
        finally:
            with lock:
                crc[threading.get_ident()] += time.perf_counter() - t0

    outofcore.unit_checksum = counted_crc
    torch.cuda.reset_peak_memory_stats()
    clock = DeviceClock()
    try:
        t0 = time.perf_counter()
        sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dev = clock.device_s()
    finally:
        clock.restore()
        outofcore.unit_checksum = digest
    peak = torch.cuda.max_memory_allocated()
    st = sched.stats()
    tenants = {}
    for name, run in sched.tenants.items():
        ex = run.executor
        busy = ex.lanes.busy_s()
        threads = {t.ident for t in ex.lanes._pool._threads}
        ts = st["per_tenant"][name]
        routed_in = {d: c for (d, v), c in counts.items() if v == name}
        tenants[name] = {
            "shape": list(ex.cfg.shape), "bt": ex.cfg.bt,
            "schedule": run.spec.schedule, "sweeps": ex.sweeps_done,
            "reserve": run.spec.reserve, "priority": run.spec.priority,
            "round_wall_s": walls[name], "stream_busy_s": busy,
            "crc32_thread_s": sum(v for k, v in crc.items()
                                  if k in threads),
            "idle_share": 1.0 - busy["compute"] / sum(walls[name]),
            **{k: ts[k] for k in ("hits", "misses", "evictions",
                                  "flushes", "flush_wire_bytes",
                                  "d2h_elided", "peak_bytes")},
            "routed_flushes_in": sum(routed_in.values()),
            "routed_flush_bytes_in": sum(
                b for (d, v), b in nbytes.items() if v == name),
            "pinned_bytes": ex.lanes.pinned_bytes,
            "host_threads": ex.lanes.threads,
            "free_slots": ex.lanes.free_slots,
            "slots": len(ex.lanes._slots),
        }
    row = {"phase": label, "engine": "tenants", "wall_s": wall,
           "device_compute_s": dev,
           "crc32_caller_s": crc.get(threading.get_ident(), 0.0),
           "idle_share": 1.0 - dev / wall,
           "budget_bytes": sched.budget_bytes,
           "peak_bytes": st["peak_bytes"],
           "cuda_max_memory_allocated": peak,
           "routed": {f"{d}->{v}": c for (d, v), c in counts.items()},
           "tenants": tenants}
    for name, t in tenants.items():
        check(t["free_slots"] == t["slots"],
              f"{label}: tenant {name}'s pool is not whole after run()")
    streams = {run.executor.lanes.streams["compute"].cuda_stream
               for run in sched.tenants.values()}
    check(len(streams) == len(sched.tenants),
          f"{label}: the tenants share a compute stream")
    return row, counts


def tenant_parity(sched, budget):
    """Each tenant's transfer log against the merged graph's tasks of
    that tenant, and its residency counters against the graph's."""
    stats = {}
    tasks = build_tenant_tasks(sched.specs(), budget_bytes=budget,
                               stats=stats)
    per = sched.stats()["per_tenant"]
    keys = ("hits", "misses", "evictions", "flushes", "flush_wire_bytes",
            "d2h_elided", "peak_bytes")
    out = {}
    for name in sched.tenants:
        mine = [t for t in tasks if t.tenant == name]
        out[name] = {
            "transfers_equal_graph":
                model_log(mine) == live_log(sched.tenants[name].executor),
            "counters_equal_graph": all(
                per[name][k] == stats["per_tenant"][name][k]
                for k in keys),
        }
    routed = collections.Counter(
        (t.tid.split("/")[0], t.tenant) for t in tasks
        if t.flush and t.tid.split("/")[0] != t.tenant)
    return out, routed


def tenants_contending(fields, sync4, bt1, live_rows):
    """5t (a): the paper's cell as the latency tenant and phase 5's bt 1
    volume as the batch tenant under 55% of their working sets."""
    from repro_torch.core.tenancy import working_set_bytes
    from repro_torch.serving.ooc import TenantScheduler

    cfg_a = OOCConfig(PAPER, NDIV, BT, paper_code_fields(4))
    cfg_b, _, _ = residency_cell()
    ws_a = working_set_bytes(cfg_a, LIVE_SCHEDULE)
    ws_b = working_set_bytes(cfg_b, LIVE_SCHEDULE)
    num, den = TENANT_BUDGET
    budget = (ws_a + ws_b) * num // den
    # the host: both stores, both pools, a gathered field
    store = sum(unit_wire_bytes(spec, (hi - lo,) + c.shape[1:], 4)
                for c in (cfg_a, cfg_b) for spec in c.fields.values()
                for _, _, (lo, hi) in c.plan.units())
    pinned = (live_rows["paper"]["pinned_bytes"]
              + live_rows["residency"]["pinned_bytes"])
    field = math.prod(PAPER) * 4
    need = store + pinned + field
    avail = mem_available()
    emit({"phase": "tenancy_host_bytes", "store_bytes": store,
          "pinned_bytes_estimate": pinned, "gathered_bytes": field,
          "need_bytes": need, "mem_available_bytes": avail,
          "working_set_bytes": {"A": ws_a, "B": ws_b},
          "budget_bytes": budget})
    check(need <= 0.85 * avail, "5t (a) does not fit the host")
    t0 = time.perf_counter()
    sched = TenantScheduler(budget)
    sched.submit("A", cfg_a, fields["p_prev"], fields["p_cur"],
                 fields["vel2"], schedule=LIVE_SCHEDULE,
                 sweeps=LIVE_SWEEPS, reserve=ws_a // 2, priority=10)
    b_fields, b_want, _ = bt1
    sched.submit("B", cfg_b, b_fields["p_prev"], b_fields["p_cur"],
                 b_fields["vel2"], schedule=LIVE_SCHEDULE,
                 sweeps=LIVE_SWEEPS, reserve=0, priority=0)
    seed_s = time.perf_counter() - t0
    broken = reserve_guard(sched)
    row, routed = run_tenants(sched, "tenancy_contending")
    parity, modelled = tenant_parity(sched, budget)
    for run in sched.tenants.values():
        run.executor.close()
    t0 = time.perf_counter()
    bits = {"A": gathered_tenant(sched, "A", sync4),
            "B": gathered_tenant(sched, "B", b_want)}
    row.update(seed_s=seed_s, gather_s=time.perf_counter() - t0,
               parity=parity, routed_graph={
        f"{d}->{v}": c for (d, v), c in modelled.items()},
        reserve_held=not broken, bitwise=bits)
    emit(row)
    check(all(p["transfers_equal_graph"] and p["counters_equal_graph"]
              for p in parity.values()),
          f"5t (a): transfers or counters differ from the graph: {parity}")
    check(routed == modelled, f"5t (a): routed flushes {dict(routed)} != "
                              f"the graph's {dict(modelled)}")
    check(routed.get(("A", "B"), 0) > 0 and routed.get(("B", "A"), 0) > 0,
          f"5t (a): flushes not routed both ways: {dict(routed)}")
    check(not broken, f"5t (a): a deposit broke a reserve: {broken[:3]}")
    check(all(all(b.values()) for b in bits.values()),
          f"5t (a): a tenant differs from its reference: {bits}")


def gathered_tenant(sched, name, want):
    """Each field of tenant ``name`` bit for bit ``want``'s."""
    out = {}
    for field, ref in want.items():
        g = sched.gather(name, field)
        out[field] = (same_bits(torch.from_numpy(g).cuda(), ref)
                      if isinstance(ref, torch.Tensor)
                      else bool(np.array_equal(g, ref)))
        del g
    return out


# 5t (b): the launcher's volume (ndiv 2: block 24, temporal2's halo 8) and
# the tenants held to a solo run, cut for time: at (192, 1152, 1152), ndiv
# 4, with three solo runs, the phase took 145-179 s
LAUNCHER_SHAPE = (48, 1152, 1152)
LAUNCHER_SOLO = ("temporal2",)


def tenants_launcher():
    """5t (b): the launcher's multi-tenant run on the card, each tenant's
    transfers and counters held to the merged graph's, and the
    LAUNCHER_SOLO tenants bit for bit to a solo live engine of their
    schedule on the same fields (the ones the launcher drew from its
    seed)."""
    from repro_torch.launch import serve
    from repro_torch.serving.ooc import TenantScheduler

    argv = ["--ooc", "--tenants", "3", "--shape", *map(str, LAUNCHER_SHAPE),
            "--blocks", "2", "--sweeps", "2"]
    drawn = {}
    submit = TenantScheduler.submit

    def keep(self, name, cfg, p_prev, p_cur, vel2, **kw):
        drawn[name] = (p_prev, p_cur, vel2)
        return submit(self, name, cfg, p_prev, p_cur, vel2, **kw)

    TenantScheduler.submit = keep
    try:
        t0 = time.perf_counter()
        sched = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        TenantScheduler.submit = submit
    parity, _ = tenant_parity(sched, sched.budget_bytes)
    st = sched.stats()
    got = {}
    for spec in sched.specs():
        ex = sched.tenants[spec.name].executor
        ex.close()
        check(ex.device.type == "cuda" and ex.cfg.backend == "cuda",
              f"5t (b): tenant {spec.name} not on the card's kernels")
        if spec.schedule in LAUNCHER_SOLO:
            got[spec.name] = {n: sched.gather(spec.name, n)
                              for n in ("p_prev", "p_cur")}
    # the path's launches end here: the solo references do not count
    counts = path_counts()
    solos = {}
    t0 = time.perf_counter()
    for name, fields in got.items():
        spec = sched.tenants[name].spec
        solo = AsyncExecutor(spec.cfg, *drawn[name], schedule=spec.schedule)
        solo.run(spec.sweeps * spec.cfg.bt)
        solo.close()
        solos[name] = {n: bool(np.array_equal(v, solo.gather(n)))
                       for n, v in fields.items()}
        del solo
    del drawn, got
    row = {"phase": "tenancy_launcher", "argv": argv, "wall_s": wall,
           "solo_s": time.perf_counter() - t0,
           "budget_bytes": sched.budget_bytes,
           "schedules": {s.name: s.schedule for s in sched.specs()},
           "per_tenant": {n: {k: t[k] for k in (
               "hits", "evictions", "flushes", "peak_bytes",
               "sweeps_done", "reserve", "priority")}
               for n, t in st["per_tenant"].items()},
           "parity": parity, "bitwise_solo": solos}
    emit(row)
    check(len(sched.tenants) == 3,
          "5t (b): the launcher did not run 3 tenants")
    check(set(solos) == {s.name for s in sched.specs()
                         if s.schedule in LAUNCHER_SOLO},
          f"5t (b): solo runs of {sorted(solos)}")
    check(all(p["transfers_equal_graph"] and p["counters_equal_graph"]
              for p in parity.values()),
          f"5t (b): transfers or counters differ from the graph: {parity}")
    check(all(all(b.values()) for b in solos.values()),
          f"5t (b): a tenant differs from its solo run: {solos}")
    return counts


def tenancy_slice(fields, sync4, bt1, live_rows):
    """Phase 5t. Prints its seconds (host clock, references included);
    returns its launch counts (path ``ooc_tenancy``: both runs, their
    gathers included, the solo references of (b) not)."""
    t0 = time.perf_counter()
    reset_counts()
    tenants_contending(fields, sync4, bt1, live_rows)
    gc.collect()
    torch.cuda.empty_cache()
    counts = tenants_launcher()
    gc.collect()
    emit({"phase": "tenancy_seconds", "seconds": time.perf_counter() - t0})
    return counts


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
    codes 1-4 in float64 at the paper's rates on PREC_SHAPE, ndiv 2, bt
    12, 360 sweeps (4,320 steps), sampled every 30: code 1 exactly 0,
    codes 2-4 within PREC_TOL under ``assert_bounded_growth``. (The
    float32 curves at 16/12, held to no ceiling, were cut to make room
    for phase 5t.) Returns the launch counts of the curves."""
    from repro_torch.core.precision import assert_bounded_growth, \
        error_curve

    reset_counts()
    t_all = time.perf_counter()
    for dtype, codes in (("float64", (1, 2, 3, 4)),):
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


def cache_kernel_checks(cfg, eng, seen):
    """On a compressed-cache engine's own cache after its run: cdecode
    against its plain version on every layer's compressed history with
    that layer's q of the last step (within CD_TOL), and the chunk-flush
    encode of every layer's K and V tail window against the plain codec
    (bit for bit). Returns (cdecode within tol, its max |d|, encodes
    bitwise)."""
    check(len(seen) == cfg.num_layers, f"recorded {len(seen)} layers")
    planes = cfg.kv_compress_planes
    ok, err = True, 0.0
    for q, ckv in seen:
        args, kw = cdecode_ops.history_inputs(q, ckv)
        kw["planes"] = planes
        got = cdecode_kernel.fused_cdecode_attention(*args, **kw)
        want = cdecode_ref.fused_cdecode_attention_ref(*args, **kw)
        ok &= all(bool(torch.allclose(g, w, rtol=CD_TOL, atol=CD_TOL))
                  for g, w in zip(got, want))
        err = max(err, max(max_abs(g, w) for g, w in zip(got, want)))
    same = True
    for i in range(cfg.num_layers):
        for tail in (eng.cache.tail_k[i], eng.cache.tail_v[i]):
            a = kvcache._encode_chunk(tail, planes, "cuda")
            b = kvcache._encode_chunk(tail, planes, "ref")
            same &= same_bits(a[0], b[0]) and same_bits(a[1], b[1])
    return ok, err, same


def serve_kernels_on_cache(cfg, eng, seen):
    """The serving path's kernels against their plain versions at the
    shapes it gives them, on the engine's own cache after the run
    (``cache_kernel_checks``). ``ms`` times the launch as the path makes
    it (unmerged splits), ``merged_ms`` with the splits merged (the
    reference's contract). Not counted as launches of the path: the
    counts were read before."""
    ok, err, same = cache_kernel_checks(cfg, eng, seen)
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
    cfg = dataclasses.replace(get_config(SERVE_ARCH), num_layers=SERVE_LAYERS,
                              kv_compress_planes=SERVE_PLANES)
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
              **{f"zfp_{k}": v for k, v in zfp_kernel.f32_ndims.items()},
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

    # the streams' first SERVE_REPLAY_STEPS steps replayed through the
    # plain versions
    forced = [(p + o[:-1])[:SERVE_REPLAY_STEPS] for p, o in zip(prompts, outs)]
    _, ref_logits, rwall, reng = serve(cfg, params, forced, 1, "ref")
    del reng
    ratio = replay_ratio(logits[:SERVE_REPLAY_STEPS], ref_logits)
    agree = (ref_logits.argmax(-1) == logits[:SERVE_REPLAY_STEPS].argmax(-1)
             ).float().mean()
    emit({"phase": "serve_replay_ref", "backend": "ref",
          "kv_planes": cfg.kv_compress_planes, "steps": SERVE_REPLAY_STEPS,
          "wall_s": rwall, "max_ratio": max(ratio),
          "median_ratio": statistics.median(ratio),
          "argmax_agreement": float(agree)})
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


def profile_window(eng, warm, steps, label, extra=None):
    """Device time by kernel over ``steps`` decode steps after ``warm``
    steps, from ``torch.profiler`` (CUPTI), against the wall time of the
    same steps run first without the profiler on the same engine, whose
    cache and positions are then restored. Every slot must still be
    reading its prompt at the window's end. ``extra(prof, busy_us)``,
    when given, profiles with input shapes and adds its dict to the
    row."""
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=extra is not None) as prof:
        profiled_s = window()
    check(all(r is not None and not r.out for r in eng.active.values()),
          "a request left its prompt inside the profiled window")
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(device), "the profiler saw no device time")
    busy_us = sum(e.self_device_time_total for e in device)
    busy_step = busy_us / 1e6 / steps
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    emit({"phase": label, "steps": steps, "first_position": warm,
          **(extra(prof, busy_us) if extra is not None else {}),
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


def tol_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / (atol + rtol |want|) with SSCAN_TOL, in
    float64: 1 at the bound, as ``torch.allclose`` reads it."""
    got, want = got.double(), want.double()
    return float(((got - want).abs()
                  / (SSCAN_TOL["atol"] + SSCAN_TOL["rtol"] * want.abs())).max())


def sscan_cases(gen, results):
    """The kernel against the float64 recurrence
    (``ref.selective_scan_f64``), from a non-zero ``h0`` that the kernel
    overwrites in place with ``h_last``: y and h_last within SSCAN_TOL
    of it. Printed beside it: the float32 plain version's share of that
    bound from float64 and from the kernel (two float32 orders of a long
    scan, each within the bound of float64, may lie further apart than
    it). The kernel's device time a launch (profiler) beside the
    CUDA-event time of the call, and the plain version's time."""
    ptxas = kernel_ptxas("sscan", "sscan_kernel")
    for shape in SSCAN_SHAPES:
        bsz, s, d, n = shape
        args, h0 = sscan_inputs(shape, gen)
        want_y, want_h = sscan_ref.selective_scan_f64(*args, h0)
        h_io = h0.clone()
        y, h = sscan_kernel.selective_scan(*args, h_io, h_out=h_io)
        torch.cuda.synchronize()
        share = {"kernel_f64": max(tol_share(y, want_y),
                                   tol_share(h_io, want_h))}
        err = max(max_abs(y.double(), want_y), max_abs(h_io.double(), want_h))
        plain_y, plain_h = sscan_ref.selective_scan_ref(*args, h0,
                                                        SSCAN_CHUNK)
        share["plain_f64"] = max(tol_share(plain_y, want_y),
                                 tol_share(plain_h, want_h))
        share["kernel_plain"] = max(tol_share(y, plain_y),
                                    tol_share(h_io, plain_h))
        ok = h is h_io and share["kernel_f64"] <= 1.0
        del want_y, want_h, plain_y, plain_h
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
              "shape_bsdn": list(shape), "against": "selective_scan_f64",
              "within_tol": ok, "tol": SSCAN_TOL, "tol_share": share,
              "max_abs_err": err, "ms": r["ms"], "device_ms": r["device_ms"],
              "device_ms_by": r["device_ms_by"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
              "bound_bytes": nbytes,
              "sfu_per_s": sfu_per_s(), "library_ms": None,
              "library_note": "no single PyTorch call computes the "
                              "selective scan", "ptxas": ptxas})
        check(ok, f"sscan is not within {SSCAN_TOL} of float64 at {shape} "
                  f"(max |d| {err}, {share['kernel_f64']} of the bound)")
        del args, h0, h_io, y
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 9: the SSM slice at full width
# ----------------------------------------------------------------------


def states_after(eng, steps, snap):
    """Copy the engine's SSM states (and a hybrid's K/V of the first
    ``steps`` positions) into ``snap`` after its ``steps``-th decode step
    (by wrapping its decode-step function)."""
    inner, count = eng._step, [0]

    def step(*args):
        logits, cache = inner(*args)
        count[0] += 1
        if count[0] == steps:
            snap["conv"], snap["h"] = cache.conv.clone(), cache.h.clone()
            if cache.k is not None:
                snap["k"] = cache.k[:, :, :steps].clone()
                snap["v"] = cache.v[:, :, :steps].clone()
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
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=SSM_LAYERS)
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
              **{f"zfp_{k}": v for k, v in zfp_kernel.f32_ndims.items()},
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

    # the plain versions on the card, bf16: printed. Over random bf16
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
    emit({"phase": "ssm_seconds", "layers": cfg.num_layers,
          "seconds": time.perf_counter() - t0})
    return counts


# ----------------------------------------------------------------------
# phase moe: the MoE family at full width (Qwen3-MoE, compressed KV cache)
# ----------------------------------------------------------------------


@contextlib.contextmanager
def routing_log():
    """Keep every routing of the duration: per ``moe.route`` call (one a
    layer a decode step) its top-k experts (T, k) and its scores (T, E),
    by wrapping ``moe.top_k`` (the routing is the one the path makes)."""
    log = []
    inner = moe_mod.top_k

    def record(scores, k):
        vals, idx = inner(scores, k)
        log.append((idx, scores))
        return vals, idx

    moe_mod.top_k = record
    try:
        yield log
    finally:
        moe_mod.top_k = inner


@contextlib.contextmanager
def ffn_inputs(calls):
    """Keep the input ``x`` of the last ``calls`` calls of
    ``moe.moe_ffn`` for the duration."""
    seen = collections.deque(maxlen=calls)
    inner = moe_mod.moe_ffn

    def record(x, *args, **kw):
        seen.append(x)
        return inner(x, *args, **kw)

    moe_mod.moe_ffn = record
    try:
        yield seen
    finally:
        moe_mod.moe_ffn = inner


def routing_flips(cfg, kernel_log, plain_log):
    """The two engines' routings compared by (step, layer, slot): whether
    each token went to the same experts, and every flip with its score
    gap (k-th against (k+1)-th) in each engine and the token's largest
    score difference between the engines, all relative to the k-th
    score. A top-k that is right can flip a choice only where both gaps
    are within twice that difference (``flip_explained``): a flip past
    it is a fault. A flip is clean when no earlier layer of its slot
    flipped at this step or before (through the KV cache); printed, with
    whether its gaps are within bf16 rounding of the scores. Returns
    (agree (steps, layers, slots), flips, faults, by-layer summary)."""
    k, nl = cfg.experts_per_token, cfg.num_layers
    check(len(kernel_log) == len(plain_log) and len(kernel_log) % nl == 0,
          f"routings logged: {len(kernel_log)} and {len(plain_log)}")
    steps = len(kernel_log) // nl
    shape = (steps, nl, -1)
    sets = [torch.stack([i for i, _ in log]).sort(-1).values.cpu()
            for log in (kernel_log, plain_log)]
    agree = (sets[0] == sets[1]).all(-1).reshape(shape)
    scores = [torch.stack([s for _, s in log]).double().cpu()
              for log in (kernel_log, plain_log)]
    diff = (scores[0] - scores[1]).abs().amax(-1).reshape(shape)
    gaps, kth = [], None
    for sc in scores:
        v = sc.topk(k + 1, dim=-1).values
        gaps.append((v[..., k - 1] - v[..., k]).reshape(shape))
        kth = v[..., k - 1].reshape(shape) if kth is None else kth
    del scores
    flipped = ~agree
    upto = flipped.cumsum(0) > 0  # a flip at this step or before
    dirty = torch.zeros_like(flipped)
    for layer in range(1, nl):
        dirty[:, layer] = upto[:, :layer].any(1)
    flips = []
    for t, layer, b in torch.nonzero(flipped).tolist():
        at, ref = (t, layer, b), float(kth[t, layer, b])
        g = [float(gaps[0][at]), float(gaps[1][at])]
        flips.append({"step": t, "layer": layer, "slot": b,
                      "gap_kernel": g[0] / ref, "gap_plain": g[1] / ref,
                      "score_diff": float(diff[at]) / ref,
                      "flip_explained": max(g) <= 2 * float(diff[at]),
                      "within_bf16": max(g) / ref <= BF16_SCORE_ROUNDING,
                      "clean": not bool(dirty[at])})
    faults = [f for f in flips if not f["flip_explained"]]
    rel_diff = diff / kth
    by_layer = [{"layer": layer,
                 "flips": int(flipped[:, layer].sum()),
                 "clean_flips": int((flipped & ~dirty)[:, layer].sum()),
                 "score_diff_max": float(rel_diff[:, layer].max()),
                 "score_diff_median": float(rel_diff[:, layer].median())}
                for layer in range(nl)]
    return agree, flips, faults, by_layer


def moe_oracle(x, top_w, top_i, lp, capacity):
    """Σ over kept assignments of weight · the expert's GLU of the
    token, in float64, independent of ``moe.dispatch``: the kept set by a
    host loop (each expert's first ``capacity`` assignments in flat
    (t, k) order), one expert at a time. Returns (y, kept (T, k))."""
    t, k = top_i.shape
    ids = top_i.reshape(-1).tolist()
    seen = collections.Counter()
    kept, by_expert = [], collections.defaultdict(list)
    for n, ex in enumerate(ids):
        kept.append(seen[ex] < capacity)
        seen[ex] += 1
        if kept[-1]:
            by_expert[ex].append(n)
    x64, w64 = x.double(), top_w.double()
    y = torch.zeros(x.shape, dtype=F64, device=x.device)
    for ex, ns in by_expert.items():
        n = torch.tensor(ns, device=x.device)
        tok, j = n // k, n % k  # a token picks an expert once
        xe = x64[tok]
        h = torch.nn.functional.silu(xe @ lp.wg_e[ex].double()) * (
            xe @ lp.wu_e[ex].double())
        y.index_add_(0, tok, (h @ lp.wd_e[ex].double()) * w64[tok, j][:, None])
    return y, torch.tensor(kept).reshape(t, k)


def moe_ffn_case(cfg, lp, x, label):
    """``moe_ffn`` in float32 on layer 0's weights against ``moe_oracle``
    on the port's own routing: the kept set exactly, ``y`` within
    MOE_ORACLE_TOL of max |y|, and two calls bit for bit."""
    t, k, e = x.shape[0], cfg.experts_per_token, cfg.num_experts
    cap = moe_mod._capacity(t, k, e, cfg.capacity_factor)
    kw = dict(k=k, capacity_factor=cfg.capacity_factor)
    args = (x[None], lp.router, lp.wg_e, lp.wu_e, lp.wd_e)
    with torch.inference_mode():
        y, _ = moe_mod.moe_ffn(*args, **kw)
        y2, _ = moe_mod.moe_ffn(*args, **kw)
        top_w, top_i, _ = moe_mod.route(x, lp.router, k)
        keep = moe_mod.dispatch(top_i, e, cap).keep.reshape(t, k).cpu()
        want, want_keep = moe_oracle(x, top_w, top_i, lp, cap)
    row = {"case": label, "tokens": t, "assignments": t * k,
           "capacity": cap, "dropped": int((~keep).sum()),
           "oracle_dropped": int((~want_keep).sum()),
           "kept_set_equal": bool(torch.equal(keep, want_keep)),
           "rel_err": float((y[0].double() - want).abs().max()
                            / want.abs().max()),
           "tol": MOE_ORACLE_TOL, "bitwise_twice": same_bits(y, y2)}
    check(row["kept_set_equal"], f"moe {label}: kept set differs from the "
                                 f"oracle's")
    check(row["rel_err"] < MOE_ORACLE_TOL,
          f"moe {label}: y off the float64 oracle by {row['rel_err']}")
    check(row["bitwise_twice"], f"moe {label}: two calls differ")
    return row


def expert_bmm_share(cfg):
    """A ``profile_window`` reader: the device time of the experts'
    products (``aten::bmm`` over the (E, C, d) buffer, by input shape)
    and its share of the window's device time."""
    def read(prof, busy_us):
        rows = [e for e in prof.key_averages(group_by_input_shape=True)
                if e.key == "aten::bmm" and e.input_shapes
                and e.input_shapes[0][:1] == [cfg.num_experts]]
        check(bool(rows), "moe: the profiler saw no expert product")
        dev = sum(e.device_time_total for e in rows)
        return {"expert_bmm_device_ms": dev / 1e3,
                "expert_bmm_calls": sum(e.count for e in rows),
                "expert_bmm_share": dev / busy_us,
                "expert_bmm_shapes": [e.input_shapes for e in rows]}
    return read


def moe_slice():
    """Phase moe: Qwen3-MoE at full width, bf16, MOE_LAYERS of its 94
    layers, the compressed KV cache at 16 planes: (a) served through the
    kernels, (b) replayed through the plain versions with the routings
    compared, (c) ``moe_ffn`` against the float64 oracle, (d) prefill,
    (e) the device time by kernel. Returns the launches of (a)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS,
                              kv_compress_planes=SERVE_PLANES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(MOE_SLOTS, MOE_PROMPT)).tolist()
    serve_kw = dict(slots=MOE_SLOTS, max_len=MOE_MAX_LEN)

    # (a) the path, counted from zero
    reset_counts()
    cdecode_kernel.reset_launches()
    with last_attention_inputs(cfg.num_layers) as seen, \
            routing_log() as kernel_routes, \
            ffn_inputs(cfg.num_layers) as decode_x:
        outs, logits, wall, eng = serve(cfg, params, prompts, MOE_NEW,
                                        "cuda", **serve_kw)
    counts = {"zfp_encode": zfp_kernel.launches["encode"],
              "zfp_decode": zfp_kernel.launches["decode"],
              **{f"zfp_{k}": v for k, v in zfp_kernel.f32_ndims.items()},
              "cdecode": cdecode_kernel.launches["cdecode"]}
    steps = MOE_PROMPT + MOE_NEW - 1
    check(all(len(o) == MOE_NEW for o in outs), "moe: a request fell short")
    check(bool(torch.isfinite(logits).all()), "moe: non-finite logits")
    check(tuple(logits.shape) == (steps, MOE_SLOTS, cfg.vocab_size),
          f"moe: logits {tuple(logits.shape)}")
    check(counts["zfp_encode"] > 0 and counts["cdecode"] > 0,
          f"the moe serving path missed a kernel: {counts}")
    ok, err, same = cache_kernel_checks(cfg, eng, seen)
    raw_bytes = (2 * cfg.num_layers * MOE_SLOTS * MOE_MAX_LEN
                 * cfg.num_kv_heads * cfg.head_dim
                 * torch.finfo(lm.dtype_of(cfg)).bits // 8)
    comp_bytes = kvcache.compressed_bytes(eng.cache)
    gen_tokens = sum(len(o) for o in outs)
    emit({"phase": "moe_serve_cuda", "arch": MOE_ARCH, "dtype": cfg.dtype,
          "card": device_mod.card_line(), "layers": cfg.num_layers,
          "d_model": cfg.d_model, "experts": cfg.num_experts,
          "top_k": cfg.experts_per_token, "d_ff": cfg.d_ff,
          "kv_planes": cfg.kv_compress_planes, "slots": MOE_SLOTS,
          "prompt": MOE_PROMPT, "max_new": MOE_NEW, "max_len": MOE_MAX_LEN,
          "steps": steps, "wall_s": wall, "new_tokens": gen_tokens,
          "new_tokens_per_s": gen_tokens / wall,
          "fed_tokens_per_s": MOE_SLOTS * steps / wall,
          "params": sum(p.numel() for p in params.parameters()),
          "params_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
          "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
          "compressed_cache_bytes": comp_bytes, "raw_cache_bytes": raw_bytes,
          "raw_over_compressed": raw_bytes / comp_bytes, "launches": counts,
          "cdecode_within_tol": ok, "cdecode_max_abs_err": err,
          "tol": CD_TOL, "encode_bitwise": same})
    check(ok, f"moe: cdecode differs from its plain version on the cache "
              f"(max |d| {err})")
    check(same, "moe: the chunk-flush encode differs from the plain codec")
    x_decode = decode_x[0].reshape(-1, cfg.d_model).float()
    del eng, seen, decode_x
    torch.cuda.empty_cache()

    # (b) the same streams, teacher-forced, through the plain versions
    forced = [p + o[:-1] for p, o in zip(prompts, outs)]
    with routing_log() as plain_routes:
        _, ref_logits, rwall, reng = serve(cfg, params, forced, 1, "ref",
                                           **serve_kw)
    del reng
    agree, flips, faults, by_layer = routing_flips(cfg, kernel_routes,
                                                   plain_routes)
    del kernel_routes, plain_routes
    ratio = replay_ratio(logits, ref_logits)
    agreeing = [t for t in range(steps) if bool(agree[t].all())]
    checked = [ratio[t] for t in agreeing]
    emit({"phase": "moe_serve_replay_ref", "wall_s": rwall,
          "steps": steps, "steps_routings_agree": len(agreeing),
          "routings": agree.numel(), "routings_agree": int(agree.sum()),
          "flip_count": len(flips), "by_layer": by_layer,
          "clean_flips": sum(f["clean"] for f in flips),
          "clean_flips_past_bf16": sum(f["clean"] and not f["within_bf16"]
                                       for f in flips),
          "unexplained_flips": len(faults),
          "bf16_score_rounding": BF16_SCORE_ROUNDING, "flips": flips,
          "max_ratio_agreeing": max(checked) if checked else None,
          "max_ratio_all": max(ratio), "median_ratio": statistics.median(ratio),
          "tol": SERVE_TOL})
    check(not faults, f"moe: routings flipped past the score difference "
                      f"that explains a flip: {faults[:4]}")
    check(bool(checked) and max(checked) < SERVE_TOL,
          f"moe: cuda engine vs ref engine on agreeing steps: "
          f"{max(checked) if checked else 'no step agrees'}")
    del ref_logits
    torch.cuda.empty_cache()

    # (d) prefill on the same prompts
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    pos = torch.arange(MOE_PROMPT, dtype=torch.int32,
                       device="cuda").expand(MOE_SLOTS, -1)
    torch.cuda.synchronize()
    tp = time.perf_counter()
    with ffn_inputs(cfg.num_layers) as prefill_x:
        p_logits, _ = lm.prefill(cfg, params, toks, pos, backend="cuda")
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - tp
    x_prefill = prefill_x[0].reshape(-1, cfg.d_model).float()
    del prefill_x
    last = logits[MOE_PROMPT - 1].to(p_logits.device)
    emit({"phase": "moe_prefill_cuda", "tokens": [MOE_SLOTS, MOE_PROMPT],
          "wall_s": p_wall, "finite": bool(torch.isfinite(p_logits).all()),
          "vs_decode_fed_engine": {
              "logits_rel": rel(p_logits, last),
              "greedy_agreement": float((p_logits.argmax(-1)
                                         == last.argmax(-1)).float().mean())}})
    check(bool(torch.isfinite(p_logits).all()), "moe: non-finite prefill")
    del logits, p_logits, last
    torch.cuda.empty_cache()

    # (c) moe_ffn against the float64 oracle, layer 0 in float32
    lp = params.layers[0]
    lp32 = types.SimpleNamespace(**{n: getattr(lp, n).float() for n in (
        "router", "wg_e", "wu_e", "wd_e")})
    cases = [moe_ffn_case(cfg, lp32, x_decode, "decode"),
             moe_ffn_case(cfg, lp32, x_prefill, "prefill")]
    del lp32
    torch.cuda.empty_cache()
    with torch.inference_mode():
        xb = x_prefill.to(lm.dtype_of(cfg))[None]
        kw = dict(k=cfg.experts_per_token,
                  capacity_factor=cfg.capacity_factor)
        yb = [moe_mod.moe_ffn(xb, lp.router, lp.wg_e, lp.wu_e, lp.wd_e,
                              **kw)[0] for _ in range(2)]
    bf16_twice = bool(torch.equal(yb[0].view(torch.int16),
                                  yb[1].view(torch.int16)))
    emit({"phase": "moe_ffn_oracle", "dtype": "float32", "cases": cases,
          "bf16_prefill_bitwise_twice": bf16_twice})
    check(cases[0]["dropped"] == 0, "moe: the decode step dropped")
    check(cases[1]["dropped"] > 0, "moe: the prefill case dropped nothing")
    check(bf16_twice, "moe: two bf16 calls differ")
    del yb, xb, x_decode, x_prefill

    # (e) device time by kernel over a steady window
    eng = ServeEngine(cfg, params, device="cuda", **serve_kw)
    for p in prompts:
        eng.submit(p, max_new=1)
    profile_window(eng, *MOE_WINDOW, "moe_profile",
                   extra=expert_bmm_share(cfg))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "moe_seconds", "seconds": time.perf_counter() - t0,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return counts


# ----------------------------------------------------------------------
# phase hybrid: zamba2-2.7b at full width (Mamba-2/SSD and the shared
# attention block, plain PyTorch as the reference's XLA)
# ----------------------------------------------------------------------

HYB_ARCH = "zamba2-2.7b"
# full width and depth: 54 Mamba-2 layers in 9 groups; float32, as phase
# 9's float32 pass (random bf16 layers drift ~5% alone)
HYB_LAYERS = 54
HYB_SLOTS, HYB_PROMPT, HYB_NEW, HYB_MAX_LEN = 8, 64, 32, 128
# profiled decode steps: warm-up, then the window. A step launches ~4,500
# kernels, and the profiler's own processing took ~4.5 s a profiled step
# (with or without host events): 16 steps cost the phase 83 s, 4 27 s
HYB_WINDOW = (8, 2)
HYB_FORMS_TOL = 1e-3  # chunk 64 against chunk 1: of the largest value
SSD_SHAPES = ((8, 64, 80, 64, 64), (8, 100, 80, 64, 64))  # (B, S, H, P, N)
SSD_TOL = 1e-4  # against float64, of the largest |y| and |h_last|


def ssd_f64(dt, a, b_in, c_in, x, h0):
    """The Mamba-2 recurrence step by step in float64:
    ``h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``."""
    rep = x.shape[2] // b_in.shape[2]
    dt, a, b_in, c_in, x, h = (t.double() for t in (dt, a, b_in, c_in, x,
                                                    h0))
    ys = []
    for t in range(dt.shape[1]):
        bh = b_in[:, t].repeat_interleave(rep, dim=1)  # (B, H, N)
        ch = c_in[:, t].repeat_interleave(rep, dim=1)
        h = (torch.exp(dt[:, t] * a)[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * bh[:, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch))
    return torch.stack(ys, dim=1), h


def ssd_cases(gen):
    """``ssd_chunked`` at one zamba2 layer's shapes (8 slots, 80 heads of
    64, N 64, one B/C group, chunk 64) at S = 64 and a ragged S = 100,
    from a non-zero state, against ``ssd_f64``."""
    out = []
    for bsz, s, nh, p, n in SSD_SHAPES:
        dt = F.softplus(torch.randn(bsz, s, nh, generator=gen,
                                    device="cuda") - 2.0)
        a = -torch.exp(0.3 * torch.randn(nh, generator=gen, device="cuda"))
        b_in, c_in = (torch.randn(bsz, s, 1, n, generator=gen, device="cuda")
                      for _ in range(2))
        x = torch.randn(bsz, s, nh, p, generator=gen, device="cuda")
        h0 = 0.1 * torch.randn(bsz, nh, p, n, generator=gen, device="cuda")
        with torch.inference_mode():
            y, h = ssm_mod.ssd_chunked(dt, a, b_in, c_in, x, h0, SSCAN_CHUNK)
            wy, wh = ssd_f64(dt, a, b_in, c_in, x, h0)
            ms = median_ms(lambda: ssm_mod.ssd_chunked(
                dt, a, b_in, c_in, x, h0, SSCAN_CHUNK), 5)
        row = {"shape_bshpn": [bsz, s, nh, p, n], "chunk": SSCAN_CHUNK,
               "y_rel": rel(y, wy), "h_rel": rel(h, wh), "tol": SSD_TOL,
               "ms": ms}
        out.append(row)
        check(row["y_rel"] < SSD_TOL and row["h_rel"] < SSD_TOL,
              f"ssd_chunked at {row['shape_bshpn']} is not within "
              f"{SSD_TOL} of float64: {row}")
    emit({"phase": "ssd_f64", "cases": out})


def hybrid_slice():
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(HYB_ARCH), num_layers=HYB_LAYERS,
                              dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(SEED + 3)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(HYB_SLOTS, HYB_PROMPT)).tolist()
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    pos = torch.arange(HYB_PROMPT, dtype=torch.int32,
                       device="cuda").expand(HYB_SLOTS, -1)
    fed = {}

    # the path: serve, then prefill, counted from 0 (no kernel of the
    # repo runs here: the reference's hybrid is XLA)
    reset_counts()
    cdecode_kernel.reset_launches()
    sscan_kernel.reset_launches()
    outs, logits, wall, eng = serve(
        cfg, params, prompts, HYB_NEW, "cuda", slots=HYB_SLOTS,
        max_len=HYB_MAX_LEN,
        on_engine=lambda e: states_after(e, HYB_PROMPT, fed))
    torch.cuda.synchronize()
    p0 = time.perf_counter()
    p_logits, (p_st, (p_k, p_v)) = lm.prefill(cfg, params, toks, pos)
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - p0
    counts = {"sscan": sscan_kernel.launches["sscan"],
              "zfp_encode": zfp_kernel.launches["encode"],
              "zfp_decode": zfp_kernel.launches["decode"],
              "cdecode": cdecode_kernel.launches["cdecode"],
              **stencil_kernel.launches}
    del eng
    torch.cuda.empty_cache()
    check(sum(counts.values()) == 0,
          f"hybrid: a kernel launched on a path with none: {counts}")
    steps = HYB_PROMPT + HYB_NEW - 1
    check(all(len(o) == HYB_NEW for o in outs), "hybrid: a request fell short")
    check(bool(torch.isfinite(logits).all()), "hybrid: non-finite logits")
    check(tuple(logits.shape) == (steps, HYB_SLOTS, cfg.vocab_size),
          f"hybrid: logits {tuple(logits.shape)}")
    gen_tokens = sum(len(o) for o in outs)
    emit({"phase": "hybrid_serve", "arch": HYB_ARCH, "dtype": cfg.dtype,
          "layers": cfg.num_layers, "groups": cfg.num_layers // cfg.attn_period,
          "d_model": cfg.d_model, "ssm_heads": cfg.ssm_heads,
          "ssm_head_dim": cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
          "slots": HYB_SLOTS, "prompt": HYB_PROMPT, "max_new": HYB_NEW,
          "max_len": HYB_MAX_LEN, "steps": steps, "wall_s": wall,
          "new_tokens": gen_tokens, "new_tokens_per_s": gen_tokens / wall,
          "fed_tokens_per_s": HYB_SLOTS * steps / wall,
          "max_abs_logits": float(logits.abs().max()),
          "params": sum(t.numel() for t in params.parameters()),
          "params_bytes": sum(t.numel() * t.element_size()
                              for t in params.parameters()),
          "launches": counts})

    # (b) the two forms of the recurrence: prefill (SSD at chunk 64)
    # against the engine fed one token a step (chunk 1)
    check(bool(torch.isfinite(p_logits).all()), "hybrid: non-finite prefill")
    flat = lambda t: t.flatten(0, 1)
    forms = {"logits_rel": rel(p_logits, logits[HYB_PROMPT - 1].cuda()),
             "h_rel": rel(flat(p_st.h), fed["h"]),
             "conv_rel": rel(flat(p_st.conv), fed["conv"]),
             "k_rel": rel(p_k, fed["k"]), "v_rel": rel(p_v, fed["v"])}
    per_layer_h = [rel(flat(p_st.h)[i], fed["h"][i])
                   for i in range(cfg.num_layers)]
    emit({"phase": "hybrid_forms", "prefill_wall_s": p_wall,
          "tokens": [HYB_SLOTS, HYB_PROMPT], "chunk": cfg.ssm_chunk,
          "tol": HYB_FORMS_TOL, **forms,
          "h_rel_worst_layer": int(np.argmax(per_layer_h)),
          "greedy_agreement": float((p_logits.argmax(-1) == logits[
              HYB_PROMPT - 1].cuda().argmax(-1)).float().mean())})
    check(max(forms.values()) < HYB_FORMS_TOL,
          f"hybrid: prefill and the decode-fed engine differ: {forms}")
    del p_st, p_k, p_v, fed
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, slots=HYB_SLOTS, max_len=HYB_MAX_LEN,
                      device="cuda")
    for p in prompts:
        eng.submit(p, max_new=1)
    profile_window(eng, *HYB_WINDOW, "hybrid_profile")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ssd_cases(torch.Generator(device="cuda").manual_seed(SEED + 4))
    emit({"phase": "hybrid_seconds", "seconds": time.perf_counter() - t0,
          "profile_s": t2 - t1, "ssd_s": time.perf_counter() - t2,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return counts


# ----------------------------------------------------------------------
# phase embeds: the vision-language and audio front ends at full width
# over the compressed KV cache (decode_step fed embeddings)
# ----------------------------------------------------------------------

# full width, depth cut to 4 layers as the Qwen2 slice's (4 of 28; of 48)
EMB_ARCHS = (("qwen2-vl-7b", "vlm_decode"), ("musicgen-medium",
                                             "audio_decode"))
EMB_LAYERS, EMB_PLANES = 4, 16
EMB_SLOTS, EMB_PROMPT, EMB_NEW = 8, 128, 64
EMB_STEPS = EMB_PROMPT + EMB_NEW - 1  # as an engine: the last token unfed
EMB_MAX_LEN = 256
EMB_MROPE_SPLIT = 64  # positions whose three M-RoPE streams differ
EMB_SCALE = 0.02  # the embeddings' scale, the embedding table's own


def emb_positions(cfg, p: int) -> torch.Tensor:
    """Every slot's position ``p``: (B, 1), or for M-RoPE (3, B, 1) with
    temporal p, height p // 8 and width p % 8 for p < 64, then p thrice."""
    col = torch.full((EMB_SLOTS, 1), p, dtype=torch.int32, device="cuda")
    if not cfg.mrope_sections:
        return col
    if p >= EMB_MROPE_SPLIT:
        return torch.stack([col, col, col])
    return torch.stack([col, col // 8, col % 8])


def emb_run(cfg, params, embeds, backend):
    """``EMB_STEPS`` lockstep decode steps over a fresh compressed cache
    fed ``embeds`` (B, S, d). Returns (logits (S, B, V) on the card,
    the cache, wall s)."""
    cache = lm.init_cache(cfg, EMB_SLOTS, EMB_MAX_LEN, "cuda")
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(EMB_STEPS):
        logits, cache = lm.decode_step(cfg, params, cache,
                                       embeds[:, i:i + 1],
                                       emb_positions(cfg, i),
                                       backend=backend)
        out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out), cache, time.perf_counter() - t0


def embeds_model(arch):
    cfg = dataclasses.replace(get_config(arch), num_layers=EMB_LAYERS,
                              kv_compress_planes=EMB_PLANES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    params = lm.init_params(cfg, gen, device="cuda")
    embeds = (EMB_SCALE * torch.randn(EMB_SLOTS, EMB_STEPS, cfg.d_model,
                                      generator=gen, device="cuda")
              ).to(lm.dtype_of(cfg))
    zfp_kernel.reset_launches()
    cdecode_kernel.reset_launches()
    with last_attention_inputs(cfg.num_layers) as seen:
        logits, cache, wall = emb_run(cfg, params, embeds, "cuda")
    counts = {"zfp_encode": zfp_kernel.launches["encode"],
              "zfp_decode": zfp_kernel.launches["decode"],
              **{f"zfp_{k}": v for k, v in zfp_kernel.f32_ndims.items()},
              "cdecode": cdecode_kernel.launches["cdecode"]}
    flushes = EMB_STEPS // kvcache.CHUNK
    want = {"cdecode": cfg.num_layers * EMB_STEPS,
            "zfp_encode": 2 * cfg.num_layers * flushes}
    check(counts["cdecode"] == want["cdecode"]
          and counts["zfp_encode"] == want["zfp_encode"]
          == counts.get("zfp_encode ndim2", 0),
          f"{arch}: launches {counts}, expected {want}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
    ok, err, same = cache_kernel_checks(cfg, types.SimpleNamespace(
        cache=cache), seen)
    del seen
    ref_logits, _, rwall = emb_run(cfg, params, embeds, "ref")
    ratio = replay_ratio(logits.float(), ref_logits.float())
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean()
    head = cfg.num_heads // cfg.num_kv_heads
    emit({"phase": f"embeds_{arch}", "arch": arch, "family": cfg.family,
          "dtype": cfg.dtype, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "queries_per_kv_head": head, "kv_planes": EMB_PLANES,
          "slots": EMB_SLOTS, "steps": EMB_STEPS, "max_len": EMB_MAX_LEN,
          "mrope": bool(cfg.mrope_sections), "wall_s": wall,
          "step_ms": wall / EMB_STEPS * 1e3,
          "fed_tokens_per_s": EMB_SLOTS * EMB_STEPS / wall,
          "ref_wall_s": rwall, "launches": counts,
          "cdecode_within_tol": ok, "cdecode_max_abs_err": err,
          "cdecode_tol": CD_TOL, "encode_bitwise": same,
          "max_ratio": max(ratio), "median_ratio": statistics.median(ratio),
          "greedy_agreement": float(agree),
          "compressed_cache_bytes": kvcache.compressed_bytes(cache),
          "params_bytes": sum(t.numel() * t.element_size()
                              for t in params.parameters())})
    check(ok, f"{arch}: cdecode differs from its plain version (max |d| "
              f"{err})")
    check(same, f"{arch}: the chunk-flush encode differs from the plain "
                f"codec")
    check(max(ratio) < SERVE_TOL, f"{arch}: kernels vs plain versions: "
                                  f"ratio {max(ratio)}")
    del params, cache, logits, ref_logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def embeds_slice():
    """Each model's path counted from 0: (path name, its counts)."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {path: embeds_model(arch) for arch, path in EMB_ARCHS}
    emit({"phase": "embeds_seconds", "seconds": time.perf_counter() - t0,
          "peak_allocated_bytes": torch.cuda.max_memory_allocated()})
    return out


# ----------------------------------------------------------------------
# phase train: the trainer, compressed remat and compressed gradients
# ----------------------------------------------------------------------

TRAIN_DIR = Path(__file__).resolve().parent / "build" / "smoke_train"
TRAIN_ARCH = "qwen2-1.5b"
# full width, depth cut to 4 of 28 layers as phase 7
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 512, 3
TRAIN_PLANES = 8  # the gradients' rate; the residuals take 12 (model.py)
TRAIN_RESUME_TOL = 1e-5  # relative: losses and weights after a resume
TRAIN_REPLAY_TOL = 1e-4  # relative: losses and gnorms, kernels vs plain


@torch.no_grad()
def rel_leaf(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (max |a - b| when b is all zero)."""
    diff, den = float((a - b).abs().max()), float(b.abs().max())
    return diff / den if den else diff


def quantized_leaves(model) -> int:
    """The leaves ``compress_grads`` quantizes a step: each stacked leaf
    of 64 values or more."""
    sizes = {k: p.numel() for k, p in model.named_parameters()}
    return sum(sum(sizes[k] for k in names) >= collectives.MIN_VALUES
               for names in lm.stacked_leaves(sizes).values())


def residual_leaves(model) -> int:
    """The leaves compressed remat codes a step: a layer's hidden state
    and each of its weights of 64 values or more."""
    return sum(1 + sum(p.numel() >= remat.MIN_VALUES for p in lp.parameters())
               for lp in model.layers)


def train_launcher():
    """(a) ``launch.train.main`` at the lm-100m preset, 20 steps, 8-plane
    gradients, a checkpoint every 10; then a second ``main`` resumed from
    step 10's checkpoint. Returns the launches of both runs."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    whole_dir, cut_dir = TRAIN_DIR / "whole", TRAIN_DIR / "resumed"
    argv = ["--preset", "lm-100m", "--steps", "20", "--grad-compress",
            str(TRAIN_PLANES), "--ckpt-every", "10"]
    try:
        t0 = time.perf_counter()
        whole = train_mod.main(argv + ["--ckpt-dir", str(whole_dir)])
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        cut_dir.mkdir(parents=True)
        shutil.copytree(whole_dir / "step_0000000010",
                        cut_dir / "step_0000000010")
        t0 = time.perf_counter()
        resumed = train_mod.main(argv + ["--ckpt-dir", str(cut_dir),
                                         "--resume"])
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        counts = path_counts()
        manifest = ckpt.read_manifest(ckpt.latest(str(whole_dir)))
        ckpt_bytes = sum(f.stat().st_size for f in
                         (whole_dir / "step_0000000020").iterdir())
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    keys = list(lm.stacked_leaves(
        [n for n, _ in whole.model.named_parameters()]))
    want_keys = ({f"0/{k}" for k in keys} | {"1/step"}
                 | {f"1/{d}/{k}" for d in ("m", "v", "ef") for k in keys})
    tail = whole.history[10:]
    loss_rel = max(abs(a[1] - b[1]) / abs(b[1])
                   for a, b in zip(resumed.history, tail))
    param_rel = max(rel_leaf(a, b) for (_, a), (_, b) in zip(
        resumed.model.named_parameters(), whole.model.named_parameters()))
    bitwise = resumed.history == tail and all(
        torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                          whole.model.parameters()))
    per_step = quantized_leaves(whole.model)
    steps_run = len(whole.history) + len(resumed.history)
    row = {"phase": "train_launcher", "preset": "lm-100m",
           "params": sum(p.numel() for p in whole.model.parameters()),
           "steps": [len(whole.history), len(resumed.history)],
           "wall_s": [whole_s, resumed_s], "checkpoint_bytes": ckpt_bytes,
           "losses": [h[1] for h in whole.history],
           "resumed_losses": [h[1] for h in resumed.history],
           "loss_max_rel": loss_rel, "param_max_rel": param_rel,
           "bitwise": bitwise, "quantized_leaves_per_step": per_step,
           "launches": {k: v for k, v in counts.items() if v}}
    emit(row)
    check([h[0] for h in resumed.history] == list(range(10, 20)),
          "train (a): the resumed run did not start at step 10")
    check(loss_rel <= TRAIN_RESUME_TOL and param_rel <= TRAIN_RESUME_TOL,
          f"train (a): resume off by {loss_rel} (losses), {param_rel} "
          f"(weights)")
    check(want_keys == set(manifest["leaves"]),
          f"train (a): manifest keys {sorted(manifest['leaves'])[:6]}... "
          f"are not the reference's tree's")
    for kind in ("encode", "decode"):
        check(counts.get(f"zfp_{kind} ndim1", 0) == per_step * steps_run
              == counts[f"zfp_{kind}"],
              f"train (a): {counts.get(f'zfp_{kind} ndim1')} {kind} "
              f"launches for {per_step} leaves x {steps_run} steps")
    return counts


def train_config():
    return dataclasses.replace(
        get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS, dtype="float32",
        remat="compressed", grad_compress_planes=TRAIN_PLANES)


def train_batches(cfg):
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_BATCH,
                                      TRAIN_SEQ, seed=0))
    return [{k: torch.from_numpy(v.copy()).cuda() for k, v in
             pipe.batch_at(s).items()} for s in range(TRAIN_STEPS)]


def fresh_model(cfg, init):
    model = lm.Model(cfg, device=init[0].device, dtype=lm.dtype_of(cfg))
    with torch.no_grad():
        for (_, p), t in zip(model.named_parameters(), init):
            p.copy_(t)
    return model


class CodecWitness:
    """Step 1's codec calls held to the plain codec on the card: every
    residual ``compress_tree`` saves (payload and emax) and every
    quantized gradient, on the very leaves they were given."""

    def __init__(self):
        self.residuals, self.grads = [], []

    def __enter__(self):
        real_tree, real_leaf = remat.compress_tree, collectives.quantize_leaf

        def tree(args, planes, **kw):
            out = real_tree(args, planes, **kw)
            for a, r in zip(args, out):
                if isinstance(r, remat.ZfpResidual):
                    flat = a.detach().reshape(-1).float()
                    rp, re = zfp_ref.encode_blocks(
                        zfp_ref.blockify(flat, 1), planes, 1)
                    self.residuals.append(
                        (a.numel(), r.comp.nbytes(),
                         same_bits(r.comp.payload, rp)
                         and same_bits(r.comp.emax, re)))
            return out

        def leaf(g, planes, **kw):
            q = real_leaf(g, planes, **kw)
            if q is not g:
                want = zfp_ref.quantize(g.reshape(-1).float(), planes, 1)
                self.grads.append((g.numel(), same_bits(q.reshape(-1), want)))
            return q

        self._undo = (real_tree, real_leaf)
        remat.compress_tree, collectives.quantize_leaf = tree, leaf
        return self

    def __exit__(self, *exc):
        remat.compress_tree, collectives.quantize_leaf = self._undo


def step_profile(step, model, opt, batch, required=True):
    """One train step under ``torch.profiler``: device busy seconds
    (kernel time summed) against the step's wall. Late in a long process
    the profiler has returned no device records: that fails the phase
    when ``required``, else the profile reads "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, met = step(model, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device and not required:
        return opt, met, {"profiled_wall_s": wall,
                          "idle_share": "not measured"}
    check(bool(device), "train (b): the profiler saw no device time")
    busy = sum(e.self_device_time_total for e in device) / 1e6
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return opt, met, {"profiled_wall_s": wall, "device_busy_s": busy,
                      "idle_share": 1 - busy / wall,
                      "top_kernels": [
                          {"name": e.key[:80], "count": e.count,
                           "total_ms": e.self_device_time_total / 1e3}
                          for e in top]}


def run_steps(cfg, init, batches, backend, witness=None, profile_last=False):
    """``TRAIN_STEPS`` steps of ``make_train_step`` from ``init``: the
    model, the metrics by step, the walls of the steps not profiled, and
    the profile of the last step (``profile_last``). ``witness`` watches
    the first step."""
    model = fresh_model(cfg, init)
    opt = adamw.init(dict(model.named_parameters()), error_feedback=True)
    step = train_steps.make_train_step(cfg, peak_lr=3e-4, warmup=0,
                                       total_steps=TRAIN_STEPS,
                                       backend=backend)
    metrics, walls, prof = [], [], None
    for i, batch in enumerate(batches):
        if profile_last and i == len(batches) - 1:
            opt, met, prof = step_profile(step, model, opt, batch)
        else:
            ctx = witness if (witness is not None and i == 0) \
                else contextlib.nullcontext()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                opt, met = step(model, opt, batch)
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in met.items()})
    return model, opt, metrics, walls, prof


def grads_at(cfg, init, batch, remat_kind):
    """Gradients of ``loss_fn`` at ``init`` under a remat policy, with
    the card's peak allocation over that one forward and backward."""
    model = fresh_model(dataclasses.replace(cfg, remat=remat_kind), init)
    model.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = lm.loss_fn(dataclasses.replace(cfg, remat=remat_kind), model,
                      batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    names = [n for n, _ in model.named_parameters()]
    del model, loss
    return dict(zip(names, grads)), peak


def train_codec_case(results, shape_leaf, planes, label, row):
    """Device time a launch of the codec at a training leaf (flat, ndim
    1): encode and decode beside their plain versions and bound, bit for
    bit. ``row`` keys the kernels line's row."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(shape_leaf, generator=gen, device="cuda") * 1e-3
    payload, emax = zfp_kernel.encode(x, planes, 1)
    rp, re = zfp_ref.encode_blocks(zfp_ref.blockify(x, 1), planes, 1)
    enc_ok = same_bits(payload, rp) and same_bits(emax, re)
    y = zfp_kernel.decode(payload, emax, shape_leaf, planes, 1)
    ry = zfp_ref.unblockify(zfp_ref.decode_blocks(rp, re, planes, 1),
                            shape_leaf, 1)
    dec_ok = same_bits(y, ry)
    del rp, re, ry
    nbytes = x.numel() * 4 + payload.numel() * 4 + emax.numel() * 4
    enc_fn = lambda: zfp_kernel.encode(x, planes, 1)
    dec_fn = lambda: zfp_kernel.decode(payload, emax, shape_leaf, planes, 1)
    out = {}
    for name, fn, plain, ok in (
            ("zfp_encode", enc_fn, lambda: zfp_ref.encode_blocks(
                zfp_ref.blockify(x, 1), planes, 1), enc_ok),
            ("zfp_decode", dec_fn, lambda: zfp_ref.unblockify(
                zfp_ref.decode_blocks(payload, emax, planes, 1), shape_leaf,
                1), dec_ok)):
        r = {"max_abs_err": 0.0 if ok else float("inf"),
             "ms": median_ms(fn, 10),
             **kernel_device_ms(fn, name.split("_")[1] + "_kernel", 10),
             "plain_ms": median_ms(plain, 3),
             "bound": bound_ms(nbytes)}
        emit({"phase": "train_codec", "leaf": label, "kernel": name,
              "shape": list(shape_leaf), "planes": planes, "ndim": 1,
              "bitwise": ok, "ms": r["ms"], "device_ms": r["device_ms"],
              "device_ms_by": r["device_ms_by"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
        check(ok, f"train: {name} differs from the plain codec at {label}")
        if row:
            results[(name, shape_leaf, planes)] = r
        out[name] = r
    del x, payload, emax, y
    torch.cuda.empty_cache()
    return out


def train_qwen(results):
    """(b) Qwen2-1.5B at full width, 4 of 28 layers, float32, compressed
    remat, 8-plane gradients with error feedback, batch 8 x 512 from
    ``SyntheticLM(seed=0)``, ``TRAIN_STEPS`` steps of ``make_train_step``
    from seeded random weights. Returns the steps' launches."""
    cfg = train_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    model = lm.init_params(cfg, gen, device="cuda")
    names = [n for n, _ in model.named_parameters()]
    init = [p.detach().clone() for p in model.parameters()]
    batches = train_batches(cfg)
    with torch.no_grad():
        loss_none = float(lm.loss_fn(dataclasses.replace(cfg, remat="none"),
                                     model, batches[0]))
    res_leaves, q_leaves = residual_leaves(model), quantized_leaves(model)
    del model
    torch.cuda.empty_cache()

    # the path: the steps on the kernels, counted from zero
    witness = CodecWitness()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    kmodel, kopt, kmet, walls, prof = run_steps(
        cfg, init, batches, "cuda", witness=witness, profile_last=True)
    counts = path_counts()
    peak = torch.cuda.max_memory_allocated()
    del kopt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pmodel, popt, pmet, pwalls, _ = run_steps(cfg, init, batches, "ref")
    replay_s = time.perf_counter() - t0
    param_diff = max(rel_leaf(a, b) for a, b in zip(kmodel.parameters(),
                                                    pmodel.parameters()))
    del kmodel, pmodel, popt
    torch.cuda.empty_cache()

    grads, peaks = {}, {}
    for kind in ("none", "full", "compressed"):
        g, peaks[kind] = grads_at(cfg, init, batches[0], kind)
        if kind != "full":
            grads[kind] = g
        del g
    dist = {k: float((grads["compressed"][k] - grads["none"][k]).norm()
                     / grads["none"][k].norm())
            for k in grads["none"]}
    del grads
    torch.cuda.empty_cache()

    tokens = TRAIN_BATCH * TRAIN_SEQ
    layer_raw = sum(n * 4 for n, _, _ in witness.residuals) / cfg.num_layers
    layer_packed = sum(b for _, b, _ in witness.residuals) / cfg.num_layers
    row = {"phase": "train_qwen", "arch": TRAIN_ARCH,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": sum(p.numel() for p in init),
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": cfg.remat,
           "grad_planes": TRAIN_PLANES, "loss_none_step1": loss_none,
           "losses": [m["loss"] for m in kmet],
           "gnorms": [m["gnorm"] for m in kmet],
           "lrs": [m["lr"] for m in kmet],
           "plain_losses": [m["loss"] for m in pmet],
           "plain_gnorms": [m["gnorm"] for m in pmet],
           "step_wall_s": walls, "tokens_per_s": [tokens / w for w in walls],
           f"step{TRAIN_STEPS}_profile": prof,
           "plain_step_wall_s": pwalls, "plain_replay_s": replay_s,
           "largest_param_rel_diff": param_diff,
           "residuals_step1": len(witness.residuals),
           "residual_bytes_per_layer": layer_packed,
           "residual_raw_bytes_per_layer": layer_raw,
           "quantized_grads_step1": len(witness.grads),
           "peak_allocated_bytes": peak, "peak_by_remat": peaks,
           "grad_rel_dist_compressed_vs_none": dist,
           "launches": {k: v for k, v in counts.items() if v}}
    emit(row)
    check(kmet[0]["loss"] == loss_none,
          f"train (b): step 1's loss {kmet[0]['loss']} is not remat none's "
          f"{loss_none}")
    check(len(witness.residuals) == res_leaves and all(
        ok for _, _, ok in witness.residuals),
          "train (b): a residual's payload differs from the plain codec's")
    check(len(witness.grads) == q_leaves and all(
        ok for _, ok in witness.grads),
          "train (b): a quantized gradient differs from ref.quantize")
    for a, b in zip(kmet, pmet):
        for k in ("loss", "gnorm"):
            check(abs(a[k] - b[k]) <= TRAIN_REPLAY_TOL * abs(b[k]),
                  f"train (b): {k} {a[k]} against the plain replay's {b[k]}")
    per_step = res_leaves + q_leaves
    for kind in ("encode", "decode"):
        check(counts.get(f"zfp_{kind} ndim1", 0) == per_step * TRAIN_STEPS
              == counts[f"zfp_{kind}"],
              f"train (b): {counts.get(f'zfp_{kind} ndim1')} {kind} "
              f"launches, not {per_step} a step")
    # the codec at the largest residual leaf (a layer's largest weight)
    # and at the largest gradient leaf (embed and lm_head)
    sizes = dict(zip(names, (p.numel() for p in init)))
    del init
    torch.cuda.empty_cache()
    largest_w = max(v for k, v in sizes.items() if k.startswith("layers."))
    train_codec_case(results, (largest_w,), lm.COMPRESSED_REMAT_PLANES,
                     "residual (largest weight)", row=False)
    train_codec_case(results, (max(sizes.values()),), TRAIN_PLANES,
                     "gradient (embed, lm_head)", row=True)
    return counts


def train_slice(results):
    """Phase train: (a) the launcher, (b) Qwen2-1.5B; the launches of
    both, counted from zero."""
    t0 = time.perf_counter()
    reset_counts()
    counts_a = train_launcher()
    torch.cuda.empty_cache()
    counts_b = train_qwen(results)
    counts = collections.Counter(counts_a)
    counts.update(counts_b)
    emit({"phase": "train_seconds", "seconds": time.perf_counter() - t0})
    return dict(counts)


# ----------------------------------------------------------------------
# phase 10s: training the ssm family
# ----------------------------------------------------------------------

TSSM_LAYERS, TSSM_HYB_LAYERS, TSSM_HYB_STEPS = 4, 12, 2
SSCAN_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_SEQ, 8192, 16)  # falcon-mamba's
# of each gradient's largest |value| in float64: the backward chains up
# to S decays of ex2.approx (~2 ulp each), ~1.2e-4 at S = 512, and sums
# over up to 8,192 channels in float32; 1e-3 leaves a factor ~8
SSCAN_BWD_TOL = 1e-3
SSCAN_BWD_SLICE = 2048  # channels a float64 reference pass


def device_ms_sum(fn, names, reps: int):
    """Device ms a call of ``fn``: the profiler's time of every kernel
    whose name holds one of ``names``, over ``reps`` calls; as
    ``kernel_device_ms``, three profiler windows, then CUDA events around
    ``reps`` back-to-back calls ("events_batch")."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(n in e.key for n in names)]
        if found:
            return {"device_ms": sum(e.self_device_time_total
                                     for e in found) / 1e3 / reps,
                    "device_ms_by": "profiler",
                    "device_kernels": sorted({e.key[:40] for e in found})}
    return {**events_batch_ms(fn, reps), "device_kernels": []}


def sscan_bwd_bound(bsz, s, d, n):
    """Bytes the backward must move: dt, x and dL/dy read, dx and ddt
    written (B, S, D); B and C read, dB and dC written (B, S, N); A read,
    dA written; dh0 written; the forward's saved states read once. Its
    operations: one exp and ~12 float32 operations a (b, t, d, n)."""
    nbytes = 4 * (5 * bsz * s * d + 4 * bsz * s * n + 2 * d * n
                  + bsz * d * n + bsz * -(-s // sscan_kernel.SAVE_EVERY)
                  * d * n)
    elems = bsz * s * d * n
    return nbytes, bound_ms(nbytes, 12 * elems, elems)


def scan_grads_f64(args, h0, gy, dtype):
    """Autograd of the plain scan in ``dtype``, ``SSCAN_BWD_SLICE``
    channels at a time (the channels are independent but for dB and dC,
    summed over the slices, and dA's sum over the batch, within one)."""
    dt, a, b_in, c_in, x = args
    d = x.shape[2]
    out = [None] * 6
    parts = []
    for lo in range(0, d, SSCAN_BWD_SLICE):
        sl = slice(lo, lo + SSCAN_BWD_SLICE)
        g = sscan_ref.selective_scan_bwd_ref(
            dt[:, :, sl].to(dtype), a[sl].to(dtype), b_in.to(dtype),
            c_in.to(dtype), x[:, :, sl].to(dtype), h0[:, sl].to(dtype),
            gy[:, :, sl].to(dtype), None, SSCAN_CHUNK)
        parts.append(g)
    for i, dim in ((0, 2), (1, 0), (4, 2), (5, 1)):
        out[i] = torch.cat([g[i] for g in parts], dim=dim)
    for i in (2, 3):
        out[i] = sum(g[i] for g in parts)
    return out


def sscan_train_cases(gen, results):
    """Row 6 at the training shape (the forward with its states) and row
    6b (the backward) against float64 autograd of the plain version."""
    shape = SSCAN_TRAIN_SHAPE
    bsz, s, d, n = shape
    args, h0 = sscan_inputs(shape, gen)
    gy = normal((bsz, s, d), gen, 1.0)
    states = torch.empty(sscan_kernel.states_shape(*shape), device="cuda")
    y_saved, _ = sscan_kernel.selective_scan(*args, h0, states_out=states)
    y_plain, _ = sscan_kernel.selective_scan(*args, h0)
    same_y = same_bits(y_saved, y_plain)
    del y_saved, y_plain
    got = sscan_kernel.selective_scan_bwd(*args, h0, states, gy)
    torch.cuda.synchronize()
    want = scan_grads_f64(args, h0, gy, torch.float64)
    names = ("dt", "a", "b_in", "c_in", "x", "h0")
    share = {k: float((g.double() - w).abs().max() / w.abs().max())
             for k, g, w in zip(names, got, want)}
    abs_err = max(float((g.double() - w).abs().max())
                  for g, w in zip(got, want))
    plain32 = scan_grads_f64(args, h0, gy, torch.float32)
    plain_share = {k: float((g.double() - w).abs().max() / w.abs().max())
                   for k, g, w in zip(names, plain32, want)}
    del want, plain32
    torch.cuda.empty_cache()
    nbytes, bound = sscan_bwd_bound(*shape)
    bwd = lambda: sscan_kernel.selective_scan_bwd(*args, h0, states, gy)
    plain = lambda: sscan_ref.selective_scan_bwd_ref(*args, h0, gy, None,
                                                     SSCAN_CHUNK)
    r = {"max_abs_err": abs_err, "ms": median_ms(bwd, 10),
         **device_ms_sum(bwd, ("sscan_bwd_kernel", "sum_parts_kernel"), 10),
         "plain_ms": median_ms(plain, 1), "bound": bound}
    results[("sscan_bwd", shape, SSCAN_CHUNK)] = r
    fwd = lambda: sscan_kernel.selective_scan(*args, h0, states_out=states)
    f_nbytes = sscan_bound(*shape)[0] + states.numel() * 4
    fr = {"max_abs_err": 0.0 if same_y else float("inf"),
          "ms": median_ms(fwd, 10),
          **kernel_device_ms(fwd, "sscan_kernel", 10),
          "plain_ms": median_ms(lambda: sscan_ref.selective_scan_ref(
              *args, h0, SSCAN_CHUNK), 2),
          "bound": bound_ms(f_nbytes, 6 * bsz * s * d * n + bsz * s * d,
                            bsz * s * d * n)}
    results[("sscan", shape, SSCAN_CHUNK)] = fr
    # the backward's kernels keep their stage in registers: no spill and no
    # stack frame; its residency, and the bytes of its partials (dB and
    # dC, one a BWD_CHANNELS-channel group, written and read once)
    bwd_ptxas = {k: kernel_ptxas("sscan", k)
                 for k in ("sscan_bwd_kernel", "sum_parts_kernel")}
    groups = -(-d // sscan_kernel.BWD_CHANNELS)
    emit({"phase": "kernel_vs_plain", "kernel": "sscan_bwd",
          "shape_bsdn": list(shape), "against": "float64 autograd of "
          "selective_scan_ref", "tol": SSCAN_BWD_TOL,
          "err_share_of_largest": share, "plain32_share": plain_share,
          "max_abs_err": abs_err, "ms": r["ms"], "device_ms": r["device_ms"],
          "device_kernels": r["device_kernels"], "plain_ms": r["plain_ms"],
          "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
          "bound_bytes": nbytes, "library_ms": None,
          "partial_bytes": 2 * 2 * 4 * bsz * groups * s * n,
          "residency": sscan_kernel.bwd_residency(), "ptxas": bwd_ptxas})
    for entry, ptxas in bwd_ptxas.items():
        check(len(ptxas) == 1 and ptxas[0].get("spill_stores", 0) == 0
              and ptxas[0].get("stack_frame", 0) == 0,
              f"sscan {entry} spills or keeps a stack frame: {ptxas}")
    emit({"phase": "kernel_vs_plain", "kernel": "sscan",
          "shape_bsdn": list(shape), "states_saved": True,
          "y_bitwise_unsaved": same_y, "ms": fr["ms"],
          "device_ms": fr["device_ms"], "plain_ms": fr["plain_ms"],
          "bound_ms": fr["bound"][0], "bound_by": fr["bound"][1],
          "bound_bytes": f_nbytes})
    check(same_y, "sscan: saving the states changed y")
    check(all(v <= SSCAN_BWD_TOL for v in share.values()),
          f"sscan_bwd: {share} of the largest float64 values, past "
          f"{SSCAN_BWD_TOL}")
    del args, h0, gy, states, got
    torch.cuda.empty_cache()


def tssm_setup(arch, layers, seed, steps):
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              dtype="float32", remat="compressed")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = lm.init_params(cfg, gen, device="cuda")
    init = [p.detach().clone() for p in model.parameters()]
    del model
    pipe = SyntheticLM(PipelineConfig(cfg.vocab_size, TRAIN_BATCH,
                                      TRAIN_SEQ, seed=0))
    batches = [{k: torch.from_numpy(v.copy()).cuda() for k, v in
                pipe.batch_at(i).items()} for i in range(steps)]
    return cfg, init, batches


def copy_state(dst_model, dst_opt, src_model, src_opt):
    """Copy weights and AdamW state (step, moments) in place."""
    with torch.no_grad():
        for a, b in zip(dst_model.parameters(), src_model.parameters()):
            a.copy_(b)
        dst_opt.step.copy_(src_opt.step)
        for k in src_opt.m:
            dst_opt.m[k].copy_(src_opt.m[k])
            dst_opt.v[k].copy_(src_opt.v[k])


def train_falcon():
    """(a), then (c) on its weights. Each kernel step is replayed first
    on the plain versions from the same weights and AdamW state (a copy
    of the run's): a replay that ran on by itself would leave the run
    once a step's float32 rounding differed, since AdamW's first steps
    move every weight by about the learning rate whatever the size of
    its gradient. Returns the kernel steps' launches."""
    cfg, init, batches = tssm_setup(SSM_ARCH, TSSM_LAYERS, SEED + 8,
                                    TRAIN_STEPS)

    def steps_for(backend):
        return train_steps.make_train_step(
            cfg, peak_lr=3e-4, warmup=0, total_steps=TRAIN_STEPS,
            backend=backend)

    kmodel = fresh_model(cfg, init)
    kopt = adamw.init(dict(kmodel.named_parameters()))
    pmodel = fresh_model(cfg, init)
    popt = adamw.init(dict(pmodel.named_parameters()))
    kstep, pstep = steps_for("cuda"), steps_for("ref")
    kmet, pmet, walls, pwalls, prof = [], [], [], [], None
    # the replay's copy of the state, resident through the kernel steps
    held = 4 * (sum(p.numel() for p in pmodel.parameters())
                + 2 * sum(t.numel() for t in popt.m.values()) + 1)
    peak = 0
    reset_counts()
    sscan_kernel.reset_launches()
    for i, batch in enumerate(batches):
        copy_state(pmodel, popt, kmodel, kopt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        popt, met = pstep(pmodel, popt, batch)
        torch.cuda.synchronize()
        pwalls.append(time.perf_counter() - t0)
        pmet.append({k: float(v) for k, v in met.items()})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if i == len(batches) - 1:
            kopt, met, prof = step_profile(kstep, kmodel, kopt, batch,
                                           required=False)
        else:
            t0 = time.perf_counter()
            kopt, met = kstep(kmodel, kopt, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        kmet.append({k: float(v) for k, v in met.items()})
        peak = max(peak, torch.cuda.max_memory_allocated() - held)
    counts = {**path_counts(), **sscan_kernel.launches}
    param_diff = max(rel_leaf(a, b) for a, b in zip(kmodel.parameters(),
                                                    pmodel.parameters()))
    del pmodel, popt
    torch.cuda.empty_cache()
    rmodel, ropt, rmet, _, _ = run_steps(cfg, init, batches, "cuda")
    bitwise = [m["loss"] for m in rmet] == [m["loss"] for m in kmet] and \
        [m["gnorm"] for m in rmet] == [m["gnorm"] for m in kmet] and all(
            torch.equal(a, b) for a, b in zip(kmodel.parameters(),
                                              rmodel.parameters()))
    del rmodel, ropt, kmodel, kopt
    torch.cuda.empty_cache()
    rules = train_rules(cfg, init, batches[0])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
    emit({"phase": "train_ssm_falcon", "arch": SSM_ARCH,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "ssm_state": cfg.ssm_state,
          "params": sum(p.numel() for p in init),
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": cfg.remat,
          "losses": [m["loss"] for m in kmet],
          "gnorms": [m["gnorm"] for m in kmet],
          "plain_losses": [m["loss"] for m in pmet],
          "plain_gnorms": [m["gnorm"] for m in pmet],
          "step_wall_s": walls, "tokens_per_s": [tokens / w for w in walls],
          f"step{TRAIN_STEPS}_profile": prof, "plain_step_wall_s": pwalls,
          "last_step_param_rel_diff": param_diff,
          "bitwise_run_to_run": bitwise, "peak_allocated_bytes": peak,
          "replay_state_bytes_not_in_peak": held,
          "launches_per_step": per_step, "rules_one_rank": rules,
          "launches": {k: v for k, v in counts.items() if v}})
    check(all(math.isfinite(m["loss"]) for m in kmet),
          "train_ssm (a): a loss is not finite")
    check(counts["sscan"] == 2 * cfg.num_layers * TRAIN_STEPS
          and counts["sscan_bwd"] == cfg.num_layers * TRAIN_STEPS,
          f"train_ssm (a): {counts['sscan']} scan and "
          f"{counts['sscan_bwd']} backward launches for {cfg.num_layers} "
          f"layers x {TRAIN_STEPS} steps")
    check(bitwise, "train_ssm (a): two runs of the steps differ")
    for a, b in zip(kmet, pmet):
        for k in ("loss", "gnorm"):
            check(abs(a[k] - b[k]) <= TRAIN_REPLAY_TOL * abs(b[k]),
                  f"train_ssm (a): {k} {a[k]} against the plain replay's "
                  f"{b[k]}")
    check(rules["bitwise"], "train_ssm (c): the step under use_rules on a "
                            "(1, 1) mesh differs from the step without")
    return counts


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_rules(cfg, init, batch):
    """(c) One step without rules, then one under ``use_rules`` on a
    (1, 1) ``launch.mesh`` mesh over a gloo group of one rank: the
    metrics and every weight bit for bit."""
    import torch.distributed as dist

    def one_step():
        model = fresh_model(cfg, init)
        opt = adamw.init(dict(model.named_parameters()))
        step = train_steps.make_train_step(cfg, peak_lr=3e-4, warmup=0,
                                           total_steps=1, backend="cuda")
        opt, met = step(model, opt, batch)
        return model, {k: float(v) for k, v in met.items()}

    plain_model, plain_met = one_step()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh_for_devices(1, 1)
        with sharding.use_rules(mesh, sharding.DEFAULT_RULES):
            ruled_model, ruled_met = one_step()
        dims = list(mesh.mesh_dim_names)
    finally:
        dist.destroy_process_group()
    same = ruled_met == plain_met and all(
        torch.equal(a, b) for a, b in zip(plain_model.parameters(),
                                          ruled_model.parameters()))
    del plain_model, ruled_model
    torch.cuda.empty_cache()
    return {"mesh": dims, "loss": ruled_met["loss"], "bitwise": same}


def train_hybrid():
    """(b) zamba2-2.7b at 12 of 54 layers. Returns the steps' launches."""
    cfg, init, batches = tssm_setup(HYB_ARCH, TSSM_HYB_LAYERS, SEED + 9,
                                    TSSM_HYB_STEPS)
    reset_counts()
    sscan_kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, opt, met, walls, _ = run_steps(cfg, init, batches, "cuda")
    counts = {**path_counts(), **sscan_kernel.launches}
    peak = torch.cuda.max_memory_allocated()
    shared_moved = all(not torch.equal(p, q) for (n, p), q in zip(
        model.named_parameters(), init) if n.startswith("shared_attn."))
    emit({"phase": "train_ssm_hybrid", "arch": HYB_ARCH,
          "layers": cfg.num_layers, "groups": cfg.num_layers
          // cfg.attn_period, "d_model": cfg.d_model,
          "params": sum(p.numel() for p in init),
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "remat": cfg.remat,
          "losses": [m["loss"] for m in met],
          "gnorms": [m["gnorm"] for m in met], "step_wall_s": walls,
          "peak_allocated_bytes": peak, "shared_block_trained": shared_moved,
          "launches": {k: v for k, v in counts.items() if v}})
    check(all(math.isfinite(m["loss"]) for m in met),
          "train_ssm (b): a loss is not finite")
    check(counts["sscan"] == counts["sscan_bwd"] == 0,
          "train_ssm (b): the hybrid launched the Mamba-1 scan")
    check(shared_moved, "train_ssm (b): the shared block did not train")
    check(counts.get("zfp_encode ndim1", 0)
          == counts.get("zfp_decode ndim1", 0) > 0,
          "train_ssm (b): compressed remat's codec launches do not pair")
    del model, opt, init
    torch.cuda.empty_cache()
    return counts


def train_ssm_slice(results):
    """Phase train_ssm: the backward kernel's case, (a) with (c), (b);
    the launches of (a) and (b), counted from zero."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    sscan_train_cases(gen, results)
    gc.collect()
    torch.cuda.empty_cache()
    counts_a = train_falcon()
    gc.collect()
    torch.cuda.empty_cache()
    counts_b = train_hybrid()
    counts = collections.Counter(counts_a)
    counts.update(counts_b)
    emit({"phase": "train_ssm_seconds", "seconds": time.perf_counter() - t0})
    return dict(counts)


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
    live_counts, live_rows = live_slice(fields, ref2, sync4, sync_rows, bt1)
    emit({"phase": "launches", "path": "ooc_live", **live_counts})
    for name in ("zfp_encode", "zfp_decode", "wave_multistep", "wave_step"):
        check(live_counts[name] > 0,
              f"the live engine never launched {name}")
    del ref2
    torch.cuda.empty_cache()
    reset_counts()
    ckpt_counts = ckpt_slice(fields, sync4, bt1, live_rows)
    emit({"phase": "launches", "path": "ooc_ckpt", **ckpt_counts})
    for name in ("zfp_encode", "zfp_decode", "wave_multistep", "wave_step",
                 "zfp_encode ndim1", "zfp_decode ndim1"):
        check(ckpt_counts.get(name, 0) > 0,
              f"the checkpoint phase never launched {name}")
    torch.cuda.empty_cache()
    shard_counts = sharded_slice(fields, sync4, bt1, live_rows)
    emit({"phase": "launches", "path": "ooc_sharded", **shard_counts})
    for name in ("zfp_encode", "zfp_decode", "wave_multistep", "wave_step",
                 "zfp_encode_f64", "zfp_decode_f64", "wave_multistep_f64"):
        check(shard_counts.get(name, 0) > 0,
              f"the sharded phase never launched {name}")
    torch.cuda.empty_cache()
    tenant_counts = tenancy_slice(fields, sync4, bt1, live_rows)
    emit({"phase": "launches", "path": "ooc_tenancy", **tenant_counts})
    for name in ("zfp_encode", "zfp_decode", "wave_multistep", "wave_step"):
        check(tenant_counts.get(name, 0) > 0,
              f"the tenancy phase never launched {name}")
    del fields, sync4, bt1
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
    ssm_counts = ssm_slice()
    emit({"phase": "launches", "path": "ssm_serving", **ssm_counts})
    gc.collect()
    torch.cuda.empty_cache()

    moe_counts = moe_slice()
    emit({"phase": "launches", "path": "moe_serving", **moe_counts})
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_counts = hybrid_slice()
    emit({"phase": "launches", "path": "hybrid_serving", **hybrid_counts})
    emb_counts = embeds_slice()
    for path, c in emb_counts.items():
        emit({"phase": "launches", "path": path, **c})

    train_counts = train_slice(results)
    emit({"phase": "launches", "path": "train", **train_counts})
    for name in ("zfp_encode ndim1", "zfp_decode ndim1"):
        check(train_counts.get(name, 0) > 0,
              f"the train phase never launched {name}")
    cfg = train_config()
    grad_leaf = (cfg.vocab_size * cfg.d_model,)
    gc.collect()
    torch.cuda.empty_cache()
    train_ssm_counts = train_ssm_slice(results)
    emit({"phase": "launches", "path": "train_ssm", **train_ssm_counts})
    for name in ("sscan", "sscan_bwd", "zfp_encode ndim1",
                 "zfp_decode ndim1"):
        check(train_ssm_counts.get(name, 0) > 0,
              f"the train_ssm phase never launched {name}")

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
        ("zfp_encode_f64", "zfp_encode_f64",
         "src/repro/kernels/zfp/kernel.py:90",
         "src/repro_torch/csrc/zfp64.cu", (PREC_UNIT, 24)),
        ("zfp_decode_f64", "zfp_decode_f64",
         "src/repro/kernels/zfp/kernel.py:133",
         "src/repro_torch/csrc/zfp64.cu", (PREC_UNIT, 24)),
        ("wave_step_f64", "wave_step_f64",
         "src/repro/kernels/stencil/kernel.py:69",
         "src/repro_torch/csrc/stencil64.cu", (PREC_SHAPE, 1)),
        ("wave_multistep_f64", "wave_multistep_f64",
         "src/repro/kernels/stencil/kernel.py:149",
         "src/repro_torch/csrc/stencil64.cu", (BLOCK, BT)),
        ("wave_multistep_f64", "wave_multistep_f64",
         "src/repro/kernels/stencil/kernel.py:149",
         "src/repro_torch/csrc/stencil64.cu", (PREC_SHAPE, 1)),
    ]
    rows += [
        ("zfp_encode", "zfp_encode", "src/repro/kernels/zfp/kernel.py:90",
         "src/repro_torch/csrc/zfp.cu", (grad_leaf, TRAIN_PLANES)),
        ("zfp_decode", "zfp_decode", "src/repro/kernels/zfp/kernel.py:133",
         "src/repro_torch/csrc/zfp.cu", (grad_leaf, TRAIN_PLANES)),
    ]
    rows.append(("cdecode", "cdecode", "src/repro/kernels/cdecode/kernel.py:90",
                 "src/repro_torch/csrc/cdecode.cu",
                 ((CD_SLOTS, CD_KVH, CTX), (16, CD_LENGTHS[0]))))
    rows.append(("sscan", "sscan", "src/repro/kernels/sscan/kernel.py:66",
                 "src/repro_torch/csrc/sscan.cu",
                 (SSCAN_SHAPES[0], SSCAN_CHUNK)))
    rows.append(("sscan", "sscan", "src/repro/kernels/sscan/kernel.py:66",
                 "src/repro_torch/csrc/sscan.cu",
                 (SSCAN_TRAIN_SHAPE, SSCAN_CHUNK)))
    # the backward has no TPU kernel (the reference differentiates the
    # XLA scan): its row names the function it differentiates
    rows.append(("sscan_bwd", "sscan_bwd",
                 "src/repro/kernels/sscan/kernel.py:66",
                 "src/repro_torch/csrc/sscan.cu",
                 (SSCAN_TRAIN_SHAPE, SSCAN_CHUNK)))
    paths = {"ooc_wave": counts, "ooc_live": live_counts,
             "ooc_ckpt": ckpt_counts, "ooc_sharded": shard_counts,
             "ooc_tenancy": tenant_counts,
             "ooc_f64": f64_counts, "ooc_live_f64": live64_counts,
             "precision": prec_counts, "serving": serve_counts,
             "ssm_serving": ssm_counts, "moe_serving": moe_counts,
             "hybrid_serving": hybrid_counts, **emb_counts,
             "train": train_counts, "train_ssm": train_ssm_counts}
    # the float32 codec's rows time the ndim-3 unit and give their launches
    # by ndim (the lossy checkpoint leaves at 1, the KV cache at 2), and
    # the training path's gradient leaf at ndim 1;
    # a kernel with two rows: each row counts the paths that launch it at
    # its shape (the float64 rung on the engines' blocks, 1152^2 and
    # 576^2 planes, the sharded engine's included, and on the precision
    # tier's; the float64 codec on the engines' units and on the precision
    # tier's, both rates), so no launch counts twice
    engines64 = ("ooc_f64", "ooc_live_f64", "ooc_sharded")
    prec = ("precision",)
    # the float32 codec: the training leaf's row counts the training
    # paths, the unit's row every other path; the scan's decode row the
    # serving paths, its training row path train_ssm
    trained = ("train", "train_ssm")
    untrained = tuple(p for p in paths if p not in trained)
    row_paths = {("zfp_encode", UNIT): untrained,
                 ("zfp_decode", UNIT): untrained,
                 ("zfp_encode", grad_leaf): trained,
                 ("zfp_decode", grad_leaf): trained,
                 ("sscan", SSCAN_SHAPES[0]): tuple(
                     p for p in paths if p != "train_ssm"),
                 ("sscan", SSCAN_TRAIN_SHAPE): ("train_ssm",),
                 ("wave_multistep_f64", BLOCK): engines64,
                 ("wave_multistep_f64", PREC_SHAPE): prec,
                 ("zfp_encode_f64", UNIT): engines64,
                 ("zfp_encode_f64", PREC_UNIT): prec,
                 ("zfp_decode_f64", UNIT): engines64,
                 ("zfp_decode_f64", PREC_UNIT): prec}
    kernels = []
    for name, counter, replaces, source, (shape, arg) in rows:
        r = results[(name, shape, arg)]
        by_path = {p: c.get(counter, 0) for p, c in paths.items()
                   if p in row_paths.get((name, shape), paths)}
        # the codec's rows: their launches by unit and planes (float64)
        # or by ndim (float32); the times are of the row's own shape
        by_shape = collections.Counter()
        for p in by_path:
            by_shape.update({k[len(counter) + 1:]: v
                             for k, v in paths[p].items()
                             if k.startswith(counter + " ")})
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
            **({"launches_by_shape": dict(by_shape)} if by_shape else {}),
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the path")
        check(sum(k.get("launches_by_shape", {}).values()) in (
            0, k["launches"]), f"{k['name']}: its launches by shape do not "
                               f"add up to {k['launches']}")
    for name in {row[1] for row in rows}:
        total = sum(c.get(name, 0) for c in paths.values())
        rowed = sum(k["launches"] for k in kernels if k["name"] == name)
        check(rowed == total, f"{name}: the rows count {rowed} launches of "
                              f"{total}")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

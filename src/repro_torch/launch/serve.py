"""Serving launcher: batched decode with the continuous-batching engine,
or (``--ooc``) the multi-tenant out-of-core stencil scheduler.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 6 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --no-smoke --slots 8 --requests 8 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-235b-a22b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --no-smoke --slots 8 --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --ooc --tenants 3 \
      --shape 192 1152 1152 --blocks 4 --sweeps 2

``--arch`` takes a config of the dense family (raw KV cache), of the
MoE family (qwen3-moe-235b-a22b, llama4-scout-17b-a16e: each step's
tokens routed to their top-k experts, with no drop at decode), of the
ssm family (falcon-mamba: per-slot ``conv`` and ``h`` states, the
selective-scan kernel on every layer and step) or the hybrid
(zamba2-2.7b: Mamba-2 states a layer and the shared block's raw K/V a
group). The audio and vision-language configs (musicgen-medium,
qwen2-vl-7b) take embeddings, which the engine does not feed (the
reference's neither): the launcher stops with the engine's message
before it makes any weights. The flags are the
reference launcher's (``repro.launch.serve``), plus
``--no-smoke`` (the full-width config) and ``--device``. It runs on the
CUDA device unless ``--device cpu`` is given. Weights are random, from a
seeded generator.

``--ooc`` runs ``--tenants`` out-of-core stencil runs of ``--shape``
(code 2, ndiv ``--blocks``, bt 1, ``--sweeps`` sweeps; schedules depth2,
temporal2 and unitgrain in turn) through ``serving.ooc.TenantScheduler``
under one residency budget of ``--budget-mult`` times the largest
working set, with queued admission; tenant 0 is the latency tenant
(priority 10, its working set reserved), the rest batch tenants.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_config, smoke
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine, check_servable


def run_ooc(args):
    """Multi-tenant out-of-core serving: N stencil runs on one device
    budget, arbitrated by ``serving.ooc.TenantScheduler``. Tenant 0 is
    the latency tenant (priority 10, its working set reserved), the rest
    batch tenants (priority 0, burst only). Returns the scheduler."""
    from repro_torch.core.outofcore import OOCConfig, paper_code_fields
    from repro_torch.core.tenancy import working_set_bytes
    from repro_torch.serving.ooc import TenantScheduler

    dev = device_mod.resolve(args.device)
    shape = tuple(args.shape)
    schedules = ["depth2", "temporal2", "unitgrain"]
    cfgs, specs = [], []
    for i in range(args.tenants):
        cfg = OOCConfig(shape, args.blocks, 1, paper_code_fields(2))
        sched_name = schedules[i % len(schedules)]
        cfgs.append((cfg, sched_name))
        specs.append(working_set_bytes(cfg, sched_name))
    budget = int(args.budget_mult * max(specs))
    eng = TenantScheduler(budget, admission="queue", device=dev)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for i, (cfg, sched_name) in enumerate(cfgs):
        p_prev = rng.standard_normal(shape).astype(np.float32)
        p_cur = rng.standard_normal(shape).astype(np.float32)
        vel2 = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        status = eng.submit(
            f"t{i}", cfg, p_prev, p_cur, vel2, schedule=sched_name,
            sweeps=args.sweeps,
            reserve=specs[i] if i == 0 else 0,
            priority=10 if i == 0 else 0,
        )
        print(f"tenant t{i}: {sched_name}, ws={specs[i]}B -> {status}")
    eng.run()
    dt = time.time() - t0
    st = eng.stats()
    print(f"{args.tenants} tenants, budget {budget}B, {dt:.2f}s wall "
          f"({dev})")
    for name, ts in sorted(st["per_tenant"].items()):
        print(
            f"  {name}: sweeps={ts['sweeps_done']} hits={ts['hits']} "
            f"evictions={ts['evictions']} peak={ts['peak_bytes']}B "
            f"restarts={ts['restarts']}"
        )
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--ooc", action="store_true",
                    help="multi-tenant out-of-core stencil serving")
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--sweeps", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--budget-mult", type=float, default=1.5)
    ap.add_argument("--shape", type=int, nargs=3, default=[32, 8, 8])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.ooc:
        return run_ooc(args)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    try:
        check_servable(cfg)
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from e
    dev = device_mod.resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    eng = ServeEngine(
        cfg, params, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature, device=dev,
    )
    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        prompt = rng.integers(
            1, cfg.vocab_size, size=rng.integers(2, 9)
        ).tolist()
        eng.submit(prompt, max_new=args.max_new)
    done = eng.run_all()
    dt = time.time() - t0
    toks = sum(len(v) for v in done.values())
    for rid, out in sorted(done.items()):
        print(f"request {rid}: {out}")
    print(f"{toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s, "
          f"{args.slots} slots, {dev})")


if __name__ == "__main__":
    main()

"""Serving launcher: batched decode with the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 6 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --no-smoke --slots 8 --requests 8 --max-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
      --no-smoke --slots 8 --requests 8

``--arch`` takes a config of the dense family (raw KV cache) or of the
ssm family (falcon-mamba: per-slot ``conv`` and ``h`` states, the
selective-scan kernel on every layer and step). The flags are the
reference launcher's (``repro.launch.serve``), plus
``--no-smoke`` (the full-width config) and ``--device``. It runs on the
CUDA device unless ``--device cpu`` is given. Weights are random, from a
seeded generator. ``--ooc`` (multi-tenant out-of-core serving) is not
ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs import get_config, smoke
from repro_torch.models import model as M
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> None:
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
        raise NotImplementedError(
            "--ooc (multi-tenant out-of-core serving) is not ported yet: "
            "ROADMAP.md queue 1 item 12 (tenancy and serving)")

    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
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

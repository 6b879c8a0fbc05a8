"""End-to-end training entry point.

Wires together the data pipeline, the model, AdamW and its schedule,
atomic checkpointing with resume, heartbeat logging, optional
compressed gradients and compressed activation remat, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --preset lm-100m \\
      --steps 300 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 10 --batch 8 --seq 512          # any dense arch, reduced
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm-tiny \\
      --steps 6 --device cpu

Port of ``repro.launch.train``: the same flags with the same meanings,
plus ``--device`` (the CUDA device unless ``--device cpu``; the CPU runs
the plain codec). There is no mesh: the port trains on one device.
Checkpoints hold ``(params, AdamWState)`` in the reference's trees
(``convert.params_to_reference``, per-layer leaves stacked ``(L, ...)``)
through the port's ``checkpoint.save``, so a checkpoint of either
package resumes in the other. ``main(argv)`` returns the final
``TrainRun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import convert
from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import get_config, smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM
from repro_torch.distributed import fault
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.optim import adamw

PRESETS = {
    # ~100M-parameter LM, the end-to-end trainer's target
    "lm-100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=640,
        num_heads=10, num_kv_heads=2, head_dim=64, d_ff=2560,
        vocab_size=32000, rope_theta=1e4, dtype="float32",
        attn_chunk=256, remat="none",
    ),
    "lm-tiny": ModelConfig(
        name="lm-tiny", family="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, head_dim=32, d_ff=512,
        vocab_size=512, rope_theta=1e4, dtype="float32",
        attn_chunk=64, remat="none",
    ),
}


class TrainRun(NamedTuple):
    """What ``main`` ends with: the config, the trained model, the
    optimizer state, and one ``(step, loss, gnorm, lr)`` a step run."""

    cfg: ModelConfig
    model: M.Model
    opt: adamw.AdamWState
    history: List[tuple]


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--preset", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduce an --arch config for CPU")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain codec)")
    args = ap.parse_args(argv)
    if not args.preset and not args.arch:
        ap.error("one of --preset or --arch is required")
    return args


def config_for(args) -> ModelConfig:
    if args.preset:
        cfg = PRESETS[args.preset]
    else:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = smoke(cfg)
        cfg = dataclasses.replace(cfg, dtype="float32", remat="none")
    if args.grad_compress:
        cfg = dataclasses.replace(
            cfg, grad_compress_planes=args.grad_compress)
    return cfg


def _batch(pipe: SyntheticLM, step: int, device: torch.device):
    return {k: torch.from_numpy(v.copy()).to(device)
            for k, v in pipe.batch_at(step).items()}


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    cfg = config_for(args)
    dev = device_mod.resolve(args.device)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    pipe = SyntheticLM(
        PipelineConfig(cfg.vocab_size, args.batch, args.seq, seed=0))
    step_fn = ST.make_train_step(
        cfg, peak_lr=args.lr, warmup=min(100, args.steps // 10 + 1),
        total_steps=max(args.steps, 2),
    )
    opt = adamw.init(dict(model.named_parameters()),
                     error_feedback=bool(args.grad_compress))
    start = 0
    if args.resume and args.ckpt_dir:
        path = CKPT.latest(args.ckpt_dir)
        if path:
            like = (convert.params_to_reference(model),
                    convert.opt_state_to_reference(opt))
            start, (params_np, opt_np) = CKPT.restore(path, like,
                                                      device=dev)
            model = convert.params_from_reference(cfg, params_np, dev)
            opt = convert.opt_state_from_reference(model, opt_np)
            print(f"resumed from {path} at step {start}")
    mon = fault.HeartbeatMonitor(1)
    history: List[tuple] = []
    t0 = time.time()
    for s in range(start, args.steps):
        opt, metrics = step_fn(model, opt, _batch(pipe, s, dev))
        mon.beat(0, s, time.time())
        history.append((s, float(metrics["loss"]), float(metrics["gnorm"]),
                        float(metrics["lr"])))
        if s % max(1, args.steps // 20) == 0 or s == args.steps - 1:
            print(
                f"step {s:5d} loss {history[-1][1]:.4f} "
                f"gnorm {history[-1][2]:.3f} "
                f"lr {history[-1][3]:.2e} "
                f"({(time.time()-t0):.1f}s)"
            )
        if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
            path = CKPT.save(
                args.ckpt_dir, s + 1,
                (convert.params_to_reference(model),
                 convert.opt_state_to_reference(opt)),
            )
            print(f"checkpointed -> {path}")
    print("done")
    return TrainRun(cfg, model, opt, history)


if __name__ == "__main__":
    main()

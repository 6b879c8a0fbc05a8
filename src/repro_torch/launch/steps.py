"""Train, prefill and decode steps, and meta-device input specs.

Port of ``repro.launch.steps``. A step is an eager function of the model
(an ``nn.Module``, updated in place by training) rather than a jitted
function of a parameter tree. ``input_specs`` returns tensors on the
``meta`` device (shapes and types, no allocation) for every
(architecture x shape) cell. The mesh half of the reference module
(``shardings_for``, ``donate_argnums_for``, ``cache_specs``,
``batch_logical_axes``) is not ported: ROADMAP.md queue 1 item 21.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import collectives
from repro_torch.models import model as M
from repro_torch.optim import adamw, schedule

# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins, no allocation)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _positions_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    if cfg.mrope_sections:
        return _meta((3, b, s), torch.int32)
    return _meta((b, s), torch.int32)


def _tokens_spec(cfg: ModelConfig, b: int, s: int) -> torch.Tensor:
    if cfg.embeds_input:
        return _meta((b, s, cfg.d_model), M.dtype_of(cfg))
    return _meta((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {
            "tokens": _tokens_spec(cfg, b, s),
            "labels": _meta((b, s), torch.int32),
            "positions": _positions_spec(cfg, b, s),
        }
    if shape.kind == "prefill":
        return {
            "tokens": _tokens_spec(cfg, b, s),
            "positions": _positions_spec(cfg, b, s),
        }
    # decode: one new token against a seq_len cache
    return {
        "tokens": _tokens_spec(cfg, b, 1),
        "positions": _positions_spec(cfg, b, 1),
    }


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 10_000,
                    backend: Optional[str] = None):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``:
    the loss and its gradients (the config's remat), the compressed
    gradients with error feedback when ``cfg.grad_compress_planes``,
    then AdamW at the schedule's rate for the step; the model's
    parameters are updated in place (``requires_grad`` is turned on for
    them). ``metrics`` holds ``loss``, ``gnorm`` and ``lr`` as 0-d
    tensors. ``backend`` picks the codec of the compressed remat and
    gradients (default: the kernels on a CUDA device)."""

    def train_step(model: M.Model, opt_state: adamw.AdamWState, batch):
        lr = schedule.warmup_cosine(
            opt_state.step, peak_lr=peak_lr, warmup=warmup,
            total=total_steps,
        )
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss = M.loss_fn(cfg, model, batch, backend=backend)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        if cfg.grad_compress_planes:
            grads, opt_state = collectives.compress_grads(
                grads, opt_state, planes=cfg.grad_compress_planes,
                backend=backend,
            )
        _, new_state, gnorm = adamw.update(grads, opt_state, params, lr=lr)
        return new_state, {"loss": loss.detach(), "gnorm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, backend: Optional[str] = None):
    def prefill_step(model: M.Model, batch):
        return M.prefill(cfg, model, batch["tokens"], batch["positions"],
                         backend=backend)

    return prefill_step


def make_decode_step(cfg: ModelConfig, backend: Optional[str] = None):
    def decode_step(model: M.Model, cache, batch):
        # the KV/SSM cache is updated in place: it dominates device memory
        return M.decode_step(cfg, model, cache, batch["tokens"],
                             batch["positions"], backend=backend)

    return decode_step


def step_for(cfg: ModelConfig, shape: ShapeSpec):
    if shape.kind == "train":
        return make_train_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)

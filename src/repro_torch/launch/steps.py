"""Train, prefill and decode steps, and meta-device input specs.

Port of ``repro.launch.steps``. A step is an eager function of the model
(an ``nn.Module``, updated in place by training) rather than a jitted
function of a parameter tree. ``input_specs``, ``cache_specs`` and the
specs ``shardings_for`` returns are tensors on the ``meta`` device
(shapes and types, no allocation) for every (architecture x shape) cell.
``shardings_for`` gives the DTensor placements of a step's arguments
over a mesh (``distributed.sharding``); ``donate_argnums_for`` names the
arguments a step updates in place (the reference donates them).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
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


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of ``shape`` as ``meta`` tensors."""
    return M.init_cache(cfg, shape.global_batch, max_len=shape.seq_len,
                        device="meta")


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec):
    tok = ("batch", "seq", "embed") if cfg.embeds_input else ("batch", "seq")
    pos = (None, "batch", "seq") if cfg.mrope_sections else ("batch", "seq")
    if shape.kind == "train":
        return {"tokens": tok, "labels": ("batch", "seq"), "positions": pos}
    return {"tokens": tok, "positions": pos}


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


# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------


def shardings_for(cfg: ModelConfig, shape: ShapeSpec, mesh, rules):
    """Returns (placements of the step's arguments, their ``meta``
    specs): (params, opt_state, batch) for train, (params, cache, batch)
    for decode, (params, batch) for prefill; each leaf's placements are
    ``sharding.named_sharding_tree``'s."""
    specs = input_specs(cfg, shape)
    batch_shardings = SH.named_sharding_tree(
        batch_logical_axes(cfg, shape), specs, mesh, rules)
    param_axes = M.param_logical_axes(cfg)
    param_specs = M.param_specs(cfg)
    param_shardings = SH.named_sharding_tree(param_axes, param_specs, mesh,
                                             rules)
    if shape.kind == "train":
        opt_axes = adamw.state_logical_axes(param_axes)
        opt_specs = adamw.init(param_specs_to_zeros(param_specs))
        opt_shardings = SH.named_sharding_tree(opt_axes, opt_specs, mesh,
                                               rules)
        return (
            (param_shardings, opt_shardings, batch_shardings),
            (param_specs, opt_specs, specs),
        )
    if shape.kind == "decode":
        c_specs = cache_specs(cfg, shape)
        c_shardings = SH.named_sharding_tree(
            M.cache_logical_axes(cfg), c_specs, mesh, rules)
        return (
            (param_shardings, c_shardings, batch_shardings),
            (param_specs, c_specs, specs),
        )
    return (param_shardings, batch_shardings), (param_specs, specs)


def donate_argnums_for(shape: ShapeSpec):
    """train: params and opt state (updated in place); decode: the
    cache."""
    if shape.kind == "train":
        return (0, 1)
    if shape.kind == "decode":
        return (1,)
    return ()


def param_specs_to_zeros(param_specs: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Zeros shaped like each spec, on the spec's device (``meta``: no
    allocation)."""
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=s.device)
            for k, s in param_specs.items()}

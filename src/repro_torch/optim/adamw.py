"""AdamW with float32 moments and an optional error-feedback buffer.

Port of ``repro.optim.adamw``. Parameters, gradients and the state's
moments are name -> tensor mappings in ``Model.named_parameters()``
order (the reference's are trees of ``(L, ...)`` stacks;
``convert.opt_state_to_reference`` and ``opt_state_from_reference``
carry a state across). ``update`` keeps the reference's order of
operations and writes parameters and moments **in place**. The
error-feedback buffer ``ef`` serves compressed gradients
(``repro_torch.distributed.collectives``). ``state_logical_axes``: the
moments take their parameters' logical sharding axes
(``distributed.sharding``).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Tensors
    v: Tensors
    ef: Optional[Tensors] = None  # error-feedback residual (compressed sync)


def init(params: Mapping[str, torch.Tensor],
         error_feedback: bool = False) -> AdamWState:
    """Zero moments (float32, on each parameter's device) and step 0."""
    zeros = lambda: {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=zeros(), v=zeros(), ef=zeros() if error_feedback else None,
    )


def state_logical_axes(param_axes, error_feedback: bool = False
                       ) -> AdamWState:
    """The state's logical axes: the moments (and ``ef``) inherit their
    parameters' (``models.model.param_logical_axes``), ``step`` is a
    scalar."""
    return AdamWState(
        step=(),
        m=param_axes,
        v=param_axes,
        ef=param_axes if error_feedback else None,
    )


@torch.no_grad()
def update(
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
    params: Mapping[str, torch.Tensor],
    *,
    lr: Union[torch.Tensor, float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """One AdamW step with global-norm clipping. Returns ``(params,
    new_state, grad_norm)``: ``params`` and the moments are updated in
    place (the same mappings come back), the step count is a new
    tensor."""
    gf = {k: g.to(torch.float32) for k, g in grads.items()}
    dev = state.step.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in gf.values():
        total = total + torch.sum(torch.square(g))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    for k, p in params.items():
        g = gf[k] * scale
        m, v = state.m[k], state.v[k]
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + (
            weight_decay * p.to(torch.float32))
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.m, state.v, state.ef), gnorm

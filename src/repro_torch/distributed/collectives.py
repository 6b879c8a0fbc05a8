"""Compressed gradients with error feedback (the paper's technique on
the gradient exchange).

Port of ``repro.distributed.collectives``. As in the reference, no
collective runs here: under GSPMD the reference applies the
error-feedback quantisation to the *summed* gradient, which on one
device is the gradient itself, so the port quantizes that and needs no
``torch.distributed``. The quantisation is ``zfp_ops.quantize`` at
ndim 1, through the encode and decode kernels on a CUDA device.

The reference quantizes each leaf of its parameter tree, a per-layer
leaf as one flat ``(L, ...)`` stack. ``compress_grads`` gives the
stack's numbers: it concatenates the layers' pieces of each leaf
(``models.model.stacked_leaves``), quantizes the concatenation and
splits it back, so 4-value blocks straddle layers where the reference's
do, and a stack of at least 64 values is quantized even when one
layer's piece is smaller.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import backend_for
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp.ref import bits_per_value
from repro_torch.models.model import stacked_leaves
from repro_torch.optim.adamw import AdamWState

MIN_VALUES = 64  # smaller leaves cross raw, as in the reference


def quantize_leaf(g: torch.Tensor, planes: int, *,
                  backend: Optional[str] = None) -> torch.Tensor:
    """One leaf through the fixed-rate codec at ndim 1 (flat, in
    float32), back in its own shape and type; integer leaves and leaves
    under 64 values unchanged. ``backend`` defaults to the kernels on a
    CUDA tensor and the plain codec on the CPU."""
    if not g.is_floating_point() or g.numel() < MIN_VALUES:
        return g
    flat = g.reshape(-1).to(torch.float32)
    q = zfp_ops.quantize(flat, planes=planes, ndim=1,
                         backend=backend_for(g, backend))
    return q.reshape(g.shape).to(g.dtype)


def _quantize_stacked(parts, planes: int, backend: Optional[str]):
    """``quantize_leaf`` of the concatenation of ``parts``, split back."""
    if len(parts) == 1:
        return [quantize_leaf(parts[0], planes, backend=backend)]
    flat = torch.cat([p.reshape(-1) for p in parts])
    q = quantize_leaf(flat, planes, backend=backend)
    return [piece.view(p.shape) for piece, p in
            zip(q.split([p.numel() for p in parts]), parts)]


def compress_grads(
    grads: Mapping[str, torch.Tensor], opt_state: AdamWState, planes: int,
    *, backend: Optional[str] = None,
) -> Tuple[Dict[str, torch.Tensor], AdamWState]:
    """Error-feedback fixed-rate gradient compression. With
    ``opt_state.ef`` each gradient plus its carried residual is
    quantized, and the residual becomes what the quantisation dropped
    (``ef`` is written in place); without it, the gradients are
    quantized alone. Returns ``(quantized grads, state)``."""
    out: Dict[str, torch.Tensor] = {}
    for names in stacked_leaves(grads).values():
        gs = [grads[k] for k in names]
        if opt_state.ef is None:
            out.update(zip(names, _quantize_stacked(gs, planes, backend)))
            continue
        tots = [g.to(torch.float32) + opt_state.ef[k]
                for g, k in zip(gs, names)]
        qs = _quantize_stacked(tots, planes, backend)
        for k, g, tot, q in zip(names, gs, tots, qs):
            out[k] = q.to(g.dtype)
            opt_state.ef[k].copy_(tot - q.to(torch.float32))
    return {k: out[k] for k in grads}, opt_state


def wire_ratio(planes: int, dtype_bits: int = 32) -> float:
    """Collective-byte scale factor for the roofline variant."""
    return bits_per_value(1, planes) / dtype_bits

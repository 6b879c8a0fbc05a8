"""Compressed activation checkpointing: the paper's technique applied to
the training memory boundary.

``torch.utils.checkpoint`` trades memory for recompute;
``compressed_checkpoint`` trades it for codec throughput instead: the
forward pass saves *fixed-rate ZFP-compressed* residuals and the
backward pass decompresses them and recomputes the function from them.

Port of ``repro.core.remat``. As there, the residuals are **all** the
function's tensor arguments, each float leaf of 64 values or more coded
flat at ndim 1 (smaller leaves are kept raw): for a decoder layer the
carried hidden state *and the layer's weights*, so the backward pass
differentiates at the weights' 12-plane round trip (the reference's
design, kept; ROADMAP.md §3). The codec runs on the tensors' device: the
encode and decode kernels on a CUDA device, the plain codec on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.device import backend_for
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp.ref import Compressed

MIN_VALUES = 64  # smaller leaves are saved raw, as in the reference


def _compressible(x) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and x.numel() >= MIN_VALUES)


def _tree_map(fn, tree, is_leaf=lambda t: False):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, t, is_leaf) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


class ZfpResidual:
    """A compressed residual leaf: the flat float32 ``Compressed`` of a
    tensor, with the tensor's shape and type."""

    def __init__(self, comp: Compressed, shape, dtype: torch.dtype):
        self.comp, self.shape, self.dtype = comp, tuple(shape), dtype

    def restore(self, backend: Optional[str] = None) -> torch.Tensor:
        out = zfp_ops.decompress(
            self.comp, backend=backend_for(self.comp.payload, backend))
        return out.reshape(self.shape).to(self.dtype)


def compress_tree(tree, planes: int, *, backend: Optional[str] = None):
    """``tree`` (nested tuples, lists and dicts) with every compressible
    leaf replaced by its ``ZfpResidual``; other leaves as they are."""

    def enc(x):
        if not _compressible(x):
            return x
        flat = x.detach().reshape(-1).to(torch.float32).contiguous()
        c = zfp_ops.compress(flat, planes=planes, ndim=1,
                             backend=backend_for(flat, backend))
        return ZfpResidual(c, x.shape, x.dtype)

    return _tree_map(enc, tree)


def decompress_tree(tree, *, backend: Optional[str] = None):
    """Inverse of ``compress_tree`` (lossy): each ``ZfpResidual``
    decoded to its tensor."""
    return _tree_map(
        lambda t: t.restore(backend) if isinstance(t, ZfpResidual) else t,
        tree, is_leaf=lambda t: isinstance(t, ZfpResidual))


class _CompressedCheckpoint(torch.autograd.Function):
    """``fn(*args)`` without a graph; saves ``compress_tree(args)``. The
    backward pass decodes the arguments, re-runs ``fn`` on them with
    autograd on, and returns the gradients of every tensor argument
    (the weights' reach their ``nn.Parameter``s: they are arguments)."""

    @staticmethod
    def forward(ctx, fn, planes, backend, *args):
        ctx.fn, ctx.backend = fn, backend
        ctx.res = compress_tree(args, planes, backend=backend)
        with torch.no_grad():
            return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        args = decompress_tree(ctx.res, backend=ctx.backend)
        ctx.res = None
        wants = ctx.needs_input_grad[3:]
        inputs = [
            a.detach().requires_grad_(want) if isinstance(a, torch.Tensor)
            else a for a, want in zip(args, wants)
        ]
        with torch.enable_grad():
            outs = ctx.fn(*inputs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        diff = [a for a, want in zip(inputs, wants) if want]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], diff, [g for _, g in pairs],
            allow_unused=True) if pairs and diff else ())
        return (None, None, None,
                *(next(got) if want else None for want in wants))


def compressed_checkpoint(fn: Callable[..., Any], planes: int = 12, *,
                          backend: Optional[str] = None):
    """A ``torch.utils.checkpoint``-alike that stores ZFP-compressed
    residuals. ``fn`` takes tensors and returns a tensor or a tuple of
    tensors; pass every tensor whose gradient is wanted (weights
    included) as an argument. ``backend`` picks the codec (default: the
    kernels on CUDA tensors, the plain codec on the CPU)."""

    def wrapped(*args):
        return _CompressedCheckpoint.apply(fn, planes, backend, *args)

    return wrapped

"""Wrapper of the fused ZFP-decode + flash-decode attention kernel in
``csrc/cdecode.cu``.

``fused_cdecode_attention`` replaces
``repro.kernels.cdecode.kernel.fused_cdecode_attention``. The TPU kernel
walks the chunks of a row in order on one core; on Hopper the history
of each row is split into ``nsplit`` contiguous runs of chunks, one CTA
each, so that a decode batch of a few (batch x kv-head) rows fills the
card. The kernel writes per-split partials to scratch that
``cdecode_partials`` allocates and returns unmerged, so that the ops
wrapper merges them together with the raw tail's in one step;
``fused_cdecode_attention`` merges them alone with the reference's
guarded formulas (``ref.merge``) and keeps the reference's contract,
the whole-history ``(m, l, acc)``.

On a CPU tensor the wrapper runs the plain version (``ref``); on a CUDA
tensor it launches the kernel or raises. ``launches["cdecode"]`` counts
kernel launches, one per call that reaches the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.cdecode import ref
from repro_torch.kernels.zfp import kernel as zfp_kernel
from repro_torch.kernels.zfp import ref as zfp_ref
from repro_torch.models.kvcache import _nb_per_chunk

launches = {"cdecode": 0}

# CTAs to aim for: two per SM of the H100's 132
TARGET_CTAS = 264
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _I, _P]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def split_plan(rows: int, live: int):
    """``(nsplit, per)``: CTAs per row and chunks per CTA, so that about
    ``TARGET_CTAS`` CTAs run and none is left without a chunk (one CTA
    per row when there is no history)."""
    if live == 0:
        return 1, 0
    nsplit = max(1, min(live, -(-TARGET_CTAS // rows)))
    per = -(-live // nsplit)
    return -(-live // per), per


def _require(x: torch.Tensor, dtype: torch.dtype, shape, what: str) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def cdecode_partials(
    payload_k: torch.Tensor,  # (BG, NB, W) uint32
    emax_k: torch.Tensor,  # (BG, NB) int32
    payload_v: torch.Tensor,
    emax_v: torch.Tensor,
    q_scaled: torch.Tensor,  # (BG, QPK, D) float32, pre-scaled
    hist_len: int,
    *,
    planes: int,
    head_dim: int,
    qpk: int,
) -> ref.Partials:
    """Per-split flash-decoding partials ``(m, l (BG, S, QPK),
    acc (BG, S, QPK, D))`` over the first ``hist_len`` tokens of the
    compressed history (``S = 1`` on the CPU)."""
    if payload_k.device.type == "cpu":
        return tuple(x.unsqueeze(1) for x in ref.fused_cdecode_attention_ref(
            payload_k, emax_k, payload_v, emax_v, q_scaled, hist_len,
            planes=planes, head_dim=head_dim, qpk=qpk))
    bg, nb, w = payload_k.shape
    nbc = _nb_per_chunk(head_dim)
    if head_dim % 4 or nb % nbc:
        raise ValueError(f"head_dim {head_dim} and {nb} blocks do not make "
                         f"whole chunks of {nbc} blocks")
    if w != zfp_ref.payload_words(2, int(planes)):
        raise ValueError(f"{w} payload words do not match {planes} planes")
    for x, what in ((payload_k, "payload_k"), (payload_v, "payload_v")):
        _require(x, torch.uint32, (bg, nb, w), what)
    for x, what in ((emax_k, "emax_k"), (emax_v, "emax_v")):
        _require(x, torch.int32, (bg, nb), what)
    _require(q_scaled, torch.float32, (bg, qpk, head_dim), "q_scaled")
    tensors = (emax_k, payload_v, emax_v, q_scaled)
    if any(t.device != payload_k.device for t in tensors):
        raise ValueError("cdecode inputs must share one device")
    fn = _build.bind("cdecode", "cdecode_attention", _ARGS)
    smem = _build.bind("cdecode", "cdecode_smem_bytes", [_I, _I])
    if smem(head_dim, qpk) > MAX_SMEM:
        raise ValueError(f"head_dim {head_dim} x qpk {qpk} needs more shared "
                         f"memory than a block has")

    hist_len = int(hist_len)
    nsplit, per = split_plan(bg, ref.live_chunks(hist_len, nb // nbc))
    dev = payload_k.device
    m = torch.empty((bg, nsplit, qpk), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((bg, nsplit, qpk, head_dim), dtype=torch.float32,
                      device=dev)
    masks, perm, counts, nplanes, _ = zfp_kernel._tables(int(planes), 2)
    err = fn(payload_k.data_ptr(), emax_k.data_ptr(), payload_v.data_ptr(),
             emax_v.data_ptr(), q_scaled.data_ptr(), m.data_ptr(),
             l.data_ptr(), acc.data_ptr(), bg, nb, w, head_dim, qpk,
             hist_len, nsplit, per, masks.ctypes.data, perm.ctypes.data,
             counts.ctypes.data, nplanes,
             torch.cuda.current_stream().cuda_stream)
    _build.check("cdecode", err, "cdecode_attention")
    launches["cdecode"] += 1
    return m, l, acc


def fused_cdecode_attention(*args, **kwargs) -> ref.Partials:
    """Flash-decoding partials ``(m, l (BG, QPK), acc (BG, QPK, D))``
    over the first ``hist_len`` tokens of the compressed history: the
    reference kernel's contract (arguments as ``cdecode_partials``)."""
    m, l, acc = cdecode_partials(*args, **kwargs)
    if m.shape[1] == 1:
        return m[:, 0], l[:, 0], acc[:, 0]
    return ref.merge(m, l, acc, dim=1)

"""Wrapper of the fused ZFP-decode + flash-decode attention kernel in
``csrc/cdecode.cu``.

``fused_cdecode_attention`` replaces
``repro.kernels.cdecode.kernel.fused_cdecode_attention``. The TPU kernel
walks the chunks of a row in order on one core. On Hopper the history of
each row is cut into 16-token bands (4 block rows of K and of V) and
split into ``nsplit`` runs of bands, one CTA each, so that the 16 rows
of a serving batch still fill the card (``split_plan``); a CTA stages
each band's payload into shared memory with ``cp.async`` one band ahead
and decodes it there. The bound is bytes: the payload and emax of the
live bands, the queries and the partials, once. The kernel writes
per-split partials to scratch that ``cdecode_partials`` allocates and
returns unmerged, so that the ops wrapper merges them together with the
raw tail's in one step; ``fused_cdecode_attention`` merges them alone
with the reference's guarded formulas (``ref.merge``) and keeps the
reference's contract, the whole-history ``(m, l, acc)``.
``decoded_tiles`` runs the kernel's staging and decode alone, for the
check that its K and V are the codec's bit for bit.

On a CPU tensor the wrapper runs the plain version (``ref``); on a
CUDA tensor it launches the kernel or raises. ``launches["cdecode"]``
counts kernel launches, one per call that reaches the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.cdecode import ref
from repro_torch.kernels.zfp import kernel as zfp_kernel
from repro_torch.kernels.zfp import ref as zfp_ref
from repro_torch.models.kvcache import CHUNK, _nb_per_chunk

launches = {"cdecode": 0}

# CTAs to aim for: four per SM of the H100's 132, as many as fit at once
TARGET_CTAS = 528
BAND = 16  # tokens a split unit
BANDS_PER_CHUNK = CHUNK // BAND
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _I, _P]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def live_bands(hist_len: int, nbands: int) -> int:
    """Bands that hold at least one of the first ``hist_len`` tokens."""
    return min(nbands, -(-max(int(hist_len), 0) // BAND))


def split_plan(rows: int, live: int):
    """``(nsplit, per)``: CTAs per row and bands per CTA for ``live``
    bands, so that at most about ``TARGET_CTAS`` CTAs run (one wave)
    and none is left without a band (one CTA per row when there is no
    history). A run longer than a chunk is a run of whole chunks."""
    if live == 0:
        return 1, 0
    nsplit = max(1, min(live, TARGET_CTAS // rows))
    per = -(-live // nsplit)
    if per > BANDS_PER_CHUNK:
        per = -(-per // BANDS_PER_CHUNK) * BANDS_PER_CHUNK
    return -(-live // per), per


def smem_bytes(head_dim: int, qpk: int, w: int) -> int:
    """Dynamic shared memory of one CTA (CUDA build only)."""
    fn = _build.bind("cdecode", "cdecode_smem_bytes", [_I, _I, _I])
    return int(fn(head_dim, qpk, w))


@functools.lru_cache(maxsize=None)
def _check_smem(head_dim: int, qpk: int, w: int) -> None:
    if smem_bytes(head_dim, qpk, w) > MAX_SMEM:
        raise ValueError(f"head_dim {head_dim} x qpk {qpk} needs more shared "
                         f"memory than a block has")


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
    _check_smem(head_dim, qpk, w)

    hist_len = int(hist_len)
    nsplit, per = split_plan(bg, live_bands(hist_len, nb // head_dim))
    n = bg * nsplit * qpk
    out = torch.empty(n * (head_dim + 2), dtype=torch.float32,
                      device=payload_k.device)
    m, l = (out[i * n:(i + 1) * n].view(bg, nsplit, qpk) for i in range(2))
    acc = out[2 * n:].view(bg, nsplit, qpk, head_dim)
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


def decoded_tiles(payload_k: torch.Tensor, emax_k: torch.Tensor,
                  payload_v: torch.Tensor, emax_v: torch.Tensor, *,
                  planes: int, head_dim: int, band0: int, nbands: int):
    """K and V of bands ``band0 .. band0 + nbands`` of every row, each
    ``(BG, nbands * 16, D)`` float32, as the attention kernel stages and
    decodes them in shared memory (on a CPU tensor, the plain
    ``ref.decode_tiles``). Not on the serving path: a check of the
    kernel's decode against the codec."""
    bg, nb, w = payload_k.shape
    if payload_k.device.type == "cpu":  # whole chunks, then the bands
        nbc = _nb_per_chunk(head_dim)
        c0, c1 = band0 // BANDS_PER_CHUNK, -(-(band0 + nbands)
                                               // BANDS_PER_CHUNK)
        blk = slice(c0 * nbc, c1 * nbc)
        tok = slice((band0 - c0 * BANDS_PER_CHUNK) * BAND,
                    (band0 + nbands - c0 * BANDS_PER_CHUNK) * BAND)
        return tuple(ref.decode_tiles(p[:, blk], e[:, blk], planes,
                                      head_dim)[:, tok]
                     for p, e in ((payload_k, emax_k), (payload_v, emax_v)))
    if nbands < 1 or band0 < 0 or (band0 + nbands) * head_dim > nb:
        raise ValueError(f"bands {band0}..{band0 + nbands} outside {nb} "
                         f"blocks of head_dim {head_dim}")
    for x, what in ((payload_k, "payload_k"), (payload_v, "payload_v")):
        _require(x, torch.uint32, (bg, nb, w), what)
    for x, what in ((emax_k, "emax_k"), (emax_v, "emax_v")):
        _require(x, torch.int32, (bg, nb), what)
    _check_smem(head_dim, 1, w)
    fn = _build.bind("cdecode", "cdecode_tiles",
                     [_P] * 6 + [_I] * 6 + [_P, _P, _P, _I, _P])
    out = [torch.empty((bg, nbands * BAND, head_dim), dtype=torch.float32,
                       device=payload_k.device) for _ in range(2)]
    masks, perm, counts, nplanes, _ = zfp_kernel._tables(int(planes), 2)
    err = fn(payload_k.data_ptr(), emax_k.data_ptr(), payload_v.data_ptr(),
             emax_v.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), bg, nb,
             w, head_dim, band0, nbands, masks.ctypes.data, perm.ctypes.data,
             counts.ctypes.data, nplanes,
             torch.cuda.current_stream().cuda_stream)
    _build.check("cdecode", err, "cdecode_tiles")
    return tuple(out)

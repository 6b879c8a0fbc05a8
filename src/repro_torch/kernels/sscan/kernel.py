"""Wrapper of the Mamba-1 selective-scan kernel in ``csrc/sscan.cu``.

``selective_scan`` replaces
``repro.kernels.sscan.kernel.selective_scan_pallas``. The TPU kernel
walks ``(B, D-tiles, S-chunks)`` grid steps, the chunk axis in order,
and scans each chunk associatively on a ``(d_tile, N)`` state held in
VMEM. On Hopper each ``(b, d)`` channel's ``N`` states sit in registers
(four lanes of four states at decode, one lane at prefill) and run the
recurrence step by step over a stream staged in shared memory, so there
is no chunk and no ``S % chunk`` or ``D % d_tile`` constraint.

``h_out`` (optional) receives ``h_last`` in place, as the serving cache
wants; it may be ``h0`` itself. ``states_out`` (optional, training)
receives the state before every ``SAVE_EVERY`` steps, the checkpoints of
``selective_scan_bwd``: the gradient kernel of ``csrc/sscan.cu``, which
replaces no TPU kernel (``repro`` differentiates the XLA form of the
scan; its Pallas kernel has no backward). The backward recomputes each
16-step stage from its checkpoint with four lanes a channel and four
states a lane, keeps the stage in registers, runs it backwards, and sums
dB and dC over channels on chip (warp butterflies, then the CTA's 16
warps in shared memory), writing one partial a ``BWD_CHANNELS``-channel
CTA; a second launch adds the partials in order. Its bound is the bytes
it must move (0.242 ms at falcon-mamba's training shape (8, 512, 8192,
16) on an H100); ``bwd_residency`` reports its registers, shared memory
and warps an SM. On a CPU tensor each wrapper runs its plain version
(``ref``: the chunked scan, and autograd of it); on a CUDA tensor it
launches the kernel or raises.
``launches["sscan"]`` and ``launches["sscan_bwd"]`` count launches, one
per call that reaches the card (the backward's call is its scan and the
fixed-order sums of its partials).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import _build
from repro_torch.kernels.sscan import ref

launches = {"sscan": 0, "sscan_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 9 + [_I] * 4 + [_P]
_BWD_ARGS = [_P] * 17 + [_I] * 4 + [_P]
MAX_STATE = 16  # csrc/sscan.cu kMaxN: the states a channel keeps in registers
SAVE_EVERY = 16  # csrc/sscan.cu kStage: steps between the saved states
BWD_CHANNELS = 128  # csrc/sscan.cu kBwdGroup: channels a dB / dC partial
# each constant and the library's getter of it
_GETTERS = (("MAX_STATE", "sscan_max_state"),
            ("SAVE_EVERY", "sscan_save_every"),
            ("BWD_CHANNELS", "sscan_bwd_channels"))
_checked = []


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _require(x: torch.Tensor, shape, what: str, dev: torch.device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if x.device != dev:
        raise ValueError(f"{what} lies on {x.device}, not {dev}")


def _bind(symbol: str, argtypes):
    """Bind a C entry of ``csrc/sscan.cu``, first checking once that the
    library's extents are the constants this module sizes its scratch
    by (a library built from another source would overrun them)."""
    if not _checked:
        lib = _build.library("sscan")
        for const, getter in _GETTERS:
            fn = getattr(lib, getter)
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != globals()[const]:
                raise _build.KernelError(
                    f"csrc/sscan.cu {getter}() = {fn()}, but the wrapper's "
                    f"{const} is {globals()[const]}")
        _checked.append(True)
    return _build.bind("sscan", symbol, argtypes)


def bwd_residency() -> dict:
    """The backward kernel's residency on the current card, from the
    library (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaFuncGetAttributes``): CTAs and warps an SM, threads a CTA,
    registers and local bytes a thread, static and dynamic shared
    memory. For measurement; no launch."""
    fn = _bind("sscan_bwd_occupancy", [_P])
    out = (ctypes.c_int * 6)()
    _build.check("sscan", fn(out), "sscan_bwd_occupancy")
    keys = ("ctas_per_sm", "threads", "dynamic_smem", "registers",
            "static_smem", "local_bytes")
    res = dict(zip(keys, out))
    res["warps_per_sm"] = res["ctas_per_sm"] * res["threads"] // 32
    return res


def states_shape(bsz: int, s: int, d: int, n: int) -> Tuple[int, ...]:
    """Shape of ``states_out``: one state every ``SAVE_EVERY`` steps."""
    return (bsz, -(-s // SAVE_EVERY), d, n)


def _check_inputs(dt, a, b_in, c_in, x, h0) -> Tuple[int, int, int, int]:
    bsz, s, d = x.shape
    n = a.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the kernel keeps at most {MAX_STATE} states a "
                         f"channel in registers, got N = {n}")
    for t, shape, what in ((dt, (bsz, s, d), "dt"), (x, (bsz, s, d), "x"),
                           (a, (d, n), "a"), (b_in, (bsz, s, n), "b_in"),
                           (c_in, (bsz, s, n), "c_in"),
                           (h0, (bsz, d, n), "h0")):
        _require(t, shape, what, x.device)
    return bsz, s, d, n


def selective_scan(
    dt: torch.Tensor,  # (B, S, D) f32
    a: torch.Tensor,  # (D, N) f32
    b_in: torch.Tensor,  # (B, S, N) f32
    c_in: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, D) f32
    h0: torch.Tensor,  # (B, D, N) f32
    *,
    h_out: Optional[torch.Tensor] = None,
    chunk: int = 64,
    states_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, D), h_last (B, D, N)); ``h_last`` is ``h_out``
    when one is given. ``states_out`` (``states_shape``) receives the
    backward's checkpoints."""
    if x.device.type == "cpu":
        y, h = ref.selective_scan_ref(dt, a, b_in, c_in, x, h0,
                                      max(1, min(chunk, x.shape[1])))
        if states_out is not None:
            states_out.copy_(ref.boundary_states(dt, a, b_in, c_in, x, h0,
                                                 SAVE_EVERY))
        if h_out is None:
            return y, h
        return y, h_out.copy_(h)
    bsz, s, d, n = _check_inputs(dt, a, b_in, c_in, x, h0)
    dev = x.device
    if h_out is None:
        h_out = torch.empty_like(h0)
    _require(h_out, (bsz, d, n), "h_out", dev)
    if states_out is not None:
        _require(states_out, states_shape(bsz, s, d, n), "states_out", dev)
    y = torch.empty_like(x)
    fn = _bind("sscan_forward", _ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
             None if states_out is None else states_out.data_ptr(),
             bsz, s, d, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("sscan", err, "sscan_forward")
    launches["sscan"] += 1
    return y, h_out


def selective_scan_bwd(
    dt: torch.Tensor,  # (B, S, D) f32
    a: torch.Tensor,  # (D, N) f32
    b_in: torch.Tensor,  # (B, S, N) f32
    c_in: torch.Tensor,  # (B, S, N) f32
    x: torch.Tensor,  # (B, S, D) f32
    h0: torch.Tensor,  # (B, D, N) f32
    states: torch.Tensor,  # states_shape(...), from the forward
    gy: torch.Tensor,  # (B, S, D) f32: dL/dy
    gh: Optional[torch.Tensor] = None,  # (B, D, N) f32: dL/dh_last, or 0
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, ...]:
    """The gradients ``(ddt, da, db_in, dc_in, dx, dh0)`` of
    ``selective_scan``'s ``(y, h_last)``. On the CPU the plain version:
    autograd of ``ref.selective_scan_ref`` (``states`` unused)."""
    if x.device.type == "cpu":
        return ref.selective_scan_bwd_ref(dt, a, b_in, c_in, x, h0, gy, gh,
                                          max(1, min(chunk, x.shape[1])))
    bsz, s, d, n = _check_inputs(dt, a, b_in, c_in, x, h0)
    dev = x.device
    _require(states, states_shape(bsz, s, d, n), "states", dev)
    _require(gy, (bsz, s, d), "gy", dev)
    if gh is not None:
        _require(gh, (bsz, d, n), "gh", dev)
    ddt, dx = torch.empty_like(x), torch.empty_like(x)
    da, dh0 = torch.empty_like(a), torch.empty_like(h0)
    db, dc = torch.empty_like(b_in), torch.empty_like(c_in)
    groups = -(-d // BWD_CHANNELS)
    db_part = torch.empty((bsz, groups, s, n), dtype=torch.float32,
                          device=dev)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty_like(h0)
    fn = _bind("sscan_backward", _BWD_ARGS)
    err = fn(dt.data_ptr(), x.data_ptr(), a.data_ptr(), b_in.data_ptr(),
             c_in.data_ptr(), states.data_ptr(), gy.data_ptr(),
             None if gh is None else gh.data_ptr(), dx.data_ptr(),
             ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
             dh0.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
             da_part.data_ptr(), bsz, s, d, n,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("sscan", err, "sscan_backward")
    launches["sscan_bwd"] += 1
    return ddt, da, db, dc, dx, dh0

"""Compression-induced error tracking for long out-of-core runs.

Port of ``repro.core.precision``. The paper's second headline claim
(Fig. 7, §VI-C) is that the fixed-rate on-the-fly compression keeps
precision loss trivial out to 4,320 time steps: each sweep decodes,
computes, and re-encodes the pressure fields, so quantization error is
re-injected every sweep and could in principle compound. ``error_curve``
measures that curve, the lossy out-of-core engine against the exact
in-core run, and ``assert_bounded_growth`` holds it as a predicate
(``tests/test_torch_precision.py``; ``chip_smoke.py`` runs it to 4,320
steps on the card in float64 at the paper's rates).

The in-core run goes through the port's own stencil with the engine's
backend (``stencil_ops.temporal_steps``), so the lossless code 1 is
exactly exact on either device. Like the other entry points it runs on
the CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.outofcore import (
    OOCConfig, OutOfCoreWave, paper_code_fields, to_device, to_host,
)
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.stencil import ref as stencil_ref
from repro_torch.kernels.zfp.ref import dtype_key

__all__ = ["error_curve", "assert_bounded_growth", "initial_fields"]


def initial_fields(shape, dtype: str = "float32") -> Dict[str, np.ndarray]:
    """The curve's default initial condition, host arrays of ``dtype``:
    a Ricker p_cur, p_prev = 0.97 p_cur, vel2 = 0.06."""
    p_cur = stencil_ref.ricker_source(tuple(shape),
                                      dtype=getattr(torch, dtype)).numpy()
    return {
        "p_prev": (0.97 * p_cur).astype(dtype),
        "p_cur": p_cur,
        "vel2": np.full(shape, 0.06, dtype=dtype),
    }


def error_curve(
    code: int = 4,
    shape=(64, 24, 24),
    ndiv: int = 2,
    bt: int = 4,
    sweeps: int = 8,
    sample_every: int = 1,
    backend: Optional[str] = None,
    initial: Optional[Dict[str, np.ndarray]] = None,
    rates=None,
    *,
    dtype: str = "float32",
    device=None,
) -> List[Dict[str, object]]:
    """Error-vs-steps curve of the lossy out-of-core wave.

    Runs the out-of-core engine under paper code ``code`` (2-4 are the
    lossy ones) for ``sweeps`` sweeps of ``bt`` steps, alongside the
    exact in-core run, and samples the pointwise error of ``p_cur``
    every ``sample_every`` sweeps (and after the last). Returns one row
    per sample::

        {"steps": int, "max_abs": float, "rms": float,
         "ref_scale": float, "rel_max": float,
         "units": {"R0": {"max_abs": ..., "rel_max": ...}, ...}}

    ``ref_scale`` is the in-core field's max |value| at that point;
    ``rel_max = max_abs / ref_scale``; ``units`` breaks the measurement
    down per storage unit of the engine's plan (``rel_max`` normalized
    by the global ``ref_scale``).

    ``dtype`` is the fields' type: float32 runs the codes at the float32
    rates 16/12 (the reference's curve), float64 at the paper's rates
    32/24. ``initial`` (host arrays, cast to ``dtype``) defaults to
    ``initial_fields``. ``backend`` defaults to ``"cuda"`` on a CUDA
    device and ``"ref"`` on the CPU; ``rates`` is a ``RateController``
    for per-unit adaptive rates.
    """
    dtype = dtype_key(dtype)
    dev = device_mod.resolve(device)
    if backend is None:
        backend = "cuda" if dev.type == "cuda" else "ref"
    if initial is None:
        initial = initial_fields(shape, dtype)
    initial = {k: np.asarray(v, dtype=dtype) for k, v in initial.items()}
    cfg = OOCConfig(tuple(shape), ndiv, bt,
                    paper_code_fields(code, f32=dtype == "float32"),
                    backend=backend, dtype=dtype, device=str(dev))
    engine = OutOfCoreWave(cfg, initial["p_prev"], initial["p_cur"],
                           initial["vel2"], rates=rates)
    rp, rc, rv = (to_device(initial[k], dev)
                  for k in ("p_prev", "p_cur", "vel2"))
    curve: List[Dict[str, object]] = []
    for s in range(1, sweeps + 1):
        engine.sweep()
        rp, rc = stencil_ops.temporal_steps(rp, rc, rv, steps=bt,
                                            backend=backend)
        if s % sample_every and s != sweeps:
            continue
        got = engine.gather("p_cur")
        ref = to_host(rc)
        err = np.abs(got - ref)
        scale = float(np.max(np.abs(ref)))
        max_abs = float(np.max(err))
        units: Dict[str, Dict[str, float]] = {}
        for kind, idx, (lo, hi) in engine.plan.units():
            u_max = float(np.max(err[lo:hi]))
            units[f"{kind}{idx}"] = {
                "max_abs": u_max,
                "rel_max": u_max / scale if scale else float("inf"),
            }
        curve.append({
            "steps": s * bt,
            "max_abs": max_abs,
            "rms": float(np.sqrt(np.mean(err * err))),
            "ref_scale": scale,
            "rel_max": max_abs / scale if scale else float("inf"),
            "units": units,
        })
    return curve


def assert_bounded_growth(
    curve: List[Dict[str, float]],
    rel_tol: float,
    step_factor: float = 10.0,
) -> None:
    """The regression predicate over an ``error_curve``.

    * every sample is finite and its max error stays under ``rel_tol``
      relative to the reference's scale (the paper's "trivial loss"
      claim, as an inequality);
    * growth is bounded: no single inter-sample step multiplies the
      accumulated (running-max) error by more than ``step_factor``.
    """
    assert curve, "empty error curve"
    running = 0.0
    for row in curve:
        assert np.isfinite(row["max_abs"]), row
        assert np.isfinite(row["rms"]), row
        assert row["rms"] <= row["max_abs"] + 1e-30, row
        assert row["max_abs"] <= rel_tol * row["ref_scale"], (
            "compression error exceeded the regression bound", row,
        )
        if running > 0.0:
            grown = max(running, row["max_abs"])
            assert grown <= step_factor * running, (
                "error exploded between samples", row, running,
            )
            running = grown
        else:
            running = row["max_abs"]

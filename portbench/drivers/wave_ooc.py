"""Driver of the out-of-core wave: ``repro_torch``'s live engine,
``repro_torch.core.executor.AsyncExecutor``, over a configuration of
``configs/`` (``"driver": "wave_ooc"``).

* ``setup``: the inputs made from the seed on the device (``inputs``), a
  field at a time brought to the host and seeded into the engine (the
  cell's schedule and residency budget), which sweeps once to warm up
  and drains;
* ``window``: whole ``sweep()`` calls until ``seconds`` have passed, then
  ``finish()`` and a synchronise; the engine's counters and its transfer
  summary read at both ends;
* ``check``, once the window has closed: the transfer summary held to
  the plan's arithmetic; both read-write fields gathered; one bit of a
  stored unit flipped, which the next sweep's crossing has to refuse
  (``crc32_fault_missed``); the engine freed and the plain reference run
  from the same seed for as many sweeps as the engine completed.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import compare, inputs, plan
from portbench.trace import Trace

DTYPES = {"float32": torch.float32, "float64": torch.float64}
RW_FIELDS = ("p_prev", "p_cur")


@dataclass
class Engine:
    """The cell as the engine takes it."""

    shape: tuple
    ndiv: int
    bt: int
    dtype: str
    fields: Dict[str, dict]  # name -> {"role", "planes"}
    schedule: str
    cache_bytes: int

    @property
    def points(self) -> int:
        return math.prod(self.shape)

    def spans(self) -> List[tuple]:
        """The storage units' (lo, hi) spans along Z."""
        return [(lo, hi) for _, _, lo, hi in
                plan.units(self.shape[0], self.ndiv, self.bt)]

    def summary(self) -> Dict[str, int]:
        return plan.expected_summary(self.shape, self.ndiv, self.bt,
                                     self.fields, self.dtype)


def engine_of(cell) -> Engine:
    c, t = cell.config, cell.traffic
    dtype = c["dtype"]
    fields = {name: {"role": f["role"],
                     "planes": plan.field_planes(f["rate"], dtype)}
              for name, f in t["fields"].items()}
    return Engine(tuple(c["shape"]), int(c["ndiv"]), int(c["bt"]), dtype,
                  fields, c["schedule"], int(c["cache_bytes"]))


@dataclass
class Window:
    """What the per-layer readers read: the window's length, its work,
    the engine's counters over it, the plan, and the trace (or None)."""

    seconds: float
    sweeps: int
    steps: int
    engine: Engine
    counters: Dict[str, float]  # ``_counters`` over the window
    wire: Dict[str, int]  # the transfer summary over the window
    trace: Optional[Trace] = None


def _counters(ex) -> Dict[str, float]:
    """Every number of ``ex.stats()``, flattened with dotted names
    (``lanes.host_wait_s``, ``cache.hits``, ...), and each stream's busy
    seconds (``busy.h2d``, ``busy.compute``, ``busy.d2h``)."""
    out: Dict[str, float] = {}

    def walk(prefix: str, d: dict) -> None:
        for k, v in d.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                out[f"{prefix}{k}"] = float(v)

    walk("", ex.stats())
    walk("busy.", ex.lanes.busy_s())
    return out


def _diff(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {k: b[k] - a[k] for k in b}


def libraries(cell) -> List[str]:
    """The program's kernel libraries the cell runs (``csrc/<name>.cu``),
    as its configuration lists them."""
    return list(cell.config["kernels"])


@dataclass
class State:
    """One run's engine and what the check needs of it."""

    cell: object
    seed: int
    dev: object
    eng: Engine
    ex: object
    log: Callable[[str], None]
    window_summary: Optional[Dict[str, int]] = None


def setup(cell, seed: int, dev, lap) -> State:
    from repro_torch.core.executor import AsyncExecutor
    from repro_torch.core.outofcore import FieldSpec, OOCConfig

    eng = engine_of(cell)
    cfg = OOCConfig(
        eng.shape, eng.ndiv, eng.bt,
        {n: FieldSpec(f["role"], f["planes"]) for n, f in eng.fields.items()},
        backend=dev.backend, dtype=eng.dtype, device=dev.device)
    ex = AsyncExecutor(cfg, schedule=eng.schedule,
                       cache_bytes=eng.cache_bytes)
    lap("setup engine")
    tdtype, params = DTYPES[eng.dtype], cell.traffic["inputs"]
    host = None  # one host buffer for the three fields: seeding copies
    for name in inputs.FIELDS:
        host = inputs.on_host(name, seed, eng.shape, params, tdtype,
                              dev.device, out=host)
        lap(f"setup make {name}")
        ex.store.seed({name: host.numpy()})
        lap(f"setup seed {name}")
    del host
    ex.sweep()
    ex.finish()
    dev.sync()
    lap("setup warm sweep")
    return State(cell, seed, dev, eng, ex, lap.log)


def window(st: State, seconds: float, prof) -> Window:
    """Whole sweeps until ``seconds`` have passed, then the drain."""
    ex, eng = st.ex, st.eng
    c0, w0 = _counters(ex), dict(ex.transfer_summary())
    done0 = ex.sweeps_done
    t0 = time.perf_counter()
    marks = []
    while True:
        with prof.span("portbench.sweep"):
            ex.sweep()
        marks.append(time.perf_counter() - t0)
        if marks[-1] >= seconds:
            break
    with prof.span("portbench.drain"):
        ex.finish()
        st.dev.sync()
    t1 = time.perf_counter()
    c1, w1 = _counters(ex), dict(ex.transfer_summary())
    st.window_summary = w1
    sweeps = ex.sweeps_done - done0
    st.log(f"sweeps_returned_at_s {marks}")
    return Window(t1 - t0, sweeps, sweeps * eng.bt, eng, _diff(c0, c1),
                  {k: w1[k] - w0.get(k, 0) for k in w1})


def end_to_end(win: Window) -> Dict[str, float]:
    """The driver's own end-to-end metrics over the window."""
    return {"update_rate": win.engine.points * win.steps / win.seconds / 1e9}


def report(win: Window) -> Dict[str, float]:
    """The engine's counters over the window, for the result's line."""
    return {"seconds": win.seconds, "sweeps": win.sweeps,
            "steps": win.steps, **{k: win.counters[k] for k in (
                "lanes.host_wait_s", "lanes.crc_wait_s", "lanes.host_job_s",
                "busy.h2d", "busy.compute", "busy.d2h")}}


# ----------------------------------------------------------------------
# the check
# ----------------------------------------------------------------------


def _flip(value, seed: int) -> str:
    """Flip one bit, drawn from ``seed``, of a stored host unit in place
    (a raw unit's values, a compressed unit's payload); what was hit."""
    from repro_torch.core.outofcore import Compressed

    arr = np.asarray(value.payload if isinstance(value, Compressed)
                     else value)
    if not arr.flags.c_contiguous:
        raise RuntimeError("a stored unit is not one contiguous buffer")
    flat = arr.reshape(-1).view(np.uint8)
    rng = np.random.default_rng([seed, 2])
    k, bit = int(rng.integers(flat.shape[0])), int(rng.integers(8))
    flat[k] ^= 1 << bit
    return f"byte {k} bit {bit} of {flat.shape[0]}"


def _names_checksum(exc: Optional[BaseException]) -> bool:
    """Whether ``exc`` or an exception it chains is a ``ChecksumError``."""
    from repro_torch.core.outofcore import ChecksumError

    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, ChecksumError):
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False


def crc32_fault_missed(st: State) -> float:
    """1 unless the crossing after a planted fault refuses it, else 0.

    The seed draws a field, then one of its units and one bit of what
    the store holds of it; that bit is flipped in the host store, and
    the next sweep has to raise a ``ChecksumError`` where the unit
    crosses the link. Over the seeds, every field of the mix (read-write
    and read-only, compressed and raw) and every unit is drawn. The
    engine is not used again after this."""
    ex = st.ex
    rng = np.random.default_rng([st.seed, 1])
    names = sorted(st.eng.fields)
    name = names[int(rng.integers(len(names)))]
    units = [(kind, idx) for kind, idx, _ in ex.store.plan.units()]
    kind, idx = units[int(rng.integers(len(units)))]
    hit = _flip(ex.store.get(name, kind, idx), st.seed)
    refused, what = False, "not refused"
    try:
        ex.sweep()
        ex.finish()
        st.dev.sync()
    except Exception as exc:  # the crossing's refusal, or another fault
        # (the exception, and the engine's frames it holds, end here)
        refused = _names_checksum(exc)
        what = f"{type(exc).__name__}: {str(exc)[:300]}"
    st.log(f"crc32 fault planted in {name}.{kind}{idx} "
           f"({st.eng.fields[name]['role']}, "
           f"{'raw' if st.eng.fields[name]['planes'] is None else 'zfp'}), "
           f"{hit}: {what}")
    return 0.0 if refused else 1.0


def check(st: State, win: Window) -> Dict[str, float]:
    """The numbers compared (``limits/<cell>.json``)."""
    ex, eng, dev, log = st.ex, st.eng, st.dev, st.log
    want, sweeps = eng.summary(), ex.sweeps_done
    numbers: Dict[str, float] = {
        "wire_bytes_off": float(
            compare.wire_off(win.wire, want, win.sweeps)
            + compare.wire_off(st.window_summary, want, sweeps))}
    t = time.perf_counter()
    got = {n: ex.gather(n) for n in RW_FIELDS}
    log(f"check gather {time.perf_counter() - t}")
    t = time.perf_counter()
    numbers["crc32_fault_missed"] = crc32_fault_missed(st)
    log(f"check crc32 fault {time.perf_counter() - t}")
    ex.close()
    st.ex = ex = None
    dev.free()
    ref = st.cell.reference()
    tdtype, params = DTYPES[eng.dtype], st.cell.traffic["inputs"]
    fld = {n: inputs.on_device(n, st.seed, eng.shape, params, tdtype,
                               dev.device)
           for n in inputs.FIELDS}
    t = time.perf_counter()
    pp, pc = ref.run_ooc(fld, sweeps, eng.bt, eng.spans(),
                         {n: f["planes"] for n, f in eng.fields.items()})
    dev.sync()
    log(f"reference_s {time.perf_counter() - t} sweeps {sweeps}")
    numbers["p_prev_rel_err"] = compare.rel_err(got["p_prev"], pp)
    numbers["p_cur_rel_err"] = compare.rel_err(got["p_cur"], pc)
    return numbers


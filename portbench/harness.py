"""One run of a cell: set-up, the measured window, the check.

The cell's configuration names its driver, ``drivers/<driver>.py``,
which knows the system under test; this module knows only the run's
order and its result:

0. the program's kernel libraries the driver lists, loaded (built in
   the first run of a checkout): ``setup.build_s`` in the result, apart;
1. ``driver.setup``: inputs from the seed, the system built and warmed;
   ``setup_s`` runs from the process's start to its end;
2. ``driver.window``: the measured window, under the profiler with
   ``trace``, the device's peak allocation reset at its start;
3. ``driver.check``, once the window has closed and the peak is read:
   the numbers compared, each against its limit (``compare.judge``).

The device is an object the caller passes (``card.Card`` from
``run.py``), so this path holds no branch on the kind of device.
"""

from __future__ import annotations

import resource
import sys
import time
from typing import Callable, List, Optional

from portbench import compare, plan
from portbench.spec import Cell
from portbench.trace import Profile

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ImportGuard(RuntimeError):
    """A forbidden package is loaded in the benchmark's process."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (up to the first dot) is one
    the benchmark may not load, compared whole: ``repro_torch`` passes,
    ``repro`` does not."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def check_imports() -> None:
    bad = forbidden_modules()
    if bad:
        raise ImportGuard(f"forbidden modules loaded: {bad}")


class Laps:
    """Logs the seconds of each phase of a run, off one clock."""

    def __init__(self, start: float, log: Callable[[str], None]):
        self.last, self.log = start, log

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.log(f"{what} {now - self.last}")
        self.last = now


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev,
        started: Optional[float] = None,
        log: Callable[[str], None] = lambda s: print(s, file=sys.stderr,
                                                     flush=True)) -> dict:
    """One run of ``cell`` on ``dev``; returns the result's object
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``breakdown`` with ``trace``, ``checks`` last)."""
    started = time.perf_counter() if started is None else started
    drv = cell.driver()

    # 0. the kernels, built apart
    built = dev.build(drv.libraries(cell))
    log(f"build_s {built['build_s']} built {built['built']}")

    # 1. set-up
    lap = Laps(time.perf_counter(), log)
    st = drv.setup(cell, seed, dev, lap)
    setup_s = time.perf_counter() - started
    log(f"setup_s {setup_s}")

    # 2. the window
    setup_peak = dev.peak()
    dev.reset_peak()
    with Profile(trace) as prof:
        with prof.window():
            win = drv.window(st, seconds, prof)
    window_peak = dev.peak()
    win.trace = prof.trace
    log(f"window_s {win.seconds} sweeps {win.sweeps} steps {win.steps}"
        + (f" trace_reduce_s {prof.reduce_s}" if trace else ""))
    check_imports()

    # 3. the check
    numbers = drv.check(st, win)
    del st
    correct, table, failed = compare.judge(numbers, cell.limits["limits"])
    check_imports()

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(win)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"device_peak_gb": window_peak / 1e9, "setup_s": setup_s,
                  **drv.end_to_end(win)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": dev.platform, "kind": dev.kind(),
              "count": cell.chips,
              "memory_peak_bytes": max(setup_peak, window_peak)}
    out = {"correct": correct, "attempted": len(table),
           "failed": len(failed), "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = win.trace.busy()
        device["window_s"] = win.trace.seconds
        out["breakdown"] = {"device_ops": win.trace.device_ops(),
                            "idle_gaps": win.trace.idle_gaps()}
    out["card"] = dev.describe()
    log(f"card {out['card']} (peak {plan.PEAK_HBM_BYTES_PER_S} B/s)")
    out["setup"] = {"seconds": setup_s, **built}
    out["window"] = drv.report(win)
    out["checks"] = table
    log(f"host_maxrss_gb "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}")
    for k, v in table.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    return out

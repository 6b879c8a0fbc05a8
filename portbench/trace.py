"""The device trace of a run's window and its reduction.

``Profile`` wraps the window in ``torch.profiler`` (host and CUDA
activity) and, when it closes, reads the Chrome trace it writes: the
window's bounds from the benchmark's own ``portbench.window`` span, the
device operations (kernels, copies, fills) inside them, and the host
operations on the caller's thread. ``Trace`` holds those and answers the
readers' questions: device time by kernel name, the union of busy
intervals, the longest idle gaps by what the caller was doing.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10


class NoDeviceRecords(RuntimeError):
    """The traced window holds no device operation."""


@dataclass
class Op:
    cat: str
    name: str
    start: float  # seconds, trace clock
    end: float


def short(name: str) -> str:
    """A kernel's name without ``void``, template arguments and
    parameters: ``void encode_kernel<3>(float const*, ...)`` ->
    ``encode_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([A-Za-z_][\w:]*)\s*[<(]", s)
    return m.group(1) if m else s


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(iv: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


class Trace:
    """The window's operations, clipped to it."""

    def __init__(self, window: Tuple[float, float], device: List[Op],
                 host: List[Op]):
        self.start, self.end = window
        self.device = device
        self.host = host

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _clip(self, ops) -> List[Tuple[float, float]]:
        return [(max(o.start, self.start), min(o.end, self.end))
                for o in ops if o.end > self.start and o.start < self.end]

    def kernels(self, pattern: str) -> List[Op]:
        """The window's kernels whose short name matches ``pattern``."""
        rx = re.compile(pattern)
        return [o for o in self.device
                if o.cat == "kernel" and rx.fullmatch(short(o.name))]

    def busy(self, cats: Sequence[str] = DEVICE_CATS) -> float:
        """Seconds in which an operation of ``cats`` ran."""
        return _length(union(self._clip(o for o in self.device
                                        if o.cat in cats)))

    def device_ops(self, top: int = TOP) -> List[List[object]]:
        tot: Dict[str, float] = defaultdict(float)
        for o in self.device:
            tot[short(o.name)] += o.end - o.start
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = TOP) -> List[List[object]]:
        """Seconds of the window in which no device operation ran, by
        the caller's innermost operation at the time (``none``: the
        caller ran Python or waited on the host threads)."""
        busy = union(self._clip(self.device))
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.end:
            gaps.append((t, self.end))
        host = sorted(self.host, key=lambda o: (o.start, -o.end))
        starts = np.array([o.start for o in host])
        longest = max((o.end - o.start for o in host), default=0.0)
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            i, j = (int(np.searchsorted(starts, a - longest)),
                    int(np.searchsorted(starts, b)))
            for name, sec in _innermost(a, b, host[i:j]).items():
                tot[name] += sec
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(a: float, b: float, ops: Sequence[Op]) -> Dict[str, float]:
    """The seconds of [a, b) by the innermost of ``ops`` (one thread's,
    nested, sorted by start and then the longer first) covering them;
    ``none`` where none does."""
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[str, float]] = []
    t = a
    for o in ops:
        if o.end <= a:
            continue
        s, e = max(o.start, a), min(o.end, b)
        while stack and stack[-1][1] <= s:
            name, end = stack.pop()
            out[name] += max(end, t) - t
            t = max(end, t)
        out[stack[-1][0] if stack else "none"] += s - t
        t = s
        stack.append((o.name, e))
    while stack:
        name, end = stack.pop()
        out[name] += max(end, t) - t
        t = max(end, t)
    out["none"] += b - t
    return out


def parse(events: List[dict]) -> Trace:
    """A ``Trace`` from a Chrome trace's events (``ts``, ``dur`` in µs)."""
    window = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW]
    if len(window) != 1:
        raise ValueError(f"{len(window)} '{WINDOW}' spans in the trace")
    w = window[0]
    caller = (w.get("pid"), w.get("tid"))
    t0, t1 = w["ts"] / 1e6, (w["ts"] + w["dur"]) / 1e6
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        op = Op(e.get("cat", ""), e.get("name", ""), e["ts"] / 1e6,
                (e["ts"] + e["dur"]) / 1e6)
        if op.end <= t0 or op.start >= t1:
            continue
        if op.cat in DEVICE_CATS:
            device.append(op)
        elif (op.cat in HOST_CATS and (e.get("pid"), e.get("tid")) == caller
              and not op.name.startswith("portbench.")):
            host.append(op)
    if not any(o.cat == "kernel" for o in device):
        raise NoDeviceRecords("the traced window holds no kernel")
    return Trace((t0, t1), device, host)


class Profile:
    """``with Profile(on) as p:`` profiles the block when ``on``; the
    window itself is marked with ``p.window()``. ``p.trace`` is the
    reduced trace after the block (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace: Optional[Trace] = None
        self.reduce_s = 0.0  # closing the profiler, reading its trace
        self._prof = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        t0 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            self.trace = parse(events)
            self.reduce_s = time.perf_counter() - t0
        return False

    def span(self, name: str):
        """A named span of the benchmark's own (a no-op when off)."""
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def window(self):
        return self.span(WINDOW)

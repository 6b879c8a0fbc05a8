"""The live engine's transport: three CUDA streams, a pinned staging
pool and the host threads that move and digest units.

JAX overlaps the reference's transfers with compute through async
dispatch and a deferred ``np.asarray``. PyTorch gives no such thing, so
``executor.AsyncExecutor`` builds it from the parts here:

* **Streams.** ``h2d``, ``compute`` and ``d2h`` are separate
  ``torch.cuda.Stream``s, ordered only by events. The kernels launch on
  the current stream, so the engine runs its decode, assembly, stencil
  and encode inside ``with lanes.on("compute"):``.
* **Staging (H2D).** A host thread copies the unit into a pinned slot,
  issues ``copy_(non_blocking=True)`` on the h2d stream into a tensor
  allocated there, records an event, and digests the slot's bytes
  (``outofcore.unit_checksum``, whose ``zlib.crc32`` releases the GIL).
  The engine claims the result, has the store verify the digest, and
  only then makes the compute stream wait on the event and decode.
* **Writeback (D2H).** The d2h stream waits on the compute event that
  produced the payload and copies it into a pinned slot; a host thread
  waits on that copy's event, digests the slot, copies the bytes into an
  array the store will own (the slot is reused) and digests the copy.
  The engine claims it when its window drains: the reference's
  deferred ``np.asarray``.
* **The caching allocator.** A tensor allocated on one stream and read
  on another gets ``record_stream`` for the reader: staged units
  (allocated on h2d, read on compute) and payloads copied out (allocated
  on compute, read on d2h). Otherwise a freed block is handed out again
  while the other stream still reads it.
* **The pool.** ``slots`` pinned buffers of ``slot_bytes`` each, made
  once. A slot goes back to the pool when its host job has finished; an
  H2D still reading it leaves its event on the slot, and the next user
  waits on it (a host job before its memcpy, the d2h stream before its
  copy).

On the CPU (``device="cpu"``) the same code runs with no streams and no
pinning: the slots are plain tensors, the copies are synchronous and the
events are ``None``. Host threads run there too (``threads=0`` runs every
job inline, in order).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import outofcore
from repro_torch.kernels.zfp.ref import Compressed

LANES = ("h2d", "compute", "d2h")
_ALIGN = 256  # bytes between the arrays of one unit in a slot


def _parts(value) -> List[object]:
    """The arrays (numpy or torch) a unit value is made of."""
    if isinstance(value, Compressed):
        return [value.payload, value.emax]
    return [value]


def _rebuild(template, parts):
    """A unit value like ``template`` with its arrays replaced."""
    if isinstance(template, Compressed):
        return Compressed(parts[0], parts[1], template.shape,
                          template.planes, template.ndim_spatial,
                          template.dtype)
    return parts[0]


_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.uint32): torch.uint32}


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return next(k for k, v in _DTYPES.items() if v == t.dtype)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor (uint32 via int32)."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """The inverse of ``_as_bytes``."""
    if dtype == torch.uint32:
        return b.view(torch.int32).view(torch.uint32).view(shape)
    return b.view(dtype).view(shape)


def _layout(arrays) -> Tuple[List[Tuple[int, int]], int]:
    """``[(offset, nbytes)]`` of each array in a slot, and the total."""
    spans, off = [], 0
    for a in arrays:
        n = int(a.nbytes) if isinstance(a, np.ndarray) else (
            a.numel() * a.element_size())
        spans.append((off, n))
        off += -(-n // _ALIGN) * _ALIGN
    return spans, off


class _Slot:
    """One staging buffer: a uint8 tensor (pinned on a CUDA engine),
    its numpy view, and the event of an H2D that may still read it."""

    def __init__(self, nbytes: int, pin: bool):
        self.tensor = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        self.array = self.tensor.numpy()
        self.pending: Optional[torch.cuda.Event] = None

    def settle(self) -> None:
        """Wait (on the host) until no copy reads the slot any more."""
        if self.pending is not None:
            self.pending.synchronize()
            self.pending = None


class Lanes:
    """Streams, pinned slots and host threads of one live engine."""

    def __init__(self, device: torch.device, *, slot_bytes: int, slots: int,
                 threads: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.streams: Dict[str, Optional[torch.cuda.Stream]] = {
            lane: torch.cuda.Stream(device=device) if self.cuda else None
            for lane in LANES
        }
        self.slot_bytes = int(slot_bytes)
        self.threads = int(threads)
        self._slots = [_Slot(self.slot_bytes, self.cuda)
                       for _ in range(slots)]
        self._free: Deque[_Slot] = deque(self._slots)
        self._pool = (ThreadPoolExecutor(threads, "ooc-lane")
                      if threads else None)
        self._lock = threading.Lock()
        # host threads issue H2D copies one unit at a time, so that the
        # h2d stream's spans do not interleave and their sum is its busy
        self.h2d_issue = threading.Lock()
        # CUDA events around the copies and compute spans not yet
        # folded into ``_busy``, per lane
        self.spans: Dict[str, Deque[Tuple[torch.cuda.Event,
                                          torch.cuda.Event]]] = {
            lane: deque() for lane in LANES}
        self._busy = {lane: 0.0 for lane in LANES}
        self.job_s = 0.0  # host-thread seconds in transport jobs
        self.wait_s = 0.0  # caller seconds blocked on those jobs
        # of ``wait_s``, the seconds in which the job waited on was
        # digesting: crc32 left on the caller's critical path
        self.crc_wait_s = 0.0
        self.jobs = 0

    @property
    def pinned_bytes(self) -> int:
        return len(self._slots) * self.slot_bytes if self.cuda else 0

    @property
    def free_slots(self) -> int:
        """Slots in the pool (all of them when no crossing holds one)."""
        return len(self._free)

    # ------------------------------------------------------------------
    # streams and events
    # ------------------------------------------------------------------
    def on(self, lane: str):
        """Make ``lane``'s stream current (nothing on the CPU)."""
        s = self.streams[lane]
        return torch.cuda.stream(s) if s is not None else (
            contextlib.nullcontext())

    def mark(self, lane: str) -> Optional[torch.cuda.Event]:
        """An event recorded now on ``lane``'s stream."""
        s = self.streams[lane]
        return s.record_event() if s is not None else None

    def wait(self, lane: str, event: Optional[torch.cuda.Event]) -> None:
        """Make ``lane``'s stream wait for ``event``."""
        s = self.streams[lane]
        if s is not None and event is not None:
            s.wait_event(event)

    @contextlib.contextmanager
    def span(self, lane: str):
        """Time the work issued inside on ``lane``'s stream."""
        s = self.streams[lane]
        if s is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(s)
        try:
            yield
        finally:
            end.record(s)
            spans = self.spans[lane]
            spans.append((start, end))
            # a long run folds the spans its stream has finished
            while len(spans) > 256 and spans[0][1].query():
                a, b = spans.popleft()
                self._busy[lane] += a.elapsed_time(b) / 1e3

    def busy_s(self) -> Dict[str, float]:
        """Seconds each stream was busy with the engine's spans."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return {lane: self._busy[lane]
                + sum(a.elapsed_time(b) for a, b in spans) / 1e3
                for lane, spans in self.spans.items()}

    # ------------------------------------------------------------------
    # slots and jobs
    # ------------------------------------------------------------------
    def _acquire(self, nbytes: int) -> _Slot:
        if nbytes > self.slot_bytes:
            raise ValueError(
                f"a unit of {nbytes} bytes does not fit the "
                f"{self.slot_bytes}-byte staging slots"
            )
        if not self._free:
            raise RuntimeError(
                f"all {len(self._slots)} staging slots are held: the "
                "pool is smaller than the engine's window"
            )
        return self._free.popleft()

    def _release(self, slot: _Slot) -> None:
        self._free.append(slot)

    def _submit(self, fn: Callable[[], object]) -> Future:
        def timed():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                with self._lock:
                    self.job_s += time.perf_counter() - t0
                    self.jobs += 1

        if self._pool is not None:
            return self._pool.submit(timed)
        fut: Future = Future()
        try:
            fut.set_result(timed())
        except BaseException as exc:  # surfaced at result()
            fut.set_exception(exc)
        return fut

    def _result(self, fut: Future, digests: List[Tuple[float, float]]):
        """The job's result; the caller's seconds blocked on it add to
        ``wait_s``, and the part of them that overlaps the job's own
        ``digests`` spans to ``crc_wait_s``."""
        t0 = time.perf_counter()
        try:
            return fut.result()
        finally:
            t1 = time.perf_counter()
            self.wait_s += t1 - t0
            self.crc_wait_s += sum(max(0.0, min(b, t1) - max(a, t0))
                                   for a, b in digests)

    @staticmethod
    def digest(value, version: int, spans: List[Tuple[float, float]]):
        """``outofcore.unit_checksum``, its span appended to ``spans``."""
        t0 = time.perf_counter()
        try:
            return outofcore.unit_checksum(value, version)
        finally:
            spans.append((t0, time.perf_counter()))

    def close(self) -> None:
        """Stop the host threads (pending jobs run to their end)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------------
    # the two crossings
    # ------------------------------------------------------------------
    def fetch(self, host, version: int) -> "Fetch":
        """Start moving a host unit to the device (see ``Fetch``)."""
        return Fetch(self, host, version)

    def writeback(self, value, version: int,
                  after: Optional[torch.cuda.Event]) -> "Writeback":
        """Start moving a device unit to the host once the compute work
        behind ``after`` is done (see ``Writeback``)."""
        return Writeback(self, value, version, after)


class Fetch:
    """One H2D crossing in flight.

    A host thread fills a slot from the store's arrays, issues the copy
    into a tensor allocated on the h2d stream, records its event and
    digests the slot. ``send`` (the store's transport hook) returns
    ``(host, digest)``: on its first call the thread's, on a later call
    (a retry after a mismatch) from a new crossing made on the caller's
    thread. ``value()`` is the device unit, for the compute stream,
    after the store accepted the digest.
    """

    def __init__(self, lanes: Lanes, host, version: int):
        self.lanes, self.host, self.version = lanes, host, int(version)
        arrays = [np.ascontiguousarray(a) for a in _parts(host)]
        self._spans, total = _layout(arrays)
        self._arrays = arrays
        self._slot = lanes._acquire(total)
        self._digests: List[Tuple[float, float]] = []
        self._job = lanes._submit(self._move)
        self._dev = None
        self._done = False

    def _move(self):
        lanes, slot = self.lanes, self._slot
        slot.settle()
        views = []
        for a, (off, n) in zip(self._arrays, self._spans):
            v = slot.array[off:off + n].view(a.dtype).reshape(a.shape)
            np.copyto(v, a)
            views.append(v)
        with lanes.h2d_issue, lanes.on("h2d"), lanes.span("h2d"):
            parts = []
            for a, (off, n) in zip(self._arrays, self._spans):
                t = torch.empty(n, dtype=torch.uint8, device=lanes.device)
                t.copy_(slot.tensor[off:off + n], non_blocking=True)
                parts.append(_from_bytes(t, _DTYPES[a.dtype], a.shape))
            event = lanes.mark("h2d")
        digest = lanes.digest(_rebuild(self.host, views), self.version,
                              self._digests)
        return _rebuild(self.host, parts), event, digest

    def send(self):
        if self._dev is None:
            self._dev = self.lanes._result(self._job, self._digests)
        else:  # a retry: cross again, here, once the last copy is done
            self._slot.pending = self._dev[1]
            self._dev = self._move()
        return self.host, self._dev[2]

    def value(self):
        """The device unit, ordered after its copy on the compute
        stream; the slot goes back to the pool."""
        if not self._done:
            if self._dev is None:
                raise RuntimeError("fetch claimed before it was verified")
            dev, event, _ = self._dev
            lanes = self.lanes
            lanes.wait("compute", event)
            if lanes.cuda:
                for t in _parts(dev):
                    t.record_stream(lanes.streams["compute"])
            self._slot.pending = event
            lanes._release(self._slot)
            self._dev, self._done = dev, True
        return self._dev

    def abandon(self) -> None:
        """Give the slot back unclaimed (a rollback drops the unit): once
        the host job is done with it, and with the event of a copy that
        may still read it."""
        if not self._done:
            if self._job.exception() is None:
                self._slot.pending = (self._dev or self._job.result())[1]
            self.lanes._release(self._slot)
            self._done = True


class Writeback:
    """One D2H crossing in flight.

    The d2h stream waits for the compute event (and for any H2D still
    reading the slot), copies the unit's arrays into the slot and
    records an event. A host thread waits on it, digests the slot (the
    bytes as they left the device), copies them into arrays the store
    will own and digests those. ``result()`` gives ``(host, crc)`` and
    ``send`` the store's ``(received, digest)``; ``release()`` returns
    the slot.
    """

    def __init__(self, lanes: Lanes, value, version: int,
                 after: Optional[torch.cuda.Event]):
        self.lanes, self.value, self.version = lanes, value, int(version)
        parts = [t for t in _parts(value)]
        self._meta = [(_np_dtype(t), tuple(t.shape)) for t in parts]
        self._spans, total = _layout(parts)
        self._slot = slot = lanes._acquire(total)
        lanes.wait("d2h", after)
        lanes.wait("d2h", slot.pending)
        slot.pending = None
        # the span starts after the waits: it times the copies alone
        with lanes.on("d2h"), lanes.span("d2h"):
            for t, (off, n) in zip(parts, self._spans):
                slot.tensor[off:off + n].copy_(_as_bytes(t),
                                               non_blocking=True)
                if lanes.cuda:
                    t.record_stream(lanes.streams["d2h"])
        self._event = lanes.mark("d2h")
        self._digests: List[Tuple[float, float]] = []
        self._job = lanes._submit(self._land)
        self._got = None
        self._sent = False

    def _views(self):
        return [self._slot.array[off:off + n].view(dt).reshape(shape)
                for (dt, shape), (off, n) in zip(self._meta, self._spans)]

    def _copy_out(self):
        host = _rebuild(self.value, [np.array(v) for v in self._views()])
        return host, self.lanes.digest(host, self.version, self._digests)

    def _land(self):
        if self._event is not None:
            self._event.synchronize()
        crc = self.lanes.digest(_rebuild(self.value, self._views()),
                                self.version, self._digests)
        host, digest = self._copy_out()
        return host, crc, digest

    def result(self):
        """``(host, crc)``: the store's copy and the digest of the bytes
        as they left the device."""
        if self._got is None:
            self._got = self.lanes._result(self._job, self._digests)
        return self._got[0], self._got[1]

    def send(self):
        host, _ = self.result()
        if not self._sent:
            self._sent = True
            return host, self._got[2]
        return self._copy_out()  # a retry: copy the slot again

    def release(self) -> None:
        """Return the slot, once the host job is done with it (a job
        that failed has its error raised by ``result``, not here)."""
        if self._slot is not None:
            self._job.exception()
            self.lanes._release(self._slot)
            self._slot = None

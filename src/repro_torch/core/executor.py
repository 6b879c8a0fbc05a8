"""Asynchronous out-of-core executor: the live engine.

Port of ``repro.core.executor.AsyncExecutor``: the paper's overlap of
H2D transfer, on-device codec and stencil work, and D2H transfer
(paper Fig. 4). It walks the shared task graph
(``taskgraph.build_sweep_tasks``) for real:

* an ``h2d`` task stages a host unit onto the device, unless the unit's
  current version is resident in the residency manager
  (``unitcache.DeviceResidencyManager``), which elides the transfer;
* ``decompress``/``stencil``/``compress`` tasks launch the kernels;
* a ``d2h`` task is parked in the in-flight window and committed to the
  host store only when the window must drain.

The window holds at most ``depth`` block visits with pending writebacks
(default 2) and stays open across sweep boundaries: block 0 of sweep
``s+1`` fetches while the tail of sweep ``s`` still writes back. A fetch
whose newest version is still parked drains the window up to that
writeback first (the fetch-after-writeback hazard). Under write-back
residency (``cache_bytes > 0``, the default policy) a parked writeback
whose dirty deposit was stored commits its version with no host copy
(``HostUnitStore.commit_device``); the bytes cross the link only when
residency is lost: flush-on-evict, ``flush()`` and ``gather()``.

Where JAX gave the reference its overlap by async dispatch and a
deferred ``np.asarray``, the port builds it from ``streams.Lanes``:
H2D, compute and D2H CUDA streams ordered by events, a pinned staging
pool sized by the window, and host threads that copy and crc32-digest
units beside the streams. A digest is still verified by the store
(and retried under its ``RetryPolicy``) before the unit it guards is
decoded or committed. On the CPU (``device="cpu"``, ``backend="ref"``)
the same code runs with no streams.

Numerics: the same ops on the same values as ``OutOfCoreWave``, and the
round trips residency elides are byte-preserving, so the output is bit
for bit the synchronous engine's.

Not ported yet, each raising with its ROADMAP queue 1 item:
checkpointing (``checkpoint``, ``begin_checkpoint``, ``restore``,
``run(ckpt_policy=)``: item 7b), rollback and replay
(``run(recovery=)``: item 7c), and sharding (``shard=`` and the halo
methods: item 11).
"""

from __future__ import annotations

import os
import statistics
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.outofcore import HostUnitStore, OOCConfig, \
    engine_device, unit_bytes
from repro_torch.core.ratecontrol import rate_label
from repro_torch.core.streams import Fetch, Lanes, Writeback
from repro_torch.core.taskgraph import (
    SHARDING_TODO,
    Schedule,
    Task,
    Transfer,
    build_sweep_tasks,
    get_schedule,
    summarize_transfers,
)
from repro_torch.core.unitcache import DeviceResidencyManager, Entry
from repro_torch.distributed.fault import (
    FaultInjector,
    InjectedCrash,
    ReissuePolicy,
    RetryPolicy,
)
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp import ref as zfp_ref
from repro_torch.kernels.zfp.ref import Compressed

CHECKPOINT_TODO = (
    "checkpointing of the live engine is not ported yet: ROADMAP.md "
    "queue 1 item 7b (after item 9)"
)
RECOVERY_TODO = (
    "rollback-and-replay recovery is not ported yet: ROADMAP.md queue 1 "
    "item 7c"
)

UnitKey = Tuple[str, Tuple[str, int]]  # (field, (kind, idx))

# host threads that copy and digest units beside the streams: each copy
# and each crc32 holds one core, and a visit moves up to ten units
HOST_THREADS = min(8, os.cpu_count() or 1)

# one parked visit: (producing sweep, [(task, value, raw, version,
# writeback in flight or None)])
_Parked = Tuple[int, List[Tuple[Task, object, int, int,
                                Optional[Writeback]]]]


def _rate(value) -> str:
    """Rate label of a unit value for the per-rate byte gauges."""
    return rate_label(value.planes if isinstance(value, Compressed)
                      else None)


class _Incoming:
    """A unit on its way to the device: verified by the store on first
    claim, then the device value. Deposited as is for read-only units,
    so a later hit claims the same crossing."""

    def __init__(self, store: HostUnitStore, field: str, kind: str,
                 idx: int, fetch: Fetch):
        self.store, self.key, self.fetch = store, (field, kind, idx), fetch
        self.compressed = isinstance(fetch.host, Compressed)
        self._value = None

    def value(self):
        if self._value is None:
            self.store.cross_h2d(*self.key, self.fetch.send)
            self._value = self.fetch.value()
        return self._value


def _claim(value):
    return value.value() if isinstance(value, _Incoming) else value


class AsyncExecutor:
    """Executes the out-of-core task graph with a bounded in-flight
    window across sweep boundaries, deferred writebacks and device
    residency, on three streams."""

    def __init__(
        self,
        cfg: OOCConfig,
        p_prev: Optional[np.ndarray] = None,
        p_cur: Optional[np.ndarray] = None,
        vel2: Optional[np.ndarray] = None,
        schedule: Union[str, Schedule] = "depth2",
        cache_bytes: int = 0,
        policy: str = "write-back",
        reissue: Optional[ReissuePolicy] = None,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        shard=None,
        rates=None,
    ):
        """Build a live executor over ``cfg``.

        ``p_prev, p_cur, vel2`` are the full initial fields (all three,
        or none for an unseeded store). ``schedule`` is ``"paper"``,
        ``"unitgrain"``/``"overlap"``, ``"depth-k"`` or
        ``"temporal-k"``; windowless schedules run double-buffered.
        ``cache_bytes`` is the residency budget (0 = off) and
        ``policy`` ``"write-back"`` or ``"write-through"``.
        ``retry`` governs every crossing (``reissue``, a two-attempt
        policy, stands in for it and also re-puts a failed flush once);
        ``injector`` replays a ``FaultPlan`` on every crossing and its
        crash points at sweep boundaries. ``rates`` is a
        ``RateController``.
        """
        if shard is not None:
            raise NotImplementedError(SHARDING_TODO)
        self.device = engine_device(cfg)
        self.cfg = cfg
        self.schedule = get_schedule(schedule)
        self.temporal = self.schedule.temporal
        self.plan = cfg.temporal_plan(self.temporal)
        self.plan.check_cover()
        self.depth = self.schedule.window or 2
        self.reissue = reissue if reissue is not None else retry
        self.retry = retry if retry is not None else reissue
        self.injector = injector
        self.shard = None
        self.cache = DeviceResidencyManager(cache_bytes, policy=policy)
        self.rates = rates
        self.store = HostUnitStore(
            cfg, plan=self.plan, injector=injector, retry=self.retry,
            stats=self.cache.stats, rates=rates,
        )
        slot_bytes, slots = self._staging_plan()
        self.lanes = Lanes(self.device, slot_bytes=slot_bytes, slots=slots,
                           threads=HOST_THREADS)
        seeds = (p_prev, p_cur, vel2)
        if any(s is not None for s in seeds):
            if not all(s is not None for s in seeds):
                raise ValueError("seed all three fields or none")
            self.store.seed({"p_prev": p_prev, "p_cur": p_cur,
                             "vel2": vel2})
        # monotonic clock for flush straggler detection
        self._timer = time.perf_counter
        self._flush_times: List[float] = []
        self.transfers: List[Transfer] = []
        self.sweeps_done = 0
        self.max_inflight = 0  # peak block visits with pending D2H
        # the cache-free one-round template, replayed every round
        self._by_block: List[List[Task]] = [[] for _ in range(
            self.plan.ndiv)]
        for t in build_sweep_tasks(cfg, sweeps=1, schedule=self.schedule):
            self._by_block[t.block].append(t)
        # live state
        self._dev: Dict[UnitKey, object] = {}
        self._staged: Dict[UnitKey, object] = {}
        self._outvals: Dict[UnitKey, object] = {}
        self._outraw: Dict[UnitKey, int] = {}
        # newest issued (committed or parked) version per unit
        self._ver: Dict[UnitKey, int] = {}
        # visits whose d2h tasks are parked, oldest first; survives
        # sweep boundaries (the cross-sweep window)
        self._pending: Deque[_Parked] = deque()

    def _staging_plan(self) -> Tuple[int, int]:
        """``(slot_bytes, slots)`` of the pinned pool: a slot holds the
        largest unit raw or encoded at the largest rate in use; a visit
        holds its fetches until they are claimed, and the window holds
        ``depth`` visits' writebacks, plus one slot for a flush."""
        _, y, x = self.cfg.shape
        itemsize = np.dtype(self.cfg.dtype).itemsize
        planes = [sp.planes for sp in self.cfg.fields.values()
                  if sp.compressed]
        if self.rates is not None and planes:
            planes += list(self.rates.ladder)
        align = lambda n: -(-n // 256) * 256  # noqa: E731
        slot = 0
        for _, _, (lo, hi) in self.plan.units():
            slot = max(slot, align((hi - lo) * y * x * itemsize))
            nb = -(-(hi - lo) // 4) * -(-y // 4) * -(-x // 4)
            for p in planes:
                words = zfp_ref.payload_words(3, p, 8 * itemsize)
                slot = max(slot, align(nb * words * 4) + align(nb * 4))
        nrw = sum(sp.role == "rw" for sp in self.cfg.fields.values())
        fetch = max(len(self.plan.fetch_units(i))
                    for i in range(self.plan.ndiv)) * len(self.cfg.fields)
        wb = max(len(self.plan.writeback_units(i))
                 for i in range(self.plan.ndiv)) * nrw
        return slot, fetch + self.depth * wb + 1

    # ------------------------------------------------------------------
    # the halo exchange of a sharded run (item 11)
    # ------------------------------------------------------------------
    def deliver_held(self, name, value):
        raise NotImplementedError(SHARDING_TODO)

    def take_held(self):
        raise NotImplementedError(SHARDING_TODO)

    def take_halo(self):
        raise NotImplementedError(SHARDING_TODO)

    def deliver_halo(self, field, kind, idx, value, version):
        raise NotImplementedError(SHARDING_TODO)

    # ------------------------------------------------------------------
    # window management
    # ------------------------------------------------------------------
    def _drain_one(self) -> None:
        """Retire the oldest visit's writebacks.

        Write-through: every writeback is committed to the host. Write-
        back: a writeback whose payload is still dirty-resident commits
        its version with no host copy; one whose payload was evicted has
        been flushed already; only a payload that never gained residency
        pays its D2H here."""
        sweep_no, parked = self._pending.popleft()
        # every writeback in flight gives its slot back, also when a put
        # fails
        inflight = [p[4] for p in parked if p[4] is not None]
        try:
            for task, value, raw, ver, wb in parked:
                kind, idx = task.unit
                if self.cache.enabled and self.cache.write_back:
                    if self.store.version_of(task.field, kind, idx) >= ver:
                        continue  # an eviction flush committed this
                    ent = self.cache.peek((task.field, task.unit))
                    if ent is not None and ent.dirty and ent.version >= ver:
                        self.store.commit_device(task.field, kind, idx, ver)
                        continue
                if wb is None:
                    wb = self.lanes.writeback(value, ver,
                                              self.lanes.mark("compute"))
                    inflight.append(wb)
                host, crc = wb.result()
                wire = self.store.put(task.field, kind, idx, host,
                                      version=ver, crc=crc, send=wb.send)
                self.transfers.append(Transfer(
                    "d2h", task.field, task.unit, raw, wire,
                    sweep_no, task.block,
                ))
        finally:
            for wb in inflight:
                wb.release()

    def _drain_all(self) -> None:
        while self._pending:
            self._drain_one()

    def _admit(self) -> None:
        """Admit a block visit to the window, draining if at depth."""
        while len(self._pending) >= self.depth:
            self._drain_one()

    def _drain_for(self, key: UnitKey) -> None:
        """Fetch-after-writeback hazard: drain until ``key``'s host copy
        holds its newest issued version."""
        field, (kind, idx) = key
        while (self._pending and
               self.store.version_of(field, kind, idx)
               < self._ver.get(key, 0)):
            self._drain_one()

    # ------------------------------------------------------------------
    # task actions
    # ------------------------------------------------------------------
    def _exec_h2d(self, task: Task) -> None:
        key = (task.field, task.unit)
        ver = self._ver.get(key, 0)
        if self.cache.enabled:
            hit, cached = self.cache.lookup(key, ver)
            if hit:
                # current version resident: H2D elided, no record
                compressed = (cached.compressed
                              if isinstance(cached, _Incoming)
                              else isinstance(cached, Compressed))
                (self._staged if compressed else self._dev)[key] = cached
                return
        self._drain_for(key)
        kind, idx = task.unit
        stored = self.store.get(task.field, kind, idx)
        raw, wire = unit_bytes(stored)
        incoming = _Incoming(
            self.store, task.field, kind, idx,
            self.lanes.fetch(
                stored, self.store.host_version_of(task.field, kind, idx)),
        )
        if incoming.compressed:
            self._staged[key] = incoming  # decompress task completes it
        else:
            self._dev[key] = incoming
        if self.cache.enabled and self.cfg.fields[task.field].role != "rw":
            # never written back: deposit the fetched unit so later
            # sweeps hit (rw fields deposit at writeback instead)
            res = self.cache.deposit(
                key, ver, incoming, wire,
                rate=_rate(stored) if self.rates is not None else None,
            )
            for ekey, eent in res.flushes:
                self._flush_entry(ekey, eent, task.block)
        self.transfers.append(Transfer(
            "h2d", task.field, task.unit, raw, wire,
            self.sweeps_done, task.block,
        ))

    def _claim_visit(self) -> None:
        """Wait for this visit's fetches, have the store verify their
        digests, and order the compute stream after their copies."""
        for units in (self._staged, self._dev):
            for key in list(units):
                units[key] = _claim(units[key])

    def _exec_decompress(self, tasks: List[Task]) -> None:
        """Decode a visit's staged units. Under adaptive rates a unit
        stored raw arrives in ``_dev`` and has nothing to decode."""
        if not tasks:
            return
        keys = [k for k in ((t.field, t.unit) for t in tasks)
                if k in self._staged]
        decoded = zfp_ops.decompress_units(
            [self._staged.pop(k) for k in keys], backend=self.cfg.backend,
        )
        for k, arr in zip(keys, decoded):
            self._dev[k] = arr

    def _assemble(self, name: str, i: int,
                  shared: Optional[torch.Tensor]) -> torch.Tensor:
        """Fetched (B+2H, Y, X) device field for block i, from staged
        units and the on-device carry: the synchronous engine's
        assembly."""
        plan = self.plan
        h, b = plan.halo, plan.block
        _, y, x = self.cfg.shape

        dtype = getattr(torch, self.cfg.dtype)

        def zeros(n):
            return torch.zeros((n, y, x), dtype=dtype, device=self.device)

        pieces = [zeros(h) if i == 0 else shared]
        pieces += [self._dev.pop((name, u)) for u in plan.fetch_units(i)]
        if i == plan.ndiv - 1:
            pieces.append(zeros(h))
        out = torch.cat(pieces, dim=0)
        assert out.shape[0] == b + 2 * h, out.shape
        return out

    def _exec_stencil(
        self,
        i: int,
        shared: Dict[str, Optional[torch.Tensor]],
        held: Dict[str, torch.Tensor],
        kr: int,
    ) -> Dict[str, Optional[torch.Tensor]]:
        """Assemble, run ``bt * kr`` fused steps, slice out the
        writeback units. Returns the carry (time-t common regions) for
        block i+1."""
        cfg, plan = self.cfg, self.plan
        h, b = plan.halo, plan.block
        dev: Dict[str, torch.Tensor] = {}
        new_shared: Dict[str, torch.Tensor] = {}
        for name in cfg.fields:
            arr = self._assemble(name, i, shared[name])
            if i < plan.ndiv - 1:
                new_shared[name] = arr[b : b + 2 * h]
            dev[name] = arr
        pp, pc = stencil_ops.fused_temporal_steps(
            dev["p_prev"], dev["p_cur"], dev["vel2"],
            steps=cfg.bt * kr, backend=cfg.backend,
        )
        s, _ = plan.owned(i)
        for name, new in (("p_prev", pp), ("p_cur", pc)):
            owned = new[h : h + b]
            for kind, idx in plan.writeback_units(i):
                if kind == "R":
                    rlo, rhi = plan.remainder(i)
                    val = owned[rlo - s : rhi - s]
                else:  # completed C_{i-1}: held lower half + our upper
                    val = torch.cat([held[name + str(i - 1)], owned[:h]])
                self._outvals[(name, (kind, idx))] = val
                self._outraw[(name, (kind, idx))] = (
                    val.numel() * val.element_size())
            if i < plan.ndiv - 1:
                held[name + str(i)] = owned[b - h : b]
        return {n: new_shared.get(n) for n in cfg.fields}

    def _exec_compress(self, tasks: List[Task]) -> None:
        """Encode a visit's writeback units, each at its rate for the
        round (``rate_for`` at the round-start sweep, as the graph
        builder replays); rate-None units commit raw. Every encode feeds
        the controller one observation."""
        by_planes: Dict[int, List[Task]] = {}
        for t in tasks:
            kind, idx = t.unit
            if self.rates is not None:
                planes = self.rates.rate_for(
                    t.field, kind, idx, self.sweeps_done
                )
            else:
                planes = self.cfg.fields[t.field].planes
            if planes is None:
                # lossless commit: the raw unit ships as is, error 0
                val = self._outvals[(t.field, t.unit)]
                self.rates.observe(t.field, kind, idx, None, 0.0,
                                   float(val.abs().max()))
                continue
            by_planes.setdefault(planes, []).append(t)
        for planes, ts in by_planes.items():
            vals = [self._outvals[(t.field, t.unit)] for t in ts]
            encoded = zfp_ops.compress_units(
                vals, planes=planes, ndim=3, backend=self.cfg.backend,
            )
            if self.rates is not None:
                for t, v in zip(ts, vals):
                    kind, idx = t.unit
                    q = zfp_ops.quantize(v, planes=planes, ndim=3)
                    self.rates.observe(
                        t.field, kind, idx, planes,
                        float((q - v).abs().max()), float(v.abs().max()),
                    )
            for t, c in zip(ts, encoded):
                self._outvals[(t.field, t.unit)] = c

    def _flush_entry(
        self, key: UnitKey, ent: Entry, block: int, mark: bool = False,
        reissued: bool = False,
    ) -> None:
        """Commit one dirty payload to the host store and record the
        flush. ``mark`` (the explicit flush) clears the dirty bit after
        the put, so a failed put leaves the entry dirty for a retry;
        evicted entries were accounted by the manager when popped.
        ``reissued`` tags the spare-stream second attempt."""
        field, (kind, idx) = key
        wb = self.lanes.writeback(ent.value, ent.version,
                                  self.lanes.mark("compute"))
        try:
            host, crc = wb.result()
            wire = self.store.put(field, kind, idx, host,
                                  version=ent.version, crc=crc,
                                  send=wb.send)
        finally:
            wb.release()
        if mark:
            self.cache.mark_flushed(key)
        self.transfers.append(Transfer(
            "d2h", field, (kind, idx), unit_bytes(ent.value)[0], wire,
            self.sweeps_done, block, flush=True, reissued=reissued,
        ))

    def _park_writebacks(self, btasks: List[Task], kr: int = 1) -> None:
        """Bump unit versions (by ``kr``), deposit the device payloads
        into residency (dirty under write-back), start the D2H of every
        writeback whose deposit was not stored, and park the visit in
        the window. Dirty LRU victims of the deposits flush here."""
        parked = []
        after = None
        for t in (t for t in btasks if t.kind == "d2h"):
            key = (t.field, t.unit)
            val = self._outvals.pop(key)
            raw = self._outraw.pop(key)
            ver = self._ver.get(key, 0) + kr
            self._ver[key] = ver
            elided = False
            if self.cache.enabled:
                nbytes = unit_bytes(val)[1]
                res = self.cache.deposit(
                    key, ver, val, nbytes, dirty=True, bumps=kr,
                    rate=_rate(val) if self.rates is not None else None,
                )
                for ekey, eent in res.flushes:
                    self._flush_entry(ekey, eent, t.block)
                if res.stored and self.cache.write_back:
                    # a stored deposit is committed and never pays its
                    # own D2H (see the reference's reasoning): account
                    # the elision now, in lockstep with the graph
                    self.cache.note_d2h_elided(nbytes)
                    elided = True
            wb = None
            if not elided:
                if after is None:
                    after = self.lanes.mark("compute")
                wb = self.lanes.writeback(val, ver, after)
            parked.append((t, val, raw, ver, wb))
        if parked:
            self._pending.append((self.sweeps_done, parked))
        self.max_inflight = max(self.max_inflight, len(self._pending))

    # ------------------------------------------------------------------
    # sweep loop
    # ------------------------------------------------------------------
    def sweep(self, sweeps: Optional[int] = None) -> None:
        """One overlapped round over all blocks: ``bt * sweeps`` steps a
        visit (``sweeps`` defaults to the schedule's temporal fusion).
        No round-end drain: up to ``depth`` tail visits stay parked;
        ``finish()`` (or ``gather()``/``run()``) drains them."""
        kr = self.temporal if sweeps is None else sweeps
        if not 1 <= kr <= self.temporal:
            raise ValueError(f"sweeps={kr} outside 1..{self.temporal}")
        held: Dict[str, torch.Tensor] = {}
        shared: Dict[str, Optional[torch.Tensor]] = {
            n: None for n in self.cfg.fields
        }
        with self.lanes.on("compute"):
            for i in range(self.plan.ndiv):
                btasks = self._by_block[i]
                # window admission precedes this visit's first transfer
                self._admit()
                for t in (t for t in btasks if t.kind == "h2d"):
                    self._exec_h2d(t)
                self._claim_visit()
                with self.lanes.span("compute"):
                    self._exec_decompress(
                        [t for t in btasks if t.kind == "decompress"]
                    )
                    shared = self._exec_stencil(i, shared, held, kr)
                    self._exec_compress(
                        [t for t in btasks if t.kind == "compress"]
                    )
                self._park_writebacks(btasks, kr)
        assert not self._dev and not self._staged and not self._outvals
        self.sweeps_done += kr
        if self.rates is not None:
            # the synchronous engine decides at the same boundary, so
            # both record identical decision logs
            self.rates.decide(self.sweeps_done)

    def finish(self) -> None:
        """Drain the window: every issued writeback is committed, on the
        host or (write-back) on the device. Dirty residents stay; call
        ``flush()`` (``gather()`` does) before reading the store."""
        self._drain_all()

    def flush(self) -> int:
        """Flush-on-demand: commit every dirty resident to the host
        store, oldest (LRU) first. Entries stay resident, clean. Returns
        the number of units flushed.

        Without ``reissue`` a failed put raises and leaves its entry
        dirty, so a retry flushes exactly the remainder. With it, a
        failed put is re-put once (``CacheStats.flush_reissues``) and a
        put slower than ``reissue.deadline`` of the median is counted in
        ``CacheStats.flush_stragglers``."""
        n = 0
        for key, ent in self.cache.dirty_entries():
            t0 = self._timer()
            reissued = False
            try:
                self._flush_entry(key, ent, -1, mark=True)
            except Exception:
                if self.reissue is None:
                    raise
                self._flush_entry(key, ent, -1, mark=True, reissued=True)
                self.cache.stats.flush_reissues += 1
                reissued = True
            elapsed = self._timer() - t0
            if not reissued:
                if (
                    self.reissue is not None
                    and self._flush_times
                    and self.reissue.should_reissue(
                        elapsed, statistics.median(self._flush_times)
                    )
                ):
                    self.cache.stats.flush_stragglers += 1
                self._flush_times.append(elapsed)
                if len(self._flush_times) > 64:  # rolling window
                    self._flush_times.pop(0)
            n += 1
        return n

    def run(self, total_steps: int, ckpt_policy=None,
            recovery=None) -> None:
        """Advance the run by ``total_steps`` (a multiple of ``bt``) and
        drain the window."""
        if ckpt_policy is not None:
            raise NotImplementedError(CHECKPOINT_TODO)
        if recovery is not None:
            raise NotImplementedError(RECOVERY_TODO)
        if total_steps % self.cfg.bt:
            raise ValueError(
                f"total_steps={total_steps} is not a multiple of "
                f"bt={self.cfg.bt}"
            )
        self._run_to(self.sweeps_done + total_steps // self.cfg.bt)

    def advance_round(self, target: int) -> int:
        """Advance one temporal round toward ``target`` completed sweeps
        (the cooperative yield point). Returns the sweeps advanced (0 at
        ``target``); raises ``InjectedCrash`` when the injector has a
        crash point due at the new boundary."""
        if self.sweeps_done >= target:
            return 0
        kr = min(self.temporal, target - self.sweeps_done)
        self.sweep(kr)
        if self.injector is not None and self.injector.crash_point(
            self.sweeps_done
        ):
            raise InjectedCrash(
                f"injected crash at sweep boundary {self.sweeps_done}"
            )
        return kr

    def _run_to(self, target: int) -> None:
        while self.sweeps_done < target:
            self.advance_round(target)
        self.finish()

    # ------------------------------------------------------------------
    # checkpointing (item 7b)
    # ------------------------------------------------------------------
    def checkpoint(self, *args, **kwargs):
        raise NotImplementedError(CHECKPOINT_TODO)

    def begin_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(CHECKPOINT_TODO)

    @classmethod
    def restore(cls, *args, **kwargs):
        raise NotImplementedError(CHECKPOINT_TODO)

    # ------------------------------------------------------------------
    def gather(self, name: str) -> np.ndarray:
        self.finish()
        self.flush()
        return self.store.gather(name)

    def close(self) -> None:
        """Stop the transport's host threads."""
        self.lanes.close()

    def transfer_summary(self) -> Dict[str, int]:
        return summarize_transfers(self.transfers)

    def stats(self) -> Dict[str, object]:
        return {
            "depth": self.depth,
            "max_inflight": self.max_inflight,
            "sweeps": self.sweeps_done,
            "pending": len(self._pending),
            "policy": self.cache.policy,
            "cache": self.cache.stats.as_dict(),
            "cache_bytes_used": self.cache.bytes_used,
            "cache_peak_bytes": self.cache.peak_bytes,
            "cache_dirty_bytes": self.cache.dirty_bytes,
            "wire": dict(self.store.wire_stats),
            "wire_backoff_s": self.store.backoff_s,
            "injected": (
                dict(self.injector.counts)
                if self.injector is not None else {}
            ),
            "lanes": {
                "streams": len({s.cuda_stream for s in
                                self.lanes.streams.values()
                                if s is not None}),
                "pinned_bytes": self.lanes.pinned_bytes,
                "host_job_s": self.lanes.job_s,
                "host_wait_s": self.lanes.wait_s,
                "crc_wait_s": self.lanes.crc_wait_s,
                "host_jobs": self.lanes.jobs,
            },
        }

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

Checkpoints (``repro_torch.checkpoint``, the reference's on-disk format):
``checkpoint(dir)`` quiesces the window, flushes residency and persists
the store, its version vector and the engine's progress in one call;
``begin_checkpoint(dir)`` (or ``run(ckpt_policy=CheckpointPolicy(...))``)
is the overlapped cut: it freezes the version vector at a sweep boundary
without draining the window, pins the dirty residents copy-on-write and
writes the snapshot a chunk a block visit of the next sweep, a pinned
unit's snapshot D2H going through one staging slot at a time on the d2h
stream. ``restore(dir)`` rebuilds an engine (on the CUDA device unless
``device="cpu"``) that resumes bit for bit; ``run(recovery=
RecoveryPolicy(dir))`` rolls back to the last good checkpoint on an
unrecoverable fault and replays, giving back every staging slot the lost
crossings held.

Sharding (``shard=``, a ``distributed.sharding.ShardSpec``): the engine
walks one contiguous block range of the global plan, its store holding
only that range's units, and ``core.sharded.ShardedExecutor`` routes the
halo exchange between shards. A shard's first block imports the left
neighbour's held slice (``deliver_held``), the raw new-time planes its
boundary writeback concatenates, computed on the neighbour's compute
stream: the import waits on the neighbour's event and marks the tensor
for this engine's stream. Its last block exports its own
(``take_held``). Its first block's committed left common leaves the card
as a ``streams.Writeback`` after the encode's event (``take_halo``), its
digest taken as it leaves, and lands in the left neighbour's ghost as a
store crossing of op ``"halo"`` (``deliver_halo``).

Numerics: the same ops on the same values as ``OutOfCoreWave``, and the
round trips residency elides are byte-preserving, so the output is bit
for bit the synchronous engine's, sharded or not.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import statistics
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.outofcore import HostUnitStore, OOCConfig, \
    engine_device, unit_bytes, unit_shards
from repro_torch.core.ratecontrol import RateController, rate_label
from repro_torch.core.streams import Fetch, Lanes, Writeback
from repro_torch.core.taskgraph import (
    Schedule,
    Task,
    Transfer,
    build_sweep_tasks,
    get_schedule,
    summarize_transfers,
)
from repro_torch.core.unitcache import DeviceResidencyManager, Entry
from repro_torch.distributed.sharding import ShardSpec
from repro_torch.distributed.fault import (
    ChecksumError,
    FaultError,
    FaultInjector,
    InjectedCrash,
    ReissuePolicy,
    RetryPolicy,
    UnrecoverableFault,
)
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp import ref as zfp_ref
from repro_torch.kernels.zfp.ref import Compressed

# manifest schema version of AsyncExecutor.checkpoint payloads
CKPT_FORMAT = 1

UnitKey = Tuple[str, Tuple[str, int]]  # (field, (kind, idx))

# host threads that copy and digest units beside the streams: each copy
# and each crc32 holds one core, and a visit moves up to ten units
HOST_THREADS = min(8, os.cpu_count() or 1)

# one parked visit: (producing sweep, [(task, value, raw, version,
# writeback in flight or None)])
_Parked = Tuple[int, List[Tuple[Task, object, int, int,
                                Optional[Writeback]]]]


@dataclass
class CheckpointPolicy:
    """Periodic checkpoints for ``AsyncExecutor.run``, consulted at every
    sweep boundary: every ``every_sweeps`` completed sweeps and/or once
    ``wall_budget_s`` passed since the last snapshot. ``mode``
    ``"overlapped"`` (the default) takes the overlapped cut
    (``begin_checkpoint``), ``"quiesced"`` the one-call ``checkpoint``.
    ``zstd_level``/``keep`` pass through to the writer."""

    directory: str
    every_sweeps: Optional[int] = None
    wall_budget_s: Optional[float] = None
    mode: str = "overlapped"
    zstd_level: Optional[int] = None
    keep: int = 3

    def __post_init__(self):
        if self.mode not in ("overlapped", "quiesced"):
            raise ValueError(
                f"unknown checkpoint mode {self.mode!r}; "
                "expected 'overlapped' or 'quiesced'"
            )
        if self.every_sweeps is None and self.wall_budget_s is None:
            raise ValueError(
                "CheckpointPolicy needs every_sweeps and/or wall_budget_s"
            )
        if self.every_sweeps is not None and self.every_sweeps < 1:
            raise ValueError(
                f"every_sweeps must be >= 1, got {self.every_sweeps}"
            )

    def due(self, sweeps_done: int, elapsed_s: float) -> bool:
        """Whether a snapshot is due at boundary ``sweeps_done``,
        ``elapsed_s`` after the previous one (or the run's start)."""
        if self.every_sweeps and sweeps_done % self.every_sweeps == 0:
            return True
        return (
            self.wall_budget_s is not None
            and elapsed_s >= self.wall_budget_s
        )


@dataclass
class RecoveryPolicy:
    """Rollback and replay for ``AsyncExecutor.run``: on an
    unrecoverable fault (retries exhausted, a checksum mismatch with no
    good source, an injected crash point) the run reloads the newest
    checkpoint under ``directory`` that verifies and replays from it, at
    most ``max_restarts`` times. A baseline snapshot is taken first when
    the directory holds none."""

    directory: str
    max_restarts: int = 3
    zstd_level: Optional[int] = None
    keep: int = 3


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


def _version_vector(extra: Dict[str, object]) -> Dict[UnitKey, int]:
    """The issued version of every written unit in a checkpoint's unit
    table (the window was empty and residency flushed at the cut)."""
    return {
        (u["field"], (u["kind"], int(u["idx"]))): int(u["version"])
        for u in extra["store"]["units"].values()
        if int(u["version"]) > 0
    }


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
        residency=None,
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

        ``shard`` (a ``ShardSpec``) restricts the engine to one
        contiguous block range of the global plan: the store seeds only
        the shard's units, the sweep walks its blocks, and the halo
        methods exchange its boundaries (``ShardedExecutor`` routes
        them). The engine runs on ``shard.device`` when the shard is
        pinned, else on ``cfg.device``. Rate control does not compose
        with sharding (its halo exports price at the spec's rate).

        ``residency`` is a residency object used as it is in place of a
        private ``DeviceResidencyManager``: ``serving.ooc.TenantScheduler``
        passes each tenant a ``core.tenancy.TenantView`` over one shared,
        arbiter-managed manager. ``cache_bytes`` and ``policy`` are then
        ignored (the view carries both).
        """
        if rates is not None and shard is not None:
            raise ValueError(
                "rate control does not compose with sharding (halo "
                "exports are spec-rate); pass rates=None"
            )
        if shard is not None and shard.device is not None:
            cfg = dataclasses.replace(cfg, device=str(shard.device))
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
        self.shard = shard
        # the local block range (global indices): the whole domain when
        # not sharded
        self._blocks: List[int] = (list(shard.blocks) if shard is not None
                                   else list(range(self.plan.ndiv)))
        # the cache-free one-round template, replayed every round; a
        # shard's carries its boundary fetch and its halo exports
        self._by_block: List[List[Task]] = [[] for _ in self._blocks]
        for t in build_sweep_tasks(cfg, sweeps=1, schedule=self.schedule,
                                   shard=shard):
            self._by_block[t.block - self._blocks[0]].append(t)
        self.cache = (residency if residency is not None
                      else DeviceResidencyManager(cache_bytes, policy=policy))
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
            self.store.seed(
                {"p_prev": p_prev, "p_cur": p_cur, "vel2": vel2},
                keys=self._local_units() if shard is not None else None,
            )
        self.recovery_log: List[Dict[str, object]] = []
        # monotonic clock for flush straggler detection
        self._timer = time.perf_counter
        self._flush_times: List[float] = []
        self.transfers: List[Transfer] = []
        self.sweeps_done = 0
        self.max_inflight = 0  # peak block visits with pending D2H
        # the halo exchange of a sharded run: the left neighbour's held
        # slices for the coming round (each with the event it waits on),
        # the held slices this shard exports and their event, and its
        # encoded left commons (payload, version, the encode's event)
        self._held_in: Dict[str, Tuple[torch.Tensor, object]] = {}
        self._held_out: Dict[str, torch.Tensor] = {}
        self._held_ready = None
        self._halo_out: Dict[UnitKey, Tuple[object, int, object]] = {}
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
        # the overlapped snapshot in flight (begin_checkpoint): its
        # writer and the frozen cut's two queues, pinned dirty residents
        # awaiting their snapshot D2H and host payloads (with their
        # digests) awaiting their shard writes
        self._ckpt_writer: Optional[ckpt.ShardWriter] = None
        self._ckpt_queue: Deque[Tuple[UnitKey, int]] = deque()
        self._ckpt_host_queue: Deque[
            Tuple[str, str, int, object, int, int]] = deque()
        self._ckpt_units_meta: Dict[str, Dict[str, object]] = {}
        self._ckpt_extra: Dict[str, object] = {}
        self._ckpt_chunk = 0
        self._ckpt_host_chunk = 0
        self._ckpt_keep = 3
        self._ckpt_cut_sweep = -1
        self._ckpt_expected_units = 0
        self.last_checkpoint_path: Optional[str] = None
        self.ckpt_stats: Dict[str, object] = {
            "snapshots": 0, "overlapped": 0, "quiesced": 0,
            "boundary_block_s": 0.0, "drain_s": 0.0, "shard_bytes": 0,
            "units_reused": 0, "shard_crc32_s": 0.0, "shard_write_s": 0.0,
        }

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
        # a shard's first block fetches one unit a field more; its halo
        # exports leave at the round's end, when no fetch holds a slot
        fetch = max(sum(t.kind == "h2d" for t in ts) for ts in self._by_block)
        wb = max(sum(t.kind == "d2h" for t in ts) for ts in self._by_block)
        return slot, fetch + self.depth * wb + 1

    # ------------------------------------------------------------------
    # the halo exchange of a sharded run (routed by ShardedExecutor)
    # ------------------------------------------------------------------
    def _local_units(self) -> List[Tuple[str, int]]:
        """The shard's unit footprint: everything its blocks fetch or
        write, plus the left common its first block fetches (the carry a
        single-device run keeps on the device)."""
        keys = set()
        for i in self._blocks:
            keys.update(self.plan.fetch_units(i))
            keys.update(self.plan.writeback_units(i))
        if self._blocks[0] > 0:
            keys.add(("C", self._blocks[0] - 1))
        return sorted(keys)

    def deliver_held(self, name: str, value: torch.Tensor,
                     ready=None) -> None:
        """Accept the left neighbour's held slice (the new-time lower
        half of the boundary common) for the coming round, with the
        event on the neighbour's compute stream after which it is
        written (``take_held`` hands both over). Must land before
        ``sweep()``: its first writeback concatenates it."""
        self._held_in[name] = (value, ready)

    def take_held(self) -> Dict[str, Tuple[torch.Tensor, object]]:
        """Pop the held slices this shard exports after a round, each
        with the event recorded on this engine's compute stream after
        the stencil that wrote it (empty for the last shard)."""
        out = {n: (v, self._held_ready) for n, v in self._held_out.items()}
        self._held_out, self._held_ready = {}, None
        return out

    def _import_held(self, value: torch.Tensor, ready) -> torch.Tensor:
        """A held slice made usable on this engine's compute stream
        (current): the stream waits on the exporter's event, then the
        tensor is marked for it (the caching allocator will not hand
        its memory out while this stream may read it), or copied here
        when it lies on another device."""
        self.lanes.wait("compute", ready)
        if value.device != self.device:
            return value.to(self.device, non_blocking=True)
        if self.lanes.cuda:
            value.record_stream(self.lanes.streams["compute"])
        return value

    def take_halo(self) -> Dict[UnitKey, Tuple[Writeback, int]]:
        """Pop the encoded left commons this shard exports after a round
        as ``{(field, unit): (writeback, version)}`` (empty for the
        first shard): each payload, the same object this shard's parked
        writeback commits, starts its D2H on this engine's d2h stream
        after the encode's event, digested by its host threads as it
        leaves (``deliver_halo`` gives its staging slot back)."""
        out = {key: (self.lanes.writeback(value, ver, after), ver)
               for key, (value, ver, after) in self._halo_out.items()}
        self._halo_out = {}
        return out

    def deliver_halo(self, field: str, kind: str, idx: int, wb: Writeback,
                     version: int) -> int:
        """Land a neighbour's halo put in this shard's ghost: a store
        crossing of op ``"halo"``, verified against the digest taken as
        the bytes left the neighbour's card, retried and wire-logged
        like any crossing. ``wb`` is a ``Writeback`` from ``take_halo``;
        its slot goes back here. Returns the wire bytes."""
        try:
            host, crc = wb.result()
            wire = self.store.put(field, kind, idx, host, version=version,
                                  crc=crc, send=wb.send, op="halo")
        finally:
            wb.release()
        self._ver[(field, (kind, idx))] = version
        return wire

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

        if i == 0:
            first = zeros(h)
        elif shared is not None:
            first = shared
        else:
            # a shard's first block: the left common fetched from its
            # own store, the decode of the unit it committed last round,
            # bit for bit the carry a single-device run keeps
            first = self._dev.pop((name, ("C", i - 1)))
        pieces = [first]
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
                for t, v, c in zip(ts, vals, encoded):
                    kind, idx = t.unit
                    # the round trip's error, from the payload just encoded
                    q = zfp_ops.decompress(c, backend=self.cfg.backend)
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
        ``reissued`` tags the spare-stream second attempt.

        Under tenancy another tenant's deposit may evict this engine's
        entry mid-round of that tenant (``serving.ooc.TenantScheduler``
        routes the handback here): the D2H still waits on this engine's
        compute stream, where the payload was encoded, runs on this
        engine's d2h stream through a slot of its pool, and lands and
        gives the slot back before the call returns, so a burst of such
        flushes needs one slot; the record carries this engine's
        ``sweeps_done``."""
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

    def _capture_halo(self, btasks: List[Task], kr: int) -> None:
        """Keep the left-common export of a shard's first block before
        parking pops the payload: the halo ships the same encoded object
        the writeback commits, at the version the park issues, after
        the encode's event."""
        after = None
        for t in btasks:
            if t.kind == "halo" and ".halo." in t.tid:
                if after is None:
                    after = self.lanes.mark("compute")
                key = (t.field, t.unit)
                self._halo_out[key] = (self._outvals[key],
                                       self._ver.get(key, 0) + kr, after)

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
        rw = [n for n, sp in self.cfg.fields.items() if sp.role == "rw"]
        held: Dict[str, torch.Tensor] = {}
        shared: Dict[str, Optional[torch.Tensor]] = {
            n: None for n in self.cfg.fields
        }
        last = self._blocks[-1]
        with self.lanes.on("compute"):
            if self.shard is not None and not self.shard.first:
                # the left neighbour's held slices seed the boundary
                # writeback's concat as block lo-1's visit would
                lo = self._blocks[0]
                for n in rw:
                    held[n + str(lo - 1)] = self._import_held(
                        *self._held_in.pop(n))
            for j, i in enumerate(self._blocks):
                btasks = self._by_block[j]
                # window admission precedes this visit's first transfer
                self._admit()
                # one chunk of an overlapped snapshot drains here, the
                # cadence the checkpoint-aware task graph replays
                self._drain_ckpt(paced=True)
                for t in (t for t in btasks if t.kind == "h2d"):
                    self._exec_h2d(t)
                self._claim_visit()
                with self.lanes.span("compute"):
                    self._exec_decompress(
                        [t for t in btasks if t.kind == "decompress"]
                    )
                    shared = self._exec_stencil(i, shared, held, kr)
                    if i == last and self.shard is not None:
                        self._held_ready = self.lanes.mark("compute")
                    self._exec_compress(
                        [t for t in btasks if t.kind == "compress"]
                    )
                self._capture_halo(btasks, kr)
                self._park_writebacks(btasks, kr)
        if self.shard is not None and not self.shard.last:
            self._held_out = {n: held[n + str(last)] for n in rw}
        assert not self._dev and not self._staged and not self._outvals
        self.sweeps_done += kr
        if self.rates is not None:
            # the synchronous engine decides at the same boundary, so
            # both record identical decision logs
            self.rates.decide(self.sweeps_done)

    def finish(self) -> None:
        """Drain the window: every issued writeback is committed, on the
        host or (write-back) on the device. Dirty residents stay; call
        ``flush()`` (``gather()`` does) before reading the store. An
        overlapped snapshot in flight is completed first."""
        self._drain_ckpt()
        self._drain_all()

    def flush(self) -> int:
        """Flush-on-demand: commit every dirty resident to the host
        store, oldest (LRU) first. Entries stay resident, clean. Returns
        the number of units flushed.

        Without ``reissue`` a failed put raises and leaves its entry
        dirty, so a retry flushes exactly the remainder. With it, a
        failed put is re-put once (``CacheStats.flush_reissues``) and a
        put slower than ``reissue.deadline`` of the median is counted in
        ``CacheStats.flush_stragglers``. An overlapped snapshot in
        flight is completed (its pins released) first."""
        self._drain_ckpt()
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

    def run(
        self,
        total_steps: int,
        ckpt_policy: Optional[CheckpointPolicy] = None,
        recovery: Optional[RecoveryPolicy] = None,
    ) -> None:
        """Advance the run by ``total_steps`` (a multiple of ``bt``) and
        drain the window.

        With ``ckpt_policy`` every sweep boundary where the policy is
        due takes a snapshot (overlapped or quiesced); the final
        ``finish()`` publishes one still draining. With ``recovery`` an
        unrecoverable fault rolls the engine back to the last good
        checkpoint under ``recovery.directory`` and replays, at most
        ``recovery.max_restarts`` times; a baseline snapshot is taken
        first when there is none. Replay is deterministic: the result is
        bit for bit that of a run without faults."""
        if total_steps % self.cfg.bt:
            raise ValueError(
                f"total_steps={total_steps} is not a multiple of "
                f"bt={self.cfg.bt}"
            )
        target = self.sweeps_done + total_steps // self.cfg.bt
        restarts = 0
        while True:
            try:
                if recovery is not None and ckpt.latest(
                    recovery.directory
                ) is None:
                    # a rollback needs a last good state to roll back to
                    self.checkpoint(recovery.directory,
                                    zstd_level=recovery.zstd_level,
                                    keep=recovery.keep)
                self._run_to(target, ckpt_policy)
                return
            except FaultError as e:
                if (
                    recovery is None
                    or restarts >= recovery.max_restarts
                    or ckpt.latest(recovery.directory) is None
                ):
                    raise
                restarts += 1
                self._rollback(recovery.directory, e)

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

    def _run_to(self, target: int,
                ckpt_policy: Optional[CheckpointPolicy] = None) -> None:
        """Advance to ``target`` completed sweeps, consulting
        ``ckpt_policy`` at every boundary (the seconds the boundary
        blocks add to ``ckpt_stats["boundary_block_s"]``), then drain."""
        last_ckpt = self._timer()
        while self.sweeps_done < target:
            self.advance_round(target)
            if ckpt_policy is not None and ckpt_policy.due(
                self.sweeps_done, self._timer() - last_ckpt
            ):
                t0 = self._timer()
                cut = (self.checkpoint if ckpt_policy.mode == "quiesced"
                       else self.begin_checkpoint)
                cut(ckpt_policy.directory, zstd_level=ckpt_policy.zstd_level,
                    keep=ckpt_policy.keep)
                self.ckpt_stats["boundary_block_s"] += self._timer() - t0
                last_ckpt = self._timer()
        self.finish()

    # ------------------------------------------------------------------
    # rollback and replay
    # ------------------------------------------------------------------
    def _release_inflight(self) -> None:
        """Give back every staging slot a lost crossing holds: parked
        writebacks and fetches not yet claimed, each once its host job
        is done with the slot, so a replay finds the pool whole and no
        late job writes into a reused slot."""
        for _, parked in self._pending:
            for *_, wb in parked:
                if wb is not None:
                    wb.release()
        for units in (self._staged, self._dev):
            for value in units.values():
                if isinstance(value, _Incoming):
                    value.fetch.abandon()

    def _rollback(self, directory: str, cause: Exception) -> None:
        """Reset to the last good checkpoint under ``directory``: drop
        what a crash would lose (the window, staged and computed units,
        residency, a half-written overlapped snapshot, whose tmp dir is
        aborted), then reload the newest checkpoint that verifies."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.abort()
            self._ckpt_writer = None
        self._ckpt_queue.clear()
        self._ckpt_host_queue.clear()
        self._ckpt_units_meta = {}
        self._release_inflight()
        self._pending.clear()
        self._dev.clear()
        self._staged.clear()
        self._outvals.clear()
        self._outraw.clear()
        self._flush_times.clear()
        # cold residency, the same cumulative stats
        self.cache = self.cache.rollback_reset()
        stats = self.cache.stats
        self.store.stats = stats
        _, leaves, extra, path = self._load_last_good(directory,
                                                      self.device)
        self.store.load_state(leaves, extra["store"])
        prior = self.sweeps_done
        self.sweeps_done = int(extra["progress"]["sweeps_done"])
        self._ver = _version_vector(extra)
        stats.recoveries += 1
        stats.replayed_sweeps += max(0, prior - self.sweeps_done)
        self.recovery_log.append({
            "fault": f"{type(cause).__name__}: {cause}",
            "from_sweep": prior,
            "resumed_at": self.sweeps_done,
            "checkpoint": path,
        })

    @staticmethod
    def _load_last_good(directory: str, device=None):
        """``(step, leaves, extra, path)`` of the newest checkpoint under
        ``directory`` that passes manifest, shard and unit-digest
        checks; corrupt ones are skipped, newest first."""
        base = pathlib.Path(directory)
        candidates = sorted(
            (p for p in base.iterdir() if p.name.startswith("step_")),
            reverse=True,
        ) if base.exists() else []
        last: Optional[Exception] = None
        for p in candidates:
            try:
                step, leaves, extra = ckpt.load(str(p), device)
                return step, leaves, extra, str(p)
            except FaultError as e:  # corrupt: try the previous cut
                last = e
        raise UnrecoverableFault(
            f"no loadable checkpoint under {directory!r} to roll "
            f"back to: {last}"
        ) from last

    # ------------------------------------------------------------------
    # the overlapped checkpoint cut
    # ------------------------------------------------------------------
    def _progress_extra(self) -> Dict[str, object]:
        """Manifest ``extra`` shared by both cuts: config and progress
        (each cut appends the store's unit table)."""
        return {
            "format": CKPT_FORMAT,
            "kind": "ooc-executor",
            "cfg": self.cfg.to_dict(),
            "progress": {
                "sweeps_done": self.sweeps_done,
                "schedule": self.schedule.name,
                # a custom Schedule restores from its fields
                "schedule_spec": {
                    "name": self.schedule.name,
                    "codec_sync": self.schedule.codec_sync,
                    "window": self.schedule.window,
                    "temporal": self.schedule.temporal,
                },
                "depth": self.depth,
                "cache_bytes": self.cache.budget_bytes,
                "policy": self.cache.policy,
                # the sharded layout (None unsharded); device pins are
                # process state and never persist
                "shard": (self.shard.to_dict() if self.shard is not None
                          else None),
            },
            # the rate controller's whole state, so a resumed run
            # re-decides what this one would have
            **({"rates": self.rates.state_dict()}
               if self.rates is not None else {}),
        }

    def _early_commit_parked(self) -> None:
        """Commit to the host every parked writeback with no dirty
        residency (a refused deposit, or write-through), without
        draining the window: its ordinary D2H, only earlier, so the
        snapshot can read the host bytes. Its slot goes back to the
        pool; dirty-resident writebacks stay parked (the cut pins
        them)."""
        for i, (sweep_no, parked) in enumerate(self._pending):
            kept = []
            done = []
            try:
                for item in parked:
                    task, value, raw, ver, wb = item
                    kind, idx = task.unit
                    key = (task.field, task.unit)
                    if self.store.version_of(task.field, kind, idx) >= ver:
                        done.append(wb)
                        continue  # an eviction flush committed it
                    if self.cache.enabled and self.cache.write_back:
                        ent = self.cache.peek(key)
                        if (ent is not None and ent.dirty
                                and ent.version >= ver):
                            kept.append(item)
                            continue  # the cut pins the dirty resident
                    if wb is None:
                        wb = self.lanes.writeback(
                            value, ver, self.lanes.mark("compute"))
                    done.append(wb)
                    host, crc = wb.result()
                    wire = self.store.put(task.field, kind, idx, host,
                                          version=ver, crc=crc,
                                          send=wb.send)
                    self.transfers.append(Transfer(
                        "d2h", task.field, task.unit, raw, wire,
                        sweep_no, task.block,
                    ))
            finally:
                for wb in done:
                    if wb is not None:
                        wb.release()
            self._pending[i] = (sweep_no, kept)

    def begin_checkpoint(
        self,
        directory: str,
        *,
        zstd_level: Optional[int] = None,
        keep: int = 3,
    ) -> None:
        """The overlapped checkpoint cut: snapshot the run at this sweep
        boundary without draining the window.

        Every unit is classified at the frozen version vector: a unit
        whose committed payload is on the host has that payload and its
        digest captured (puts replace, never mutate); a dirty resident
        is pinned copy-on-write (a newer writeback shadows the pre-cut
        payload, eviction skips it) and queued for its snapshot D2H;
        parked writebacks with no residency commit now. The boundary
        itself moves no bytes and writes no file; the queues drain a
        chunk a block visit of the next sweep through the incremental
        ``ShardWriter``, which publishes when the last shard lands.
        ``finish``/``flush``/``gather``/``checkpoint`` and the next cut
        complete a snapshot in flight first. The snapshot restores as
        one from ``checkpoint`` at the same boundary does."""
        self._drain_ckpt()  # at most one snapshot in flight
        self._early_commit_parked()
        self._ckpt_extra = self._progress_extra()
        self._ckpt_writer = ckpt.ShardWriter(
            directory, self.sweeps_done,
            zstd_level=zstd_level, extra=self._ckpt_extra,
            injector=self.injector, retry=self.retry,
            stats=self.cache.stats,
        )
        self._ckpt_keep = keep
        self._ckpt_cut_sweep = self.sweeps_done - 1
        self._ckpt_units_meta = {}
        unit_keys = self.store.unit_keys()
        self._ckpt_expected_units = len(unit_keys)
        for (field, kind, idx) in unit_keys:
            key: UnitKey = (field, (kind, idx))
            ver = self._ver.get(key, self.store.version_of(field, kind, idx))
            if self.store.host_version_of(field, kind, idx) >= ver:
                self._ckpt_host_queue.append((
                    field, kind, idx,
                    self.store.host_payload(field, kind, idx, ver), ver,
                    self.store.checksum_of(field, kind, idx),
                ))
            # else: committed ahead of the host means dirty-resident,
            # pinned below in LRU order (the task graph's order)
        for key, ent in self.cache.dirty_entries():
            field, (kind, idx) = key
            ver = self._ver.get(key, 0)
            assert (
                ent.version == ver
                and self.store.host_version_of(field, kind, idx) < ver
            ), ("overlapped cut: dirty resident out of step", key, ver)
            self.cache.pin(key)
            self._ckpt_queue.append((key, ver))
        assert (
            len(self._ckpt_queue) + len(self._ckpt_host_queue)
            == self._ckpt_expected_units
        ), "overlapped cut must cover every unit exactly once"
        ndiv = self.plan.ndiv
        self._ckpt_chunk = -(-len(self._ckpt_queue) // ndiv)
        self._ckpt_host_chunk = -(-len(self._ckpt_host_queue) // ndiv)

    def _snapshot_d2h(self, value, ver: int):
        """``(host, crc)`` of a pinned device payload: its D2H on the
        d2h stream, after the compute so far, through one staging slot
        that goes back to the pool before the shard is written (a
        paced chunk never needs more than the pool's spare slot). The
        host copy is held to the digest of the bytes as they left the
        device."""
        wb = self.lanes.writeback(value, ver, self.lanes.mark("compute"))
        try:
            host, crc = wb.result()
            _, digest = wb.send()
        finally:
            wb.release()
        if digest != crc:
            raise ChecksumError(
                f"snapshot D2H checksum mismatch: expected {crc:#010x}, "
                f"got {digest:#010x}"
            )
        return host, crc

    def _drain_ckpt(self, paced: bool = False) -> None:
        """Advance the snapshot in flight: the snapshot D2H and shards
        of pinned units, then the shards of host-current ones. ``paced``
        does one chunk of each queue (a block visit's share); otherwise
        everything drains and the snapshot publishes."""
        if self._ckpt_writer is None:
            return
        t0 = self._timer()
        n_flush = self._ckpt_chunk if paced else len(self._ckpt_queue)
        for _ in range(min(n_flush, len(self._ckpt_queue))):
            key, ver = self._ckpt_queue.popleft()
            ent = self.cache.pinned_entry(key)
            assert ent is not None and ent.version == ver, (key, ver)
            field, (kind, idx) = key
            host, crc = self._snapshot_d2h(ent.value, ver)
            self._write_unit_shards(field, kind, idx, host, ver, crc)
            raw, wire = unit_bytes(ent.value)
            # releasing the pin re-enforces the budget: dirty victims of
            # the pin pressure flush to the host here
            for ekey, eent in self.cache.release(key):
                self._flush_entry(ekey, eent, -1)
            self.cache.note_ckpt_flush(wire)
            self.transfers.append(Transfer(
                "d2h", field, (kind, idx), raw, wire,
                self._ckpt_cut_sweep, -1, ckpt=True,
            ))
        n_host = (self._ckpt_host_chunk if paced
                  else len(self._ckpt_host_queue))
        for _ in range(min(n_host, len(self._ckpt_host_queue))):
            self._write_unit_shards(*self._ckpt_host_queue.popleft())
        self.ckpt_stats["drain_s"] += self._timer() - t0
        if not self._ckpt_queue and not self._ckpt_host_queue:
            self._finalize_ckpt()

    def _write_unit_shards(self, field: str, kind: str, idx: int, value,
                           ver: int, crc: int) -> None:
        """One unit into the snapshot in flight: its shards and its
        entry in the unit table (``crc``, its ``unit_checksum``, is
        known already)."""
        leaves, meta = unit_shards(field, kind, idx, value, ver, crc=crc)
        for lkey, arr in leaves.items():
            self.ckpt_stats["shard_bytes"] += self._ckpt_writer.add(lkey, arr)
        self._ckpt_units_meta[f"{field}.{kind}{idx}"] = meta

    def _count_writer(self, w: ckpt.ShardWriter) -> None:
        self.ckpt_stats["shard_crc32_s"] += w.crc_s
        self.ckpt_stats["shard_write_s"] += w.write_s

    def _finalize_ckpt(self) -> None:
        """Publish the overlapped snapshot (atomic rename, gc), refusing
        one that does not cover every unit of the cut."""
        assert len(self._ckpt_units_meta) == self._ckpt_expected_units, (
            "incomplete overlapped snapshot: refusing to publish",
            len(self._ckpt_units_meta), self._ckpt_expected_units,
        )
        extra = dict(self._ckpt_extra)
        extra["store"] = {"units": self._ckpt_units_meta}
        self._ckpt_writer.set_extra(extra)
        self.last_checkpoint_path = self._ckpt_writer.finalize(
            keep=self._ckpt_keep)
        self._count_writer(self._ckpt_writer)
        self._ckpt_writer = None
        self._ckpt_units_meta = {}
        self.ckpt_stats["snapshots"] += 1
        self.ckpt_stats["overlapped"] += 1

    # ------------------------------------------------------------------
    # the quiesced checkpoint and restore
    # ------------------------------------------------------------------
    def checkpoint(
        self,
        directory: str,
        *,
        zstd_level: Optional[int] = None,
        lossy_planes: Optional[int] = None,
        keep: int = 3,
        incremental: bool = False,
    ) -> str:
        """Snapshot the run in one call: drain the window (``finish``),
        flush every dirty resident in LRU order (``flush``, with the
        ``reissue`` second attempt), then persist the store's payloads,
        the version vector and the progress record atomically as
        ``<directory>/step_<sweeps_done>``. ``lossy_planes`` codes the
        float32 leaves with the ZFP kernels at ndim 1 on the engine's
        device. ``incremental=True`` points units whose version did not
        move since the previous cut in ``directory`` at that cut's
        shards (``ckpt_stats["units_reused"]``). Returns the path."""
        self.finish()
        self.flush()
        leaves, store_meta = self.store.state_dict()
        extra = self._progress_extra()
        extra["store"] = store_meta
        prev_leaves: Dict[str, Dict[str, object]] = {}
        prev_units: Dict[str, Dict[str, object]] = {}
        prev_dir = None
        if incremental:
            found = ckpt.latest(directory)
            if found is not None:
                try:
                    prev = ckpt.read_manifest(found)
                except Exception:
                    prev = None  # unreadable previous cut: full snapshot
                if prev is not None:
                    prev_dir = pathlib.Path(found).name
                    prev_leaves = prev.get("leaves", {})
                    prev_units = (prev.get("extra", {}).get("store", {})
                                  .get("units", {}))
        unchanged = {
            ukey for ukey, u in store_meta["units"].items()
            if ukey in prev_units
            and int(prev_units[ukey]["version"]) == int(u["version"])
        }
        w = ckpt.ShardWriter(
            directory, self.sweeps_done, zstd_level=zstd_level,
            lossy_planes=lossy_planes, extra=extra,
            injector=self.injector, retry=self.retry,
            stats=self.cache.stats, device=self.device,
        )
        reused = 0
        try:
            for key, leaf in leaves.items():
                ukey = key
                for suf in (".payload", ".emax"):
                    if key.endswith(suf):
                        ukey = key[: -len(suf)]
                ent = prev_leaves.get(key)
                if ukey in unchanged and ent is not None:
                    w.add_external(key, ent, prev_dir)
                    reused += 1
                else:
                    self.ckpt_stats["shard_bytes"] += w.add(key, leaf)
        except BaseException:
            w.abort()
            raise
        path = w.finalize(keep=keep)
        self._count_writer(w)
        self.last_checkpoint_path = path
        self.ckpt_stats["snapshots"] += 1
        self.ckpt_stats["quiesced"] += 1
        self.ckpt_stats["units_reused"] += reused
        return path

    @classmethod
    def restore(
        cls,
        directory: str,
        *,
        schedule: Union[str, Schedule, None] = None,
        cache_bytes: Optional[int] = None,
        policy: Optional[str] = None,
        reissue: Optional[ReissuePolicy] = None,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        device=None,
        backend: Optional[str] = None,
    ) -> "AsyncExecutor":
        """Rebuild a live engine from a checkpoint of this package's or
        of the reference's engine.

        ``directory`` is a checkpoint root (its latest ``step_<k>``) or
        one checkpoint. The store, the version vector and the sweep
        cursor come back exactly; residency restarts cold, so the
        resumed run moves other transfers but not one other bit.
        ``schedule``/``cache_bytes``/``policy`` default to the recorded
        ones. The engine runs on ``device`` (default the CUDA device;
        ``device="cpu"`` by name) with ``backend``, by default the
        recorded one, the reference's ``"pallas"`` read as ``"cuda"``:
        a recorded ``"ref"`` stays ``"ref"``, and a ``"cuda"`` engine
        needs a CUDA device."""
        path = pathlib.Path(directory)
        if not (path / "manifest.json").exists():
            found = ckpt.latest(directory)
            if found is None:
                raise FileNotFoundError(f"no checkpoint under {directory!r}")
            path = pathlib.Path(found)
        manifest = ckpt.read_manifest(str(path))
        extra = manifest.get("extra", {})
        if extra.get("kind") != "ooc-executor":
            raise ValueError(
                f"{path} is not an AsyncExecutor checkpoint "
                f"(kind={extra.get('kind')!r})"
            )
        prog = extra["progress"]
        shard_d = prog.get("shard")
        cfg_d = dict(extra["cfg"], device=device)
        if backend is not None:
            cfg_d["backend"] = backend
        cfg = OOCConfig.from_dict(cfg_d)
        engine_device(cfg)  # no device, or the wrong one: raise now
        _, leaves, extra = ckpt.load(str(path), device)
        if schedule is None:
            try:
                schedule = get_schedule(prog["schedule"])
            except ValueError:
                spec = prog["schedule_spec"]
                schedule = Schedule(
                    spec["name"], codec_sync=spec["codec_sync"],
                    window=spec["window"],
                    temporal=spec.get("temporal", 1),
                )
        rates = (RateController.from_state(cfg, extra["rates"])
                 if "rates" in extra else None)
        ex = cls(
            cfg, schedule=schedule,
            cache_bytes=(prog["cache_bytes"] if cache_bytes is None
                         else cache_bytes),
            policy=prog["policy"] if policy is None else policy,
            reissue=reissue, retry=retry, injector=injector, rates=rates,
            shard=(ShardSpec.from_dict(shard_d, device=device)
                   if shard_d else None),
        )
        ex.store.load_state(leaves, extra["store"])
        ex.sweeps_done = int(prog["sweeps_done"])
        # newest issued version == committed at the cut
        ex._ver = _version_vector(extra)
        return ex

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
            "checkpoint": dict(self.ckpt_stats),
            "ckpt_pending_units": (len(self._ckpt_queue)
                                   + len(self._ckpt_host_queue)),
            "wire": dict(self.store.wire_stats),
            "wire_backoff_s": self.store.backoff_s,
            "injected": (
                dict(self.injector.counts)
                if self.injector is not None else {}
            ),
            "recoveries": list(self.recovery_log),
            "lanes": {
                "streams": len({s.cuda_stream for s in
                                self.lanes.streams.values()
                                if s is not None}),
                "pinned_bytes": self.lanes.pinned_bytes,
                "host_job_s": self.lanes.job_s,
                "host_wait_s": self.lanes.wait_s,
                "crc_wait_s": self.lanes.crc_wait_s,
                "host_jobs": self.lanes.jobs,
                "free_slots": self.lanes.free_slots,
            },
        }

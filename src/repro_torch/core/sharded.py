"""The sharded out-of-core engine: one live engine per domain shard,
with a compressed halo exchange between them.

Port of ``repro.core.sharded``. ``ShardedExecutor`` partitions the
Z-block decomposition (``distributed.sharding.partition_domain``) and
runs one whole ``AsyncExecutor``, with its own residency manager, host
store, streams, pinned pool and host threads, per shard, each on its
pinned ``torch.device`` (or on the config's device). The problem size is
then bounded by host memory times the device count rather than one
device's memory.

A round (``kr`` fused sweeps) runs the shards in ascending order:

1. shard *d* receives the held slices of shard *d-1*, the new-time lower
   halves of the boundary common computed in this same round, with the
   event on *d-1*'s compute stream after which they are written
   (``deliver_held``); then it runs its sweep with its own in-flight
   window, which stays open across sweep and shard boundaries (no
   coordinator barrier drains it);
2. at the round's end each shard's committed left common ships right to
   left as a unit halo: the encoded payload leaves the exporter's card on
   its d2h stream after the encode's event, digested as it leaves
   (``take_halo``), and lands in the left neighbour's ghost through its
   host store as a crossing of op ``"halo"``: verified, versioned
   ``+kr``, retried under the same policies as every other crossing
   (``deliver_halo``).

Both flows are recorded as ``Transfer("halo", ...)`` on the exporting
shard, so each shard's transfer log compares one to one with its task
graph (``build_sweep_tasks(shard=...)``) and the merged replay
(``build_sharded_tasks``, ``pipeline.sharded_timeline``).

The numerics are bit for bit those of the single-device engine: the
ghost fetch decodes the exact unit the neighbour committed, the held
import is the exact slice a single-device run carries on the device,
and every kernel sees the same values in the same order.

Checkpoints are per shard with a consistent global cut: ``checkpoint``
is legal only at a round boundary (held inboxes empty, every shard at
the same sweep cursor), where the shards' stores hold the whole state;
``restore`` rebuilds every shard and resumes bit for bit.

A ``distributed.fault.HeartbeatMonitor`` watches the shards: each beats
once a round; slow or silent shards surface in ``stats()["heartbeat"]``
and add straggler rows to ``recovery_log``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.executor import AsyncExecutor
from repro_torch.core.outofcore import OOCConfig, device_value, to_host, \
    unit_bytes
from repro_torch.core.taskgraph import (
    Schedule,
    Transfer,
    get_schedule,
    summarize_transfers,
)
from repro_torch.distributed.fault import (
    FaultInjector,
    HeartbeatMonitor,
    ReissuePolicy,
    RetryPolicy,
)
from repro_torch.distributed.sharding import ShardSpec, partition_domain, \
    pins
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp.ref import Compressed


class ShardedExecutor:
    """Round coordinator over one ``AsyncExecutor`` a domain shard."""

    def __init__(
        self,
        cfg: OOCConfig,
        p_prev: Optional[np.ndarray] = None,
        p_cur: Optional[np.ndarray] = None,
        vel2: Optional[np.ndarray] = None,
        *,
        nshards: int = 2,
        schedule: Union[str, Schedule] = "depth2",
        cache_bytes: int = 0,
        policy: str = "write-back",
        devices: Optional[Sequence] = None,
        monitor: Optional[HeartbeatMonitor] = None,
        reissue: Optional[ReissuePolicy] = None,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
    ):
        """Partition ``cfg`` over ``nshards`` and build the shards'
        engines, each seeded with its own units of the full fields
        (each unit is encoded alone, so a shard holds the bytes a full
        seed would).

        ``devices`` pins the shards round-robin onto those
        ``torch.device``s; without it every shard runs on
        ``cfg.device`` (the CUDA device unless the config asks for the
        CPU): the same graphs, transfers and results. ``cache_bytes`` is
        each shard's residency budget. ``monitor`` defaults to a new
        ``HeartbeatMonitor(nshards)``.
        """
        self.cfg = cfg
        self.schedule = get_schedule(schedule)
        self.temporal = self.schedule.temporal
        self.plan = cfg.temporal_plan(self.temporal)
        self.specs: List[ShardSpec] = partition_domain(
            cfg.ndiv, nshards, devices=devices)
        self.shards: List[AsyncExecutor] = []
        try:
            for spec in self.specs:
                with self._on(spec.device):
                    self.shards.append(AsyncExecutor(
                        cfg, p_prev, p_cur, vel2,
                        schedule=self.schedule, cache_bytes=cache_bytes,
                        policy=policy, reissue=reissue, retry=retry,
                        injector=injector, shard=spec,
                    ))
        except BaseException:
            self.close()
            raise
        self.monitor = (monitor if monitor is not None
                        else HeartbeatMonitor(nshards))
        # swappable clock (tests drive the heartbeat with a fake one)
        self._timer = time.perf_counter
        self.recovery_log: List[Dict[str, object]] = []
        self.rounds_done = 0
        self.sweeps_done = 0

    @property
    def nshards(self) -> int:
        return len(self.specs)

    @staticmethod
    def _on(device):
        """``device`` made current when it is a CUDA device pin (nothing
        otherwise)."""
        if device is not None and torch.device(device).type == "cuda":
            return torch.cuda.device(torch.device(device))
        return contextlib.nullcontext()

    def _log_halo(self, exporter: AsyncExecutor, field: str,
                  unit: Tuple[str, int], raw: int, wire: int, sweep: int,
                  block: int) -> None:
        """Record one inter-shard crossing on the exporter, the side
        whose task graph carries the halo task."""
        exporter.transfers.append(Transfer(
            "halo", field, unit, raw, wire, sweep, block,
        ))
        exporter.cache.stats.halo_count += 1
        exporter.cache.stats.halo_wire_bytes += wire

    # ------------------------------------------------------------------
    # the round loop
    # ------------------------------------------------------------------
    def sweep(self, sweeps: Optional[int] = None) -> None:
        """One round over every shard: ``kr`` fused sweeps a shard (the
        schedule's temporal ``k`` by default), the held slices flowing
        left to right within the round and the encoded boundary commons
        right to left at its end. Each shard's window stays open across
        rounds; nothing drains it here."""
        kr = self.temporal if sweeps is None else sweeps
        s0 = self.sweeps_done
        held: Dict[str, Tuple[torch.Tensor, object]] = {}
        for d, ex in enumerate(self.shards):
            spec = self.specs[d]
            for name, (val, ready) in held.items():
                ex.deliver_held(name, val, ready)
            with self._on(spec.device):
                ex.sweep(kr)
            self.monitor.beat(d, self.rounds_done, self._timer())
            held = ex.take_held()
            for name, (val, _) in held.items():
                nb = val.numel() * val.element_size()
                self._log_halo(ex, name, ("C", spec.block_hi - 1), nb, nb,
                               s0, spec.block_hi - 1)
        for d in range(1, self.nshards):
            ex, spec = self.shards[d], self.specs[d]
            with self._on(spec.device):
                halos = ex.take_halo()
            for (field, unit), (wb, ver) in halos.items():
                with self._on(self.specs[d - 1].device):
                    wire = self.shards[d - 1].deliver_halo(
                        field, unit[0], unit[1], wb, ver)
                self._log_halo(ex, field, unit, unit_bytes(wb.value)[0],
                               wire, s0, spec.block_lo)
        stragglers = self.monitor.stragglers(self._timer())
        if stragglers:
            self.recovery_log.append({
                "kind": "straggler", "round": self.rounds_done,
                "shards": stragglers,
            })
        self.rounds_done += 1
        self.sweeps_done += kr

    def run_sweeps(self, n: int) -> None:
        """Advance ``n`` sweeps in rounds of the schedule's temporal
        ``k`` (the last one truncated, as ``AsyncExecutor.run``)."""
        done = 0
        while done < n:
            kr = min(self.temporal, n - done)
            self.sweep(kr)
            done += kr

    def finish(self) -> None:
        for spec, ex in zip(self.specs, self.shards):
            with self._on(spec.device):
                ex.finish()

    def flush(self) -> int:
        n = 0
        for spec, ex in zip(self.specs, self.shards):
            with self._on(spec.device):
                n += ex.flush()
        return n

    def close(self) -> None:
        """Stop every shard's host threads."""
        for ex in self.shards:
            ex.close()

    # ------------------------------------------------------------------
    # host-side views
    # ------------------------------------------------------------------
    def gather(self, name: str) -> np.ndarray:
        """Reassemble a full field from each unit's owner shard (the one
        whose writeback committed it; ghosts are never read), decoding
        compressed units on that shard's device."""
        self.finish()
        self.flush()
        out = np.zeros(self.cfg.shape, dtype=np.dtype(self.cfg.dtype))
        for spec, ex in zip(self.specs, self.shards):
            units = spec.owned_units()
            vals = [ex.store.get(name, kind, idx) for kind, idx in units]
            comp = [(u, v) for u, v in zip(units, vals)
                    if isinstance(v, Compressed)]
            dec = {}
            if comp:
                with self._on(spec.device):
                    # a read of the store, not a crossing of the wire
                    decoded = zfp_ops.decompress_units(
                        [device_value(v, ex.device) for _, v in comp],
                        backend=ex.cfg.backend)
                    dec = {u: to_host(a)
                           for (u, _), a in zip(comp, decoded)}
            for (kind, idx), val in zip(units, vals):
                lo, hi = (self.plan.remainder(idx) if kind == "R"
                          else self.plan.common(idx))
                out[lo:hi] = dec.get((kind, idx), val)
        return out

    @property
    def transfers(self) -> List[Transfer]:
        """Every shard's transfer log, shard-major (a halo crossing
        appears once, on its exporter)."""
        out: List[Transfer] = []
        for ex in self.shards:
            out.extend(ex.transfers)
        return out

    def transfer_summary(self) -> Dict[str, object]:
        """The totals, and by shard (``per_device``) the same summary a
        single engine gives, halo traffic apart from h2d and d2h."""
        out: Dict[str, object] = summarize_transfers(self.transfers)
        out["per_device"] = {
            spec.index: summarize_transfers(ex.transfers)
            for spec, ex in zip(self.specs, self.shards)
        }
        return out

    def stats(self) -> Dict[str, object]:
        now = self._timer()
        return {
            "nshards": self.nshards,
            "sweeps": self.sweeps_done,
            "rounds": self.rounds_done,
            "per_device": {
                spec.index: ex.stats()
                for spec, ex in zip(self.specs, self.shards)
            },
            "heartbeat": {
                "stragglers": self.monitor.stragglers(now),
                "dead": self.monitor.dead(now),
                "median_round_time_s": self.monitor.median_step_time(),
                "straggler_rounds": sum(
                    1 for r in self.recovery_log
                    if r.get("kind") == "straggler"
                ),
            },
            "recoveries": list(self.recovery_log),
        }

    # ------------------------------------------------------------------
    # per-shard checkpoints with a consistent global cut
    # ------------------------------------------------------------------
    def checkpoint(
        self,
        directory: str,
        *,
        zstd_level: Optional[int] = None,
        lossy_planes: Optional[int] = None,
        keep: int = 3,
        incremental: bool = True,
    ) -> List[str]:
        """Snapshot every shard under ``<directory>/shard<dd>/``.

        Legal only at a round boundary, the only place ``sweep()``
        returns: every shard at the same sweep cursor, every held inbox
        empty, each ghost holding the version its neighbour committed
        this round. The shards' stores (owned units) are then the whole
        state. ``incremental=True`` (the default) persists only units
        whose version moved since each shard's previous cut. Returns the
        paths."""
        if any(ex._held_in for ex in self.shards):
            raise RuntimeError("checkpoint mid-round: a held import is "
                               "pending")
        if len({ex.sweeps_done for ex in self.shards}) != 1:
            raise RuntimeError("inconsistent cut: shards at different "
                               "sweep cursors")
        paths = []
        for spec, ex in zip(self.specs, self.shards):
            with self._on(spec.device):
                paths.append(ex.checkpoint(
                    os.path.join(directory, f"shard{spec.index:02d}"),
                    zstd_level=zstd_level, lossy_planes=lossy_planes,
                    keep=keep, incremental=incremental,
                ))
        return paths

    @classmethod
    def restore(
        cls,
        directory: str,
        *,
        schedule: Union[str, Schedule, None] = None,
        cache_bytes: Optional[int] = None,
        policy: Optional[str] = None,
        devices: Optional[Sequence] = None,
        device=None,
        monitor: Optional[HeartbeatMonitor] = None,
        reissue: Optional[ReissuePolicy] = None,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
    ) -> "ShardedExecutor":
        """Rebuild every shard from ``<directory>/shard<dd>/`` and resume
        bit for bit. The layout comes from the manifests; device pins
        are process state: ``devices`` pins the shards round-robin, else
        each runs on ``device`` (default the CUDA device; ``"cpu"`` by
        name), with the recorded backend."""
        root = pathlib.Path(directory)
        subdirs = sorted(p for p in root.iterdir()
                         if p.is_dir() and p.name.startswith("shard"))
        if not subdirs:
            raise FileNotFoundError(
                f"no shard checkpoints under {directory!r}")
        shards = []
        try:
            for p, pin in zip(subdirs, pins(devices, len(subdirs))):
                with cls._on(pin):
                    shards.append(AsyncExecutor.restore(
                        str(p), schedule=schedule, cache_bytes=cache_bytes,
                        policy=policy, reissue=reissue, retry=retry,
                        injector=injector,
                        device=pin if pin is not None else device,
                    ))
            specs = [ex.shard for ex in shards]
            if any(s is None for s in specs):
                raise ValueError("restore of an unsharded checkpoint "
                                 "through ShardedExecutor")
            if [s.index for s in specs] != list(range(len(specs))):
                raise ValueError("shard checkpoints out of order or "
                                 "missing")
        except BaseException:
            for ex in shards:
                ex.close()
            raise
        self = cls.__new__(cls)
        self.cfg = shards[0].cfg
        self.schedule = shards[0].schedule
        self.temporal = self.schedule.temporal
        self.plan = self.cfg.temporal_plan(self.temporal)
        self.specs = specs
        self.shards = shards
        self.monitor = (monitor if monitor is not None
                        else HeartbeatMonitor(len(shards)))
        self._timer = time.perf_counter
        self.recovery_log = []
        self.sweeps_done = shards[0].sweeps_done
        # every cut lands on a round boundary; rounds resume counting
        # from the sweep cursor (exact for whole rounds; otherwise only
        # the heartbeat's labels)
        self.rounds_done = -(-self.sweeps_done // self.temporal)
        return self

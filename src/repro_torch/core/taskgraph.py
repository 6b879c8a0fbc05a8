"""Task graph of the out-of-core sweep, shared by the live engine and
its model.

Port of ``repro.core.taskgraph``. A sweep is a graph of
fetch/decompress/stencil/compress/writeback ``Task`` objects on three
resources (``h2d``; ``compute`` for decompress, stencil and compress;
``d2h``), built by ``build_sweep_tasks`` under a pluggable ``Schedule``:

* ``paper``: block-granularity issue, codec calls marked ``sync``;
* ``unitgrain`` (alias ``overlap``): units ship as each is encoded;
* ``depth-k``: unitgrain with at most ``k`` block visits in flight,
  the window ``executor.AsyncExecutor`` enforces;
* ``temporal-k``: ``k`` sweeps fused per block visit against a halo
  widened to ``radius * bt * k`` planes.

Multi-sweep graphs have no sweep barrier: each unit carries a version
counter bumped by every writeback, and a fetch depends on the d2h that
committed its current version (the fetch-after-writeback hazard).
``cache_bytes`` replays the residency manager (``unitcache``): resident
fetches emit no h2d task, and under ``policy="write-back"`` a stored
dirty deposit emits no d2h task, with flush tasks where dirty entries
lose residency. ``rates=`` replays a ``RateController``'s decisions at
exact payload sizes. The live executor's transfer log equals the
graph's h2d and d2h tasks.

``build_sweep_tasks(shard=...)`` restricts the graph to one shard of a
multi-device decomposition (``distributed.sharding.ShardSpec``) and adds
its halo-exchange tasks; ``build_sharded_tasks`` merges every shard's
graph with the cross-shard hazard edges. ``build_tenant_tasks`` merges
N tenants' runs in ``core.tenancy.interleave_rounds`` order over one
arbiter-managed residency budget, each task labelled with its tenant.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.ratecontrol import rate_label
from repro_torch.core.unitcache import UnitCache
from repro_torch.kernels.zfp import ref as zfp_ref


@dataclass
class Transfer:
    """One realized host<->device transfer (the engines' audit log)."""

    direction: str  # "h2d" | "d2h" | "halo"
    field: str
    unit: Tuple[str, int]
    raw_bytes: int
    wire_bytes: int
    sweep: int
    block: int
    # write-back residency flush (evict/gather/checkpoint) rather than
    # an in-order writeback
    flush: bool = False
    # the transfer is a spare-stream reissue of a failed/straggling
    # flush (ReissuePolicy mitigation on the snapshot path)
    reissued: bool = False
    # overlapped-checkpoint snapshot D2H: a pinned payload materialized
    # into a checkpoint shard (never touches the host store)
    ckpt: bool = False


def summarize_transfers(transfers: List[Transfer]) -> Dict[str, int]:
    """Per-direction raw/wire byte totals of a transfer log, with the
    write-back flush and overlapped-snapshot shares of d2h broken out.
    Shared by both engines so their summaries stay dict-comparable.

    Per-direction *counts* are reported too (one Transfer record = one
    link crossing): a temporal-k visit logs one fetch per unit no
    matter how many fused sweeps it advances, so counts — like the
    residency manager's lookup/deposit denominators — stay comparable
    across schedules while version counters advance k per visit.
    """
    tot = {
        "h2d_raw": 0, "h2d_wire": 0, "d2h_raw": 0, "d2h_wire": 0,
        "halo_raw": 0, "halo_wire": 0,
        "d2h_flush_wire": 0, "d2h_ckpt_wire": 0,
        "h2d_count": 0, "d2h_count": 0, "halo_count": 0,
    }
    for t in transfers:
        tot[f"{t.direction}_raw"] += t.raw_bytes
        tot[f"{t.direction}_wire"] += t.wire_bytes
        tot[f"{t.direction}_count"] += 1
        if t.flush:
            tot["d2h_flush_wire"] += t.wire_bytes
        if t.ckpt:
            tot["d2h_ckpt_wire"] += t.wire_bytes
    return tot


@dataclass
class Task:
    tid: str
    resource: str  # h2d | compute | d2h
    kind: str  # h2d | decompress | stencil | compress | d2h
    amount: float  # bytes (transfers/codec raw bytes) or cell-updates
    deps: Tuple[str, ...] = ()
    block: int = -1
    sync: bool = False  # pays Hardware.codec_sync_overhead in the replay
    # live-execution metadata (ignored by the timeline replay)
    field: str = ""
    unit: Optional[Tuple[str, int]] = None
    sweep: int = 0
    # unit version this task reads (h2d/decompress) or produces
    # (compress/d2h); versions count writebacks since seeding
    version: int = 0
    # d2h task that is a residency flush (dirty eviction) rather than
    # an in-order writeback
    flush: bool = False
    # d2h task that is an overlapped-checkpoint snapshot flush (pinned
    # payload -> checkpoint shard, overlapping the next sweep)
    ckpt: bool = False
    # owning tenant in a multi-tenant graph (``build_tenant_tasks``):
    # the emitting tenant for regular tasks, the VICTIM tenant for
    # cross-tenant eviction flushes. "" in single-tenant graphs.
    tenant: str = ""


@dataclass(frozen=True)
class Schedule:
    """Issue-order strategy shared by the replay and the executor."""

    name: str
    codec_sync: bool = False  # codec calls pay per-call sync (cuZFP)
    window: Optional[int] = None  # max block visits in flight (None = off)
    # sweeps fused per block visit (temporal blocking across sweeps);
    # 1 = every visit advances one sweep (all pre-temporal schedules)
    temporal: int = 1


PAPER = Schedule("paper", codec_sync=True)
UNITGRAIN = Schedule("unitgrain")
# historical name for unitgrain's fused-codec behaviour
OVERLAP = Schedule("overlap")

_DEPTH_RE = re.compile(r"depth-?(\d+)")
_TEMPORAL_RE = re.compile(r"temporal-?(\d+)")


def depth_k(k: int) -> Schedule:
    if k < 1:
        raise ValueError(f"depth-k window must be >= 1, got {k}")
    return Schedule(f"depth{k}", window=k)


def temporal_k(k: int) -> Schedule:
    """Unitgrain-style schedule fusing ``k`` sweeps per block visit.
    ``temporal1`` is graph-identical to ``unitgrain`` (same tids, same
    versions, same transfers) — only the schedule name differs."""
    if k < 1:
        raise ValueError(f"temporal-k fusion must be >= 1, got {k}")
    return Schedule(f"temporal{k}", temporal=k)


def get_schedule(sched: Union[str, Schedule]) -> Schedule:
    """Resolve a schedule name ("paper", "unitgrain", "overlap",
    "depth2", "depth-3", "temporal4", "temporal-2", ...) to a Schedule
    strategy.

    >>> get_schedule("paper").codec_sync
    True
    >>> get_schedule("depth-3").window
    3
    >>> get_schedule("unitgrain").window is None
    True
    >>> get_schedule("temporal-4").temporal
    4
    """
    if isinstance(sched, Schedule):
        return sched
    if sched == "paper":
        return PAPER
    if sched == "unitgrain":
        return UNITGRAIN
    if sched == "overlap":
        return OVERLAP
    m = _DEPTH_RE.fullmatch(sched)
    if m:
        return depth_k(int(m.group(1)))
    m = _TEMPORAL_RE.fullmatch(sched)
    if m:
        return temporal_k(int(m.group(1)))
    raise ValueError(f"unknown schedule: {sched!r}")


def wire_ratio(spec, itemsize: int) -> float:
    """wire/raw byte ratio of a field spec (1.0 if uncompressed)."""
    if not spec.compressed:
        return 1.0
    return zfp_ref.bits_per_value(3, spec.planes) / (8 * itemsize)


def rate_wire_bytes(
    planes: Optional[int], shape: Tuple[int, int, int], itemsize: int
) -> int:
    """Exact on-wire bytes of one unit encoded at ``planes`` bit-planes
    (``None`` = raw/lossless): the actual ``Compressed.nbytes()``
    (uint32 payload words after the pad-to-4 blockify, plus the 2-byte
    emax header per block). The pricing primitive of the adaptive-rate
    replay: the modeled residency manager budgets the same
    heterogeneous payload sizes the live executor deposits."""
    if planes is None:
        n = 1
        for s in shape:
            n *= s
        return n * itemsize
    nb = 1
    for s in shape:
        nb *= -(-s // 4)
    words = zfp_ref.payload_words(3, int(planes), 8 * itemsize)
    return nb * (words * 4 + 2)


def unit_wire_bytes(
    spec, shape: Tuple[int, int, int], itemsize: int
) -> int:
    """Exact on-wire bytes of one stored unit at its field spec's
    fixed rate — ``rate_wire_bytes`` at ``spec.planes``."""
    return rate_wire_bytes(
        spec.planes if spec.compressed else None, shape, itemsize
    )


def build_sweep_tasks(
    cfg,
    sweeps: int = 1,
    schedule: Union[str, Schedule] = "paper",
    cache_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
    ckpt_every: int = 0,
    ckpt_mode: str = "overlapped",
    shard=None,
    resource_prefix: str = "",
    rates=None,
) -> List[Task]:
    """Tasks for ``sweeps`` consecutive sweeps of the out-of-core engine,
    mirroring the engines' fetch/compute/writeback structure (units
    fetched once, common regions shared on device).

    ``cfg`` is an ``OOCConfig``. The returned list
    is in dependency (topological) order. With a windowed schedule,
    extra edges bound how many block visits may be in flight.

    The graph is *continuous across sweeps*: there is no sweep barrier.
    Each unit carries a version counter bumped by every writeback, and
    sweep *s+1*'s fetch of a unit depends on the d2h task that produced
    its current version (the fetch-after-writeback hazard as a
    dependency edge), so block 0 of the next sweep may start fetching
    while the tail of the previous sweep is still computing or
    writing back.

    A ``temporal-k`` schedule groups the ``sweeps`` into rounds of
    ``kr = min(k, sweeps_remaining)``: every block visit fetches the
    halo-k widened footprint (``BlockPlan(z, ndiv, bt*k)`` — same unit
    cover of [0, Z), wider commons), runs one fused ``bt*kr``-step
    stencil, and writes each unit back exactly once with ``kr``
    version bumps. Fetch-after-writeback hazard edges and the
    residency replay are computed against the widened footprint, and
    the final round truncates (``kr < k``) when ``sweeps`` is not a
    multiple of ``k``.

    ``cache_bytes`` models the executor's device residency manager
    (``unitcache.DeviceResidencyManager``): writebacks
    deposit their payload, read-only fields deposit on first fetch, and
    a fetch whose current version is still resident emits *no* h2d task
    (compressed units keep their decompress task, now depending on the
    depositing codec task). Under ``policy="write-back"`` (default) the
    write direction is elided too: a writeback whose dirty deposit was
    stored emits *no* d2h task (its version commits on device), and
    flush d2h tasks are emitted exactly at the eviction points where a
    dirty entry loses residency — so the replay prices both directions
    the live executor actually pays, including the flush traffic of an
    eviction regime. ``policy="write-through"`` makes every writeback
    materialize (the read-only cache, for A/B runs). ``stats``, if given, is
    filled with the modeled residency counters and elision totals.

    ``ckpt_every`` makes the schedule **checkpoint-aware**: after
    every k-th sweep a snapshot cut is taken at the frozen unit-version
    vector, replaying ``AsyncExecutor``'s periodic checkpointing.
    Under ``ckpt_mode="overlapped"`` (the default — ``run(...,
    ckpt_policy=)``'s overlapped cut) the dirty residents are pinned
    (COW in the shared residency manager) and their snapshot flush-D2H
    is emitted as ordinary graph transfers paced across the *next*
    sweep's visits — ``ckpt=True`` d2h tasks with a hazard edge from
    the codec task that produced the pinned payload, and **no** edge
    into the next sweep's fetch/compute, so the replay prices the
    overlap. ``ckpt_mode="quiesced"`` replays the quiesced cut for A/B:
    the dirty set flushes to host at the boundary (``flush=True``
    tasks, entries marked clean) and the next sweep's first visit
    gets barrier edges on the cut — the drain the overlapped cut
    exists to avoid.

    ``shard`` (a ``distributed.sharding.ShardSpec``) restricts the graph
    to that shard's contiguous global block range and adds the tasks of
    the halo exchange. The plan stays global, so tids, unit spans and
    versions line up with the single-device graph:

    * the first local block (when not the domain edge) also fetches its
      left common ``C_{lo-1}``, the region a single-device run carries
      on device from the previous visit; the shard owns and re-commits
      that unit every round, so the fetch replays through residency
      like any other;
    * after the first local block's writeback, a kind-``halo`` task on
      the ``halo`` resource exports the committed ``C_{lo-1}`` to the
      left neighbour's ghost, encoded (the exact ``Compressed.nbytes()``
      of a ZFP field), hazard-edged on the producing codec task and
      stamped with the version the writeback produced;
    * after the last local block's stencil (when not the domain edge), a
      kind-``halo`` task exports the held lower half of ``C_{hi-1}``
      (``halo`` raw planes, which the right neighbour's first writeback
      concatenates) to the right neighbour;
    * the right-boundary ghost ``C_{hi-1}``'s version advances ``kr`` a
      round (the neighbour's halo put); the ghost is never written
      locally, hence never cached, so its h2d is always emitted: the
      anchor ``build_sharded_tasks`` hangs the cross-shard edge on.

    ``resource_prefix`` namespaces every task's resource (e.g.
    ``"s1:"`` makes ``s1:h2d``/``s1:compute``/...), giving each shard
    its own stream set in a merged multi-device replay.

    ``rates`` (a ``ratecontrol.RateController``) replays
    per-unit adaptive encode rates: every fetch and writeback is priced
    at the EXACT encoded payload size of the unit's current rate
    (``rate_wire_bytes``), rate-``None`` units skip their codec tasks
    (raw/lossless crossings), and residency deposits carry the rate
    label for the per-rate byte gauges — so model and live agree
    transfer-for-transfer on the heterogeneous wire bytes at every
    budget. Pass the live run's controller (its decision log) to model
    that run, or a ``mode="fixed"`` controller for spec rates. Without
    ``rates`` the legacy pricing (``wire_ratio`` on the wire,
    ``unit_wire_bytes`` in the residency model) applies. Sharded halo
    exports price at the field spec's rate: rate control does not
    compose with sharding.
    """
    if ckpt_mode not in ("overlapped", "quiesced"):
        raise ValueError(
            f"unknown ckpt_mode {ckpt_mode!r}; "
            "expected 'overlapped' or 'quiesced'"
        )
    sched = get_schedule(schedule)
    # temporal-k widens the halo to radius*bt*k and fuses k sweeps per
    # visit; sweeps that don't divide k truncate on the final round
    plan = cfg.temporal_plan(sched.temporal)
    z, y, x = cfg.shape
    itemsize = 4 if cfg.dtype == "float32" else 8
    plane_bytes = y * x * itemsize
    tasks: List[Task] = []
    cache = UnitCache(cache_bytes, policy=policy)
    version: Dict[Tuple[str, Tuple[str, int]], int] = {}
    # tid of the d2h producing each unit's current host version
    writeback_of: Dict[Tuple[str, Tuple[str, int]], str] = {}
    # tid of the compute task that deposited the cached payload
    deposit_of: Dict[Tuple[str, Tuple[str, int]], str] = {}
    h2d_tasks = h2d_elided = d2h_tasks = 0

    def add(tid, resource, kind, amount, deps, block, *, sync=False,
            field="", unit=None, sweep=0, ver=0, flush=False,
            ckpt=False):
        tasks.append(Task(
            tid, resource_prefix + resource, kind, amount, tuple(deps),
            block,
            sync=sync and sched.codec_sync, field=field, unit=unit,
            sweep=sweep, version=ver, flush=flush, ckpt=ckpt,
        ))
        return tid

    def flush_task(ekey, eent, pre, block, s):
        """Flush-on-evict: the dirty entry ``eent`` lost residency, so
        its D2H happens HERE, before anything can refetch it (the
        fetch-after-writeback hazard across a pending flush)."""
        ef, (ekind, eidx) = ekey
        fdep = deposit_of.get(ekey)
        tid = add(
            f"{pre}.flush.{ef}.{ekind}{eidx}", "d2h", "d2h",
            eent.nbytes, (fdep,) if fdep else (), block,
            field=ef, unit=(ekind, eidx), sweep=s, ver=eent.version,
            flush=True,
        )
        writeback_of[ekey] = tid
        return tid

    def unit_span(kind: str, idx: int) -> Tuple[int, int]:
        return plan.remainder(idx) if kind == "R" else plan.common(idx)

    def unit_planes(kind: str, idx: int) -> int:
        lo, hi = unit_span(kind, idx)
        return hi - lo

    def exact_nbytes(spec, kind: str, idx: int) -> int:
        return unit_wire_bytes(
            spec, (unit_planes(kind, idx), y, x), itemsize
        )

    # adaptive-rate replay: the rate each unit's CURRENT payload was
    # encoded at (what the next fetch crosses the wire as), lazily
    # seeded at the controller's sweep-0 rate and updated by every
    # writeback's rate_for decision
    enc_rate: Dict[Tuple[str, Tuple[str, int]], Optional[int]] = {}

    def unit_rate(name: str, kind: str, idx: int) -> Optional[int]:
        key = (name, (kind, idx))
        if key not in enc_rate:
            enc_rate[key] = rates.rate_for(name, kind, idx, 0)
        return enc_rate[key]

    def rate_nbytes(kind: str, idx: int, r: Optional[int]) -> int:
        return rate_wire_bytes(
            r, (unit_planes(kind, idx), y, x), itemsize
        )

    prev_compute = None
    # last d2h tid of each block visit, for window edges
    drain_of_visit: Dict[int, str] = {}
    # overlapped checkpoint cut: pinned payloads awaiting their
    # snapshot flush-D2H, paced one chunk per subsequent block visit
    # (the cadence the live executor drains its queue with)
    pending_ckpt: List[Tuple] = []  # (key, nbytes, version, cut sweep)
    ckpt_chunk = 0
    ckpt_tasks_emitted = 0
    # quiesced cut: barrier edges into the next sweep's first visit
    barrier_dep: Tuple[str, ...] = ()

    def emit_ckpt(block: int, sweep_no: int,
                  limit: Optional[int] = None) -> None:
        """Emit pending snapshot flush-D2H tasks (release the pins).
        Overlapped mode: ``ckpt=True`` d2h tasks whose only dep is the
        codec task that produced the pinned payload — nothing in the
        next sweep depends on them, so they ride the idle d2h stream.
        Releasing a pin re-enforces the budget, so dirty victims of
        the pin pressure emit ordinary eviction-flush tasks here (the
        same handback the live drain pays)."""
        nonlocal ckpt_tasks_emitted
        n = (
            len(pending_ckpt) if limit is None
            else min(limit, len(pending_ckpt))
        )
        for _ in range(n):
            key, nbytes, ver, cs = pending_ckpt.pop(0)
            ef, (ekind, eidx) = key
            fdep = deposit_of.get(key)
            add(
                f"s{cs}.ckpt.{ef}.{ekind}{eidx}", "d2h", "d2h",
                nbytes, (fdep,) if fdep else (), block,
                field=ef, unit=(ekind, eidx), sweep=cs, ver=ver,
                ckpt=True,
            )
            for ekey, eent in cache.release(key):
                flush_task(
                    ekey, eent, f"s{sweep_no}b{block}.rel", block,
                    sweep_no,
                )
            cache.note_ckpt_flush(nbytes)
            ckpt_tasks_emitted += 1

    # temporal rounds: each block visit advances kr = min(k, remaining)
    # sweeps at once (truncation on the final round keeps total steps
    # exact). ``s`` labels the round's *starting* sweep — the value the
    # live executor's sweeps_done holds when it issues the fetch.
    rounds: List[Tuple[int, int]] = []
    s0 = 0
    while s0 < sweeps:
        kr = min(sched.temporal, sweeps - s0)
        rounds.append((s0, kr))
        s0 += kr
    # the shard's block range; window edges count local visits, as the
    # shard's own executor does
    blocks = list(shard.blocks) if shard is not None else list(
        range(plan.ndiv))
    for rnd, (s, kr) in enumerate(rounds):
        for j, i in enumerate(blocks):
            visit = rnd * len(blocks) + j
            pre = f"s{s}b{i}"
            window_dep: Tuple[str, ...] = ()
            if sched.window is not None and visit >= sched.window:
                prior = drain_of_visit.get(visit - sched.window)
                if prior is not None:
                    window_dep = (prior,)
            # one chunk of an in-flight overlapped snapshot drains at
            # each visit (same cadence as AsyncExecutor._drain_ckpt)
            if pending_ckpt:
                emit_ckpt(i, s, ckpt_chunk)
            if barrier_dep:
                # quiesced cut: this sweep may not start until the
                # boundary flush completed — the drain the overlapped
                # cut avoids
                window_dep = window_dep + barrier_dep
                barrier_dep = ()
            h2d_ids, dec_ids = [], []
            fetch_flushes: List[str] = []
            funits = list(plan.fetch_units(i))
            if shard is not None and i == shard.block_lo and i > 0:
                # first local block: fetch the left common a
                # single-device run carries on device
                funits.insert(0, ("C", i - 1))
            for name, spec in cfg.fields.items():
                for kind, idx in funits:
                    key = (name, (kind, idx))
                    ver = version.get(key, 0)
                    raw = unit_planes(kind, idx) * plane_bytes
                    if rates is not None:
                        # exact pricing at the rate the unit's current
                        # payload was encoded at; rate None arrives
                        # raw, so it needs no decompress task
                        r = (unit_rate(name, kind, idx)
                             if spec.compressed else None)
                        wire = rate_nbytes(kind, idx, r)
                        encoded = r is not None
                    else:
                        r = None
                        wire = raw * wire_ratio(spec, itemsize)
                        encoded = spec.compressed
                    hit = False
                    if cache.enabled:
                        hit, _ = cache.lookup(key, ver)
                    if hit:
                        h2d_elided += 1
                        if encoded:
                            ddep = deposit_of.get(key)
                            dec_ids.append(add(
                                f"{pre}.dec.{name}.{kind}{idx}",
                                "compute", "decompress", raw,
                                (ddep,) if ddep else window_dep, i,
                                sync=True, field=name, unit=(kind, idx),
                                sweep=s, ver=ver,
                            ))
                        continue
                    h2d_tasks += 1
                    deps = window_dep
                    wb = writeback_of.get(key)
                    if wb is not None:
                        deps = deps + (wb,)
                    tid = add(
                        f"{pre}.h2d.{name}.{kind}{idx}", "h2d", "h2d",
                        wire, deps, i,
                        field=name, unit=(kind, idx), sweep=s, ver=ver,
                    )
                    h2d_ids.append(tid)
                    if spec.role != "rw" and cache.enabled:
                        # never written back: cache the fetched payload
                        if rates is not None:
                            res = cache.deposit(
                                key, ver, None,
                                rate_nbytes(kind, idx, r),
                                rate=rate_label(r),
                            )
                        else:
                            res = cache.deposit(
                                key, ver, None,
                                exact_nbytes(spec, kind, idx),
                            )
                        deposit_of[key] = tid
                        for ekey, eent in res.flushes:
                            fetch_flushes.append(
                                flush_task(ekey, eent, pre, i, s)
                            )
                    if encoded:
                        dec_ids.append(add(
                            f"{pre}.dec.{name}.{kind}{idx}", "compute",
                            "decompress", raw, (tid,), i, sync=True,
                            field=name, unit=(kind, idx), sweep=s,
                            ver=ver,
                        ))
            # stencil: bt*kr fused steps over the (halo-k widened)
            # fetched extent; window_dep kept explicitly so the bound
            # survives fully-elided fetch sets
            cells = (plan.block + 2 * plan.halo) * y * x * cfg.bt * kr
            deps = tuple(h2d_ids + dec_ids) + (
                (prev_compute,) if prev_compute else ()
            )
            for d in window_dep:
                if d not in deps:
                    deps = deps + (d,)
            prev_compute = add(
                f"{pre}.stencil", "compute", "stencil", cells, deps, i,
                sweep=s,
            )
            if (shard is not None and i == shard.block_hi - 1
                    and not shard.last):
                # export the held new-time lower half of C_{hi-1} to the
                # right neighbour's first writeback, raw (its concat
                # input stays bit for bit)
                for name, spec in cfg.fields.items():
                    if spec.role != "rw":
                        continue
                    gkey = (name, ("C", i))
                    add(
                        f"{pre}.held.{name}.C{i}", "halo", "halo",
                        plan.halo * plane_bytes, (prev_compute,), i,
                        field=name, unit=("C", i), sweep=s,
                        ver=version.get(gkey, 0) + kr,
                    )
            last_d2h = fetch_flushes[-1] if fetch_flushes else prev_compute
            for name, spec in cfg.fields.items():
                if spec.role != "rw":
                    continue
                for kind, idx in plan.writeback_units(i):
                    key = (name, (kind, idx))
                    # one writeback carries every fused sweep's bump:
                    # k version bumps per visit, one d2h payload
                    ver = version.get(key, 0) + kr
                    version[key] = ver
                    raw = unit_planes(kind, idx) * plane_bytes
                    if rates is not None:
                        # this round's rate decision (the live engines
                        # consult rate_for at the same round-start
                        # sweep s); rate None commits raw = lossless,
                        # with no compress task
                        r = (rates.rate_for(name, kind, idx, s)
                             if spec.compressed else None)
                        enc_rate[key] = r
                        wire = rate_nbytes(kind, idx, r)
                        do_comp = r is not None
                    else:
                        r = None
                        wire = raw * wire_ratio(spec, itemsize)
                        do_comp = spec.compressed
                    dep: Tuple[str, ...] = (prev_compute,)
                    if do_comp:
                        dep = (add(
                            f"{pre}.comp.{name}.{kind}{idx}", "compute",
                            "compress", raw, dep, i, sync=True,
                            field=name, unit=(kind, idx), sweep=s,
                            ver=ver,
                        ),)
                    if (shard is not None and kind == "C"
                            and idx == shard.block_lo - 1):
                        # ship the committed left common to the left
                        # neighbour's ghost: the encoded payload (exact
                        # ZFP nbytes), hazard-edged on the codec task,
                        # independent of the d2h (which residency may
                        # elide)
                        add(
                            f"{pre}.halo.{name}.{kind}{idx}", "halo",
                            "halo", exact_nbytes(spec, kind, idx),
                            dep, i,
                            field=name, unit=(kind, idx), sweep=s,
                            ver=ver,
                        )
                    if cache.enabled:
                        # deposited before (independent of) the host
                        # materialization — the next sweep can hit even
                        # while this d2h is still in flight. Write-back
                        # deposits dirty: a stored deposit's d2h never
                        # happens as its own task (the version commits
                        # on device; the bytes move only in a flush).
                        # Payload sizes may differ across versions
                        # under adaptive rates; the manager drops the
                        # superseded entry before its budget check, so
                        # this replay stays in lockstep with the live
                        # deposits.
                        if rates is not None:
                            nb = rate_nbytes(kind, idx, r)
                            res = cache.deposit(
                                key, ver, None, nb, dirty=True,
                                bumps=kr, rate=rate_label(r),
                            )
                        else:
                            nb = exact_nbytes(spec, kind, idx)
                            res = cache.deposit(
                                key, ver, None, nb, dirty=True,
                                bumps=kr,
                            )
                        deposit_of[key] = dep[0]
                        for ekey, eent in res.flushes:
                            last_d2h = flush_task(ekey, eent, pre, i, s)
                        if res.stored and cache.write_back:
                            cache.note_d2h_elided(nb)
                            continue
                    d2h_tasks += 1
                    last_d2h = add(
                        f"{pre}.d2h.{name}.{kind}{idx}", "d2h", "d2h",
                        wire, dep, i,
                        field=name, unit=(kind, idx), sweep=s, ver=ver,
                    )
                    writeback_of[key] = last_d2h
            drain_of_visit[visit] = last_d2h
        if shard is not None and not shard.last:
            # the right neighbour's halo put lands at the round boundary:
            # the ghost common's version advances kr a round, so the next
            # round's fetch reads the refreshed mirror
            for name, spec in cfg.fields.items():
                if spec.role == "rw":
                    gkey = (name, ("C", shard.block_hi - 1))
                    version[gkey] = version.get(gkey, 0) + kr
        if ckpt_every and (s + kr) % ckpt_every == 0:
            # the checkpoint cut at this sweep boundary, at the frozen
            # version vector (every version this sweep issued)
            if ckpt_mode == "overlapped":
                emit_ckpt(plan.ndiv - 1, s)  # finish a prior snapshot
                for k, e in cache.dirty_entries():
                    cache.pin(k)
                    pending_ckpt.append((k, e.nbytes, e.version, s))
                ckpt_chunk = -(-len(pending_ckpt) // plan.ndiv)
            else:
                # quiesced: the dirty set flushes to host AT the
                # boundary (entries stay resident, now clean) and the
                # next sweep's first visit barriers on the cut
                cut_tids: List[str] = []
                last = drain_of_visit.get(visit)
                if last is not None:
                    cut_tids.append(last)
                for k, e in cache.dirty_entries():
                    ef, (ekind, eidx) = k
                    fdep = deposit_of.get(k)
                    deps = (fdep,) if fdep else ()
                    if prev_compute and prev_compute not in deps:
                        deps = deps + (prev_compute,)
                    tid = add(
                        f"s{s}.ckptflush.{ef}.{ekind}{eidx}", "d2h",
                        "d2h", e.nbytes, deps, plan.ndiv - 1,
                        field=ef, unit=(ekind, eidx), sweep=s,
                        ver=e.version, flush=True,
                    )
                    cache.mark_flushed(k)
                    writeback_of[k] = tid
                    cut_tids.append(tid)
                barrier_dep = tuple(cut_tids)
    # a final-boundary cut drains at the end
    emit_ckpt(plan.ndiv - 1, sweeps - 1)
    if stats is not None:
        stats.update(cache.stats.as_dict())
        # elided wire bytes are exactly the manager's hit_wire_bytes /
        # d2h_elided_wire_bytes (deposits use exact payload sizes) —
        # one accounting, shared with the live executor's CacheStats
        stats.update({
            "h2d_tasks": h2d_tasks,
            "h2d_elided": h2d_elided,
            "d2h_tasks": d2h_tasks,
            "flush_tasks": cache.stats.flushes,
            "ckpt_tasks": ckpt_tasks_emitted,
            "cache_peak_bytes": cache.peak_bytes,
        })
    return tasks


def build_sharded_tasks(
    cfg,
    nshards: int,
    sweeps: int = 1,
    schedule: Union[str, Schedule] = "unitgrain",
    cache_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
) -> List[Task]:
    """Merged multi-device task graph: one per-shard graph per device
    (resources namespaced ``s{d}:h2d``/``s{d}:compute``/... so each
    shard replays on its own stream set) plus the cross-shard hazard
    edges of the halo exchange:

    * **held** (shard *d*, round *r*) → the right neighbor's boundary
      writeback chain in the *same* round — its compress task when the
      field is compressed, else its d2h, else its own halo export.
      Deliberately *not* into the neighbor's stencil: only the
      boundary common's commit waits on the import, so shards pipeline
      as a wavefront and the per-sweep makespan drops toward 1/N;
    * **unit halo** (shard *d+1*, round *r*) → shard *d*'s ghost
      refetch in the *next* round (the fetch-after-halo-put hazard;
      the ghost is never resident, so that h2d task always exists).

    The merge is round-major (shard-ascending within a round), keeping
    the list in dependency order for the replay. ``stats`` (if given)
    gains a ``"per_device"`` dict of each shard's residency counters.
    """
    from repro_torch.distributed.sharding import partition_domain

    sched = get_schedule(schedule)
    specs = partition_domain(cfg.ndiv, nshards)
    rounds: List[Tuple[int, int]] = []
    s0 = 0
    while s0 < sweeps:
        kr = min(sched.temporal, sweeps - s0)
        rounds.append((s0, kr))
        s0 += kr
    per_shard: List[List[Task]] = []
    for spec in specs:
        st: Dict[str, object] = {}
        per_shard.append(build_sweep_tasks(
            cfg, sweeps, sched, cache_bytes, st, policy,
            shard=spec, resource_prefix=f"s{spec.index}:",
        ))
        if stats is not None:
            stats.setdefault("per_device", {})[spec.index] = st
    merged: List[Task] = []
    for s, _ in rounds:
        for tl in per_shard:
            merged.extend(t for t in tl if t.sweep == s)
    by_tid = {t.tid: t for t in merged}
    rw = [n for n, sp in cfg.fields.items() if sp.role == "rw"]
    for r, (s, kr) in enumerate(rounds):
        for spec in specs[:-1]:
            hi = spec.block_hi
            for name in rw:
                held = f"s{s}b{hi - 1}.held.{name}.C{hi - 1}"
                for cand in (f"s{s}b{hi}.comp.{name}.C{hi - 1}",
                             f"s{s}b{hi}.d2h.{name}.C{hi - 1}",
                             f"s{s}b{hi}.halo.{name}.C{hi - 1}"):
                    tgt = by_tid.get(cand)
                    if tgt is not None:
                        tgt.deps = tgt.deps + (held,)
                        break
                if r + 1 < len(rounds):
                    ns = rounds[r + 1][0]
                    halo = f"s{s}b{hi}.halo.{name}.C{hi - 1}"
                    tgt = by_tid.get(
                        f"s{ns}b{hi - 1}.h2d.{name}.C{hi - 1}"
                    )
                    if tgt is not None and halo in by_tid:
                        tgt.deps = tgt.deps + (halo,)
    return merged


def build_tenant_tasks(
    tenants,
    budget_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
) -> List[Task]:
    """Merged multi-tenant task graph: N independent runs (each its own
    config, schedule and sweep count) interleaved round-robin onto one
    shared stream set and one shared, arbiter-managed residency budget.

    ``tenants`` is a sequence of ``core.tenancy.TenantSpec``-like
    objects (``name``/``cfg``/``schedule``/``sweeps``/``reserve``/
    ``priority``). The builder walks the global round order the live
    ``serving.ooc.TenantScheduler`` drives (``tenancy.interleave_rounds``)
    and replays one ``ResidencyArbiter``-managed cache across all
    tenants, keys namespaced ``(tenant, unit_key)``. A visit emits what
    the single-run builder emits, with two differences:

    * every task carries ``Task.tenant``, so each tenant's transfers can
      be filtered out and compared with its live executor's log;
    * a cross-tenant eviction flush belongs to the victim: its task's
      ``tenant`` and ``sweep`` are the victim's name and the victim's
      completed-sweeps count, which the victim's live executor records
      when the scheduler routes the handback to it mid-round of another
      tenant.

    Resources are the unprefixed ``h2d``/``compute``/``d2h``, so
    ``pipeline.simulate`` prices the merged list as one shared device.
    ``stats`` (if given) gains a ``"per_tenant"`` dict of each tenant's
    residency counters, peak bytes and task counts.
    """
    from repro_torch.core.tenancy import interleave_rounds
    from repro_torch.core.unitcache import ResidencyArbiter

    arb = ResidencyArbiter()
    for t in tenants:
        arb.grant(t.name, t.reserve, t.priority)
    cache = UnitCache(budget_bytes, policy=policy, arbiter=arb)
    tasks: List[Task] = []
    # shared maps over namespaced keys (tenant, (field, (kind, idx)))
    version: Dict[Tuple, int] = {}
    writeback_of: Dict[Tuple, str] = {}
    deposit_of: Dict[Tuple, str] = {}
    st: Dict[str, Dict[str, object]] = {}
    for t in tenants:
        sched = get_schedule(t.schedule)
        plan = t.cfg.temporal_plan(sched.temporal)
        _, y, x = t.cfg.shape
        itemsize = 4 if t.cfg.dtype == "float32" else 8
        st[t.name] = {
            "cfg": t.cfg, "sched": sched, "plan": plan,
            "y": y, "x": x, "itemsize": itemsize,
            "plane_bytes": y * x * itemsize,
            "prev_compute": None, "drain_of_visit": {}, "visits": 0,
            "sweeps_done": 0,
            "h2d_tasks": 0, "h2d_elided": 0, "d2h_tasks": 0,
        }

    def add(tid, resource, kind, amount, deps, block, *, sync=False,
            field="", unit=None, sweep=0, ver=0, flush=False,
            tenant=""):
        tasks.append(Task(
            tid, resource, kind, amount, tuple(deps), block, sync=sync,
            field=field, unit=unit, sweep=sweep, version=ver,
            flush=flush, tenant=tenant,
        ))
        return tid

    def flush_task(ekey, eent, pre, block):
        """Flush-on-evict across the shared budget, attributed to the
        victim tenant at the victim's completed-sweeps label."""
        etenant, (ef, (ekind, eidx)) = ekey
        fdep = deposit_of.get(ekey)
        tid = add(
            f"{pre}.flush.{etenant}.{ef}.{ekind}{eidx}", "d2h", "d2h",
            eent.nbytes, (fdep,) if fdep else (), block,
            field=ef, unit=(ekind, eidx),
            sweep=st[etenant]["sweeps_done"], ver=eent.version,
            flush=True, tenant=etenant,
        )
        writeback_of[ekey] = tid
        return tid

    for tname, s, kr in interleave_rounds(tenants):
        ts = st[tname]
        cfg, sched, plan = ts["cfg"], ts["sched"], ts["plan"]
        y, x = ts["y"], ts["x"]
        itemsize, plane_bytes = ts["itemsize"], ts["plane_bytes"]
        # mid-round flushes of this tenant's own entries carry the
        # round-start sweep (the live sweeps_done advances at round end)
        ts["sweeps_done"] = s

        def unit_planes(kind, idx):
            lo, hi = (
                plan.remainder(idx) if kind == "R" else plan.common(idx)
            )
            return hi - lo

        def exact_nbytes(spec, kind, idx):
            return unit_wire_bytes(
                spec, (unit_planes(kind, idx), y, x), itemsize
            )

        for j, i in enumerate(range(plan.ndiv)):
            visit = ts["visits"] + j
            pre = f"{tname}/s{s}b{i}"
            window_dep: Tuple[str, ...] = ()
            if sched.window is not None and visit >= sched.window:
                prior = ts["drain_of_visit"].get(visit - sched.window)
                if prior is not None:
                    window_dep = (prior,)
            h2d_ids, dec_ids = [], []
            fetch_flushes: List[str] = []
            for name, spec in cfg.fields.items():
                for kind, idx in plan.fetch_units(i):
                    key = (tname, (name, (kind, idx)))
                    ver = version.get(key, 0)
                    raw = unit_planes(kind, idx) * plane_bytes
                    wire = raw * wire_ratio(spec, itemsize)
                    hit = False
                    if cache.enabled:
                        hit, _ = cache.lookup(key, ver)
                    if hit:
                        ts["h2d_elided"] += 1
                        if spec.compressed:
                            ddep = deposit_of.get(key)
                            dec_ids.append(add(
                                f"{pre}.dec.{name}.{kind}{idx}",
                                "compute", "decompress", raw,
                                (ddep,) if ddep else window_dep, i,
                                sync=sched.codec_sync, field=name,
                                unit=(kind, idx), sweep=s, ver=ver,
                                tenant=tname,
                            ))
                        continue
                    ts["h2d_tasks"] += 1
                    deps = window_dep
                    wb = writeback_of.get(key)
                    if wb is not None:
                        deps = deps + (wb,)
                    tid = add(
                        f"{pre}.h2d.{name}.{kind}{idx}", "h2d", "h2d",
                        wire, deps, i,
                        field=name, unit=(kind, idx), sweep=s, ver=ver,
                        tenant=tname,
                    )
                    h2d_ids.append(tid)
                    if spec.role != "rw" and cache.enabled:
                        res = cache.deposit(
                            key, ver, None, exact_nbytes(spec, kind, idx)
                        )
                        deposit_of[key] = tid
                        for ekey, eent in res.flushes:
                            fetch_flushes.append(
                                flush_task(ekey, eent, pre, i)
                            )
                    if spec.compressed:
                        dec_ids.append(add(
                            f"{pre}.dec.{name}.{kind}{idx}", "compute",
                            "decompress", raw, (tid,), i,
                            sync=sched.codec_sync, field=name,
                            unit=(kind, idx), sweep=s, ver=ver,
                            tenant=tname,
                        ))
            cells = (plan.block + 2 * plan.halo) * y * x * cfg.bt * kr
            deps = tuple(h2d_ids + dec_ids) + (
                (ts["prev_compute"],) if ts["prev_compute"] else ()
            )
            for d in window_dep:
                if d not in deps:
                    deps = deps + (d,)
            ts["prev_compute"] = add(
                f"{pre}.stencil", "compute", "stencil", cells, deps, i,
                sweep=s, tenant=tname,
            )
            last_d2h = (
                fetch_flushes[-1] if fetch_flushes else ts["prev_compute"]
            )
            for name, spec in cfg.fields.items():
                if spec.role != "rw":
                    continue
                for kind, idx in plan.writeback_units(i):
                    key = (tname, (name, (kind, idx)))
                    ver = version.get(key, 0) + kr
                    version[key] = ver
                    raw = unit_planes(kind, idx) * plane_bytes
                    wire = raw * wire_ratio(spec, itemsize)
                    dep: Tuple[str, ...] = (ts["prev_compute"],)
                    if spec.compressed:
                        dep = (add(
                            f"{pre}.comp.{name}.{kind}{idx}", "compute",
                            "compress", raw, dep, i,
                            sync=sched.codec_sync, field=name,
                            unit=(kind, idx), sweep=s, ver=ver,
                            tenant=tname,
                        ),)
                    if cache.enabled:
                        res = cache.deposit(
                            key, ver, None,
                            exact_nbytes(spec, kind, idx), dirty=True,
                            bumps=kr,
                        )
                        deposit_of[key] = dep[0]
                        for ekey, eent in res.flushes:
                            last_d2h = flush_task(ekey, eent, pre, i)
                        if res.stored and cache.write_back:
                            cache.note_d2h_elided(
                                exact_nbytes(spec, kind, idx),
                                tenant=tname,
                            )
                            continue
                    ts["d2h_tasks"] += 1
                    last_d2h = add(
                        f"{pre}.d2h.{name}.{kind}{idx}", "d2h", "d2h",
                        wire, dep, i,
                        field=name, unit=(kind, idx), sweep=s, ver=ver,
                        tenant=tname,
                    )
                    writeback_of[key] = last_d2h
            ts["drain_of_visit"][visit] = last_d2h
        ts["visits"] += plan.ndiv
        ts["sweeps_done"] = s + kr
    if stats is not None:
        stats.update(cache.stats.as_dict())
        stats["cache_peak_bytes"] = cache.peak_bytes
        per_tenant: Dict[str, Dict[str, object]] = {}
        for t in tenants:
            d = cache.tenant_stats_for(t.name).as_dict()
            d.update({
                "h2d_tasks": st[t.name]["h2d_tasks"],
                "h2d_elided": st[t.name]["h2d_elided"],
                "d2h_tasks": st[t.name]["d2h_tasks"],
                "peak_bytes": cache.tenant_peak.get(t.name, 0),
                "reserve": t.reserve,
                "priority": t.priority,
            })
            per_tenant[t.name] = d
        stats["per_tenant"] = per_tenant
    return tasks


def wire_totals(tasks: List[Task]) -> Dict[str, float]:
    """Modeled wire bytes per link direction (h2d/d2h task amounts;
    residency flushes are d2h tasks and count toward d2h; halo tasks
    are the inter-device links of a sharded graph)."""
    out = {"h2d": 0.0, "d2h": 0.0, "halo": 0.0}
    for t in tasks:
        if t.kind in out:
            out[t.kind] += t.amount
    return out

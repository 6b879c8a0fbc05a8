"""Timeline model of the out-of-core sweep: the three-stream replay.

Port of ``repro.core.pipeline``. The paper overlaps H2D transfer, device
work (decompress, ``bt`` stencil steps, compress) and D2H transfer on
three CUDA streams (its Fig. 4). This module replays the shared task
graph (``core.taskgraph``) on an event-driven timeline with FIFO
resources, pricing each task from a ``Hardware`` profile: the makespan
(Fig. 5), busy time by kind and by stream and the bounding one (Fig. 6),
and the schedules, residency, checkpoint cuts, faults and sharding the
live engine (``core.executor.AsyncExecutor``, ``core.sharded``) runs for
real on the same graph.

Resources:
  * ``h2d``      host-to-device copies
  * ``compute``  the device's execution stream: stencil and codec
                 kernels serialize here
  * ``d2h``      device-to-host copies
  * ``halo``     a shard's inter-device link (sharded graphs, whose
                 resources carry an ``s{d}:`` prefix)

The one profile carried is ``V100_PCIE``, a model of the paper's testbed
built from its datasheet. No H100 profile is carried until the port's
chip benchmarks have measured its numbers (ROADMAP queue 1 item 8).
``tenant_timeline`` replays N tenants' runs interleaved on one shared
device (``taskgraph.build_tenant_tasks``).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.taskgraph import (  # noqa: F401  (re-exported API)
    Schedule,
    Task,
    build_sharded_tasks,
    build_sweep_tasks,
    build_tenant_tasks,
    get_schedule,
)
from repro_torch.distributed.fault import FaultPlan, ReissuePolicy, \
    RetryPolicy


@dataclass(frozen=True)
class Hardware:
    name: str
    h2d_bw: float  # B/s
    d2h_bw: float  # B/s
    stencil_pts_per_s: float  # cell-updates/s for the 25-pt kernel
    compress_bw: float  # B/s of *raw* data through the encoder
    decompress_bw: float  # B/s of raw data through the decoder
    launch_latency: float = 5e-6  # per-task overhead (s)
    # per-codec-call synchronization cost of the paper's modified cuZFP
    # (multi-stage kernels with stream syncs inside a call): the
    # "unidentified overheads" of its §VI-B. The fused single-pass codec
    # (``unitgrain``/``overlap`` schedules) does not pay it.
    codec_sync_overhead: float = 8e-3
    # inter-device link bandwidth (B/s) of the sharded halo exchange.
    # ``None`` prices halo tasks at ``d2h_bw``, an exchange staged
    # through the host
    halo_bw: Optional[float] = None


# A model of the paper's testbed, Tesla V100-PCIe 32GB on PCIe 3.0 x16
# (its Table II), built from the card's datasheet, not measured. The
# float64 25-point stencil is bound by HBM on the V100: ~900 GB/s over
# ~44 effective bytes a point ~ 2e10 points/s. With that the
# uncompressed code is transfer-bound and code 4 compute-bound, the
# structure of the paper's Fig. 6.
V100_PCIE = Hardware(
    name="v100-pcie",
    h2d_bw=12.0e9,
    d2h_bw=12.0e9,
    stencil_pts_per_s=2.0e10,
    compress_bw=50.0e9,  # cuZFP-class fixed-rate encode, f64 raw bytes
    decompress_bw=60.0e9,
)

@dataclass
class Span:
    start: float
    end: float


@dataclass
class Timeline:
    spans: Dict[str, Span]
    tasks: Dict[str, Task]
    # transfer tasks whose completion came from the spare-stream
    # reissue (ReissuePolicy mitigation), not the original attempt
    reissued: List[str] = field(default_factory=list)
    # per-attempt occupancy of reissued tasks: tid -> [(resource,
    # span)] — the aborted attempt on the issuing stream (until the
    # cancel deadline) and the retry on "spare". Tasks not present
    # here occupied task.resource for their whole span.
    attempts: Dict[str, List[Tuple[str, Span]]] = field(
        default_factory=dict
    )
    # attempt count per transfer task under an injected FaultPlan
    # (failed/corrupt attempts + the succeeding one); tasks absent
    # here completed on their first attempt
    wire_attempts: Dict[str, int] = field(default_factory=dict)
    # transfer tasks whose retry budget the plan exhausted — the live
    # engine raises UnrecoverableFault on these (and, with a
    # RecoveryPolicy, rolls back); the model schedules every attempt
    # and reports the casualty here
    failed: List[str] = field(default_factory=list)

    @property
    def makespan(self) -> float:
        return max((s.end for s in self.spans.values()), default=0.0)

    def _occupancy(self, tid: str) -> List[Tuple[str, Span]]:
        at = self.attempts.get(tid)
        if at is not None:
            return at
        return [(self.tasks[tid].resource, self.spans[tid])]

    def busy(self) -> Dict[str, float]:
        """Per-kind busy time (the Fig. 6 bars). A reissued transfer
        contributes its actual stream occupancy — aborted attempt plus
        retry — not its dependency span (which includes the idle wait
        for the spare stream)."""
        out: Dict[str, float] = {}
        for tid in self.spans:
            kind = self.tasks[tid].kind
            for _, span in self._occupancy(tid):
                out[kind] = out.get(kind, 0.0) + (span.end - span.start)
        return out

    def bounding_operation(self) -> str:
        """Busiest *kind* (paper Fig. 6's 'bounding operation')."""
        return max(self.busy().items(), key=lambda kv: kv[1])[0]

    def busy_by_resource(self) -> Dict[str, float]:
        """Per-stream busy time. A reissued transfer occupies its
        issuing stream only until the cancel deadline; the retry's
        time belongs to ``spare`` — previously the whole span (both
        attempts AND the spare wait) was charged to the issuing
        stream, double-counting every reissued flush."""
        out: Dict[str, float] = {}
        for tid in self.spans:
            for res, span in self._occupancy(tid):
                out[res] = out.get(res, 0.0) + (span.end - span.start)
        return out

    def bounding_resource(self) -> str:
        """Busiest stream — 'compute' includes codec kernels, which is
        how paper Fig. 6 decides transfer- vs compute-bound."""
        return max(self.busy_by_resource().items(), key=lambda kv: kv[1])[0]

    def attempt_multiset(self) -> Counter:
        """Multiset of transfer identities with their attempt counts —
        ``(kind, field, unit, version, attempts)`` — the model side of
        the parity contract with ``HostUnitStore.attempt_multiset()``:
        under the same ``FaultPlan`` and ``RetryPolicy`` the live
        engine and this replay must produce the same multiset."""
        out: Counter = Counter()
        for t in self.tasks.values():
            if t.unit is None:
                continue
            if t.kind in ("h2d", "d2h") or (
                t.kind == "halo" and ".halo." in t.tid
            ):
                # unit-halo puts route through the importer's store
                # wire loop like any d2h; held slices do not (they are
                # a direct device exchange, never a store op)
                out[(
                    t.kind, t.field, f"{t.unit[0]}{t.unit[1]}",
                    int(t.version),
                    self.wire_attempts.get(t.tid, 1),
                )] += 1
        return out

    def transfer_wire(self) -> Dict[str, float]:
        """Modeled wire bytes by direction with the flush and
        overlapped-snapshot shares broken out — the model-side mirror
        of ``taskgraph.summarize_transfers`` over the live engine's
        transfer log. Each transfer task counts **once**, reissued or
        not: the live engine's ``CacheStats.flush_wire_bytes`` counts
        one successful put per flush (the aborted attempt moves no
        accountable payload), so per-attempt counting would drift from
        the live stats by one put per injected fault."""
        out = {
            "h2d_wire": 0.0, "d2h_wire": 0.0,
            "d2h_flush_wire": 0.0, "d2h_ckpt_wire": 0.0,
            "halo_wire": 0.0,
        }
        for t in self.tasks.values():
            if t.kind not in ("h2d", "d2h", "halo"):
                continue
            out[f"{t.kind}_wire"] += t.amount
            if t.flush:
                out["d2h_flush_wire"] += t.amount
            if t.ckpt:
                out["d2h_ckpt_wire"] += t.amount
        return out


def _duration(task: Task, hw: Hardware) -> float:
    extra = hw.launch_latency + (hw.codec_sync_overhead if task.sync else 0.0)
    if task.kind == "h2d":
        return task.amount / hw.h2d_bw + extra
    if task.kind == "d2h":
        return task.amount / hw.d2h_bw + extra
    if task.kind == "decompress":
        return task.amount / hw.decompress_bw + extra
    if task.kind == "compress":
        return task.amount / hw.compress_bw + extra
    if task.kind == "stencil":
        return task.amount / hw.stencil_pts_per_s + extra
    if task.kind == "halo":
        return task.amount / (hw.halo_bw or hw.d2h_bw) + extra
    raise ValueError(task.kind)


def simulate(tasks: List[Task], hw: Hardware,
             straggler: Optional[Dict[str, float]] = None,
             reissue: Optional[ReissuePolicy] = None,
             retry: Optional[RetryPolicy] = None,
             faults: Optional[FaultPlan] = None) -> Timeline:
    """List-schedule tasks on FIFO resources honouring dependencies.

    ``straggler`` maps task-id prefixes to slowdown factors (fault
    injection for the mitigation tests). ``reissue`` enables the
    straggler mitigation the live flush path integrates: a transfer
    task (h2d/d2h resource) whose actual duration exceeds the policy
    deadline (``factor`` x its nominal duration) is **cancelled at the
    detection deadline and reissued on a dedicated ``spare`` stream**
    — the issuing stream frees at the cancel (queued transfers behind
    the straggler stop waiting), and the task completes, unblocking
    its dependents, when the reissue lands. Reissued task ids are
    reported in ``Timeline.reissued``.

    ``faults`` prices a deterministic ``FaultPlan`` on every transfer
    task carrying a unit identity, mirroring the live store's wire
    loop: each attempt the plan faults (transfer failure or in-flight
    corruption caught by the checksum) occupies the issuing stream for
    the full transfer duration, ``retry.backoff(n)`` idles between
    attempts, and straggle specs multiply the duration in-line. The
    resulting per-task attempt counts land in ``Timeline.
    wire_attempts`` (compare with ``HostUnitStore.attempt_multiset()``
    via ``Timeline.attempt_multiset()``); a task whose retry budget
    the plan exhausts is reported in ``Timeline.failed`` — the point
    where the live engine raises ``UnrecoverableFault``. ``retry``
    defaults to ``reissue``; with neither, every transfer has a single
    attempt. Fault-injected tasks use this bounded-retry pricing, not
    the legacy cancel-and-reissue branch.
    """
    free: Dict[str, float] = {}
    spans: Dict[str, Span] = {}
    byid = {t.tid: t for t in tasks}
    reissued: List[str] = []
    attempts: Dict[str, List[Tuple[str, Span]]] = {}
    wire_attempts: Dict[str, int] = {}
    failed: List[str] = []
    pol = retry if retry is not None else reissue
    for t in tasks:
        nominal = _duration(t, hw)
        dur = nominal
        if straggler:
            for prefix, slow in straggler.items():
                if t.tid.startswith(prefix):
                    dur *= slow
        injected = (
            faults is not None
            and t.unit is not None
            and (
                t.kind in ("h2d", "d2h")
                or (t.kind == "halo" and ".halo." in t.tid)
            )
        )
        if injected:
            unitlabel = f"{t.unit[0]}{t.unit[1]}"
            dur *= faults.straggle(
                t.kind, t.field, unitlabel, int(t.version)
            )
        ready = max((spans[d].end for d in t.deps), default=0.0)
        start = max(free.get(t.resource, 0.0), ready)
        if injected:
            # bounded-retry pricing, mirroring HostUnitStore._wire:
            # count the leading attempts the plan faults (identity-
            # keyed, so live reordering cannot change the answer),
            # schedule each failed attempt + the succeeding one
            # back-to-back on the issuing stream with backoff gaps.
            max_att = pol.attempts if pol is not None else 1
            n_faulted = 0
            while n_faulted < max_att and faults.decide(
                t.kind, t.field, unitlabel, int(t.version), n_faulted
            ) is not None:
                n_faulted += 1
            exhausted = n_faulted >= max_att
            n_att = max_att if exhausted else n_faulted + 1
            aspans: List[Tuple[str, Span]] = []
            cur = start
            for i in range(n_att):
                if i and pol is not None:
                    cur += pol.backoff(i)
                aspans.append((t.resource, Span(cur, cur + dur)))
                cur += dur
            end = cur
            if n_att > 1:
                attempts[t.tid] = aspans
                wire_attempts[t.tid] = n_att
            if exhausted:
                failed.append(t.tid)
            spans[t.tid] = Span(start, end)
            free[t.resource] = end
            continue
        end = start + dur
        busy_until = end
        if (
            reissue is not None
            and t.resource in ("h2d", "d2h")
            and reissue.should_reissue(dur, nominal)
        ):
            # cancel-and-reissue: the monitor only sees "deadline
            # passed", so the decision commits — the original attempt
            # is killed at the deadline and the spare stream carries
            # the nominal-duration retry
            detect = start + reissue.deadline(nominal)
            rstart = max(detect, free.get("spare", 0.0))
            end = rstart + nominal
            busy_until = detect
            free["spare"] = end
            reissued.append(t.tid)
            # occupancy accounting: the issuing stream was busy only
            # until the cancel; the retry ran on the spare stream. The
            # dependency span below still covers both attempts (that
            # is when dependents unblock), but busy/wire accounting
            # must not charge the issuing stream twice.
            attempts[t.tid] = [
                (t.resource, Span(start, detect)),
                ("spare", Span(rstart, end)),
            ]
        spans[t.tid] = Span(start, end)
        free[t.resource] = busy_until
    return Timeline(
        spans, byid, reissued, attempts, wire_attempts, failed
    )


def sweep_timeline(
    cfg, hw: Hardware, sweeps: int = 1,
    schedule: Union[str, Schedule] = "paper",
    cache_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
    ckpt_every: int = 0,
    ckpt_mode: str = "overlapped",
    reissue: Optional[ReissuePolicy] = None,
    retry: Optional[RetryPolicy] = None,
    faults: Optional[FaultPlan] = None,
    rates=None,
) -> Timeline:
    """Replay ``sweeps`` sweeps of ``cfg`` under ``schedule`` on ``hw``.

    ``cache_bytes`` models the executor's device residency manager:
    fetches whose current version is still resident emit no h2d task,
    and under ``policy="write-back"`` (default) resident writebacks
    emit no d2h task either — flush d2h tasks appear at the eviction
    points where dirty payloads lose residency. The replay therefore
    prices exactly the transfers the live engine pays in both
    directions (``stats`` receives the modeled hit/elision/flush
    counters); ``policy="write-through"`` reproduces the
    materialize-every-writeback timeline for A/B comparison.

    ``ckpt_every``/``ckpt_mode`` price periodic checkpointing
    (``AsyncExecutor.run(..., ckpt_policy=)``): ``"overlapped"`` rides
    the snapshot's flush-D2H on the next sweep's idle d2h stream,
    ``"quiesced"`` drains at the boundary — comparing the two
    makespans prices exactly the overlap the checkpoint-aware
    schedule buys. ``reissue`` prices the spare-stream straggler
    mitigation on all transfer tasks, snapshot flushes included.
    ``retry``/``faults`` price a deterministic ``FaultPlan`` with
    bounded-retry semantics (see ``simulate``).

    ``rates`` (a ``RateController``) replays per-unit adaptive encode
    rates with exact heterogeneous wire pricing — pass a finished
    run's controller to price the rate schedule it actually used, or a
    candidate controller to let the timeline search rate schedules offline
    (see ``build_sweep_tasks``)."""
    return simulate(
        build_sweep_tasks(
            cfg, sweeps=sweeps, schedule=schedule,
            cache_bytes=cache_bytes, stats=stats, policy=policy,
            ckpt_every=ckpt_every, ckpt_mode=ckpt_mode, rates=rates,
        ), hw, reissue=reissue, retry=retry, faults=faults,
    )


def sharded_timeline(
    cfg, hw: Hardware, nshards: int, sweeps: int = 1,
    schedule: Union[str, Schedule] = "depth2",
    cache_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
    faults: Optional[FaultPlan] = None,
    retry: Optional[RetryPolicy] = None,
) -> Timeline:
    """Replay a ``nshards``-device sharded run on the timeline.

    Each shard owns a private three-stream pipeline — resources are
    namespaced ``s{d}:h2d`` / ``s{d}:compute`` / ``s{d}:d2h`` /
    ``s{d}:halo`` — so shards advance concurrently and the per-sweep
    makespan drops toward ``1/nshards`` of ``sweep_timeline``'s. The
    inter-device links carry the two halo flows per internal boundary
    per rw field per round: the raw held slices (left -> right,
    hazard-edged against the boundary-common writeback chain only, so
    the downstream shard's interior work pipelines past the wait) and
    the ZFP-encoded boundary-common unit (right -> left, priced at the
    encoded wire size ``exact_nbytes`` — the same bytes the live
    ``ShardedExecutor`` ships). ``stats["per_device"]`` receives each
    shard's modeled residency counters; transfer parity with the live
    engine holds transfer for transfer at every ``cache_bytes`` budget.
    """
    return simulate(
        build_sharded_tasks(
            cfg, nshards, sweeps=sweeps, schedule=schedule,
            cache_bytes=cache_bytes, stats=stats, policy=policy,
        ), hw, retry=retry, faults=faults,
    )


def tenant_timeline(
    tenants, hw: Hardware,
    budget_bytes: int = 0,
    stats: Optional[Dict[str, object]] = None,
    policy: str = "write-back",
) -> Timeline:
    """Replay a multi-tenant run on the timeline: N independent runs (a
    ``core.tenancy.TenantSpec`` sequence) interleaved in
    ``tenancy.interleave_rounds`` order onto one shared three-stream
    pipeline and one arbiter-managed residency budget, the run the live
    ``serving.ooc.TenantScheduler`` makes. Against the sum of each
    tenant's solo ``sweep_timeline`` it prices the overlap interleaving
    buys (one tenant's stencils hide another's wire time).
    ``stats["per_tenant"]`` receives each tenant's modelled residency
    counters and peak bytes."""
    return simulate(
        build_tenant_tasks(
            tenants, budget_bytes=budget_bytes, stats=stats,
            policy=policy,
        ), hw,
    )

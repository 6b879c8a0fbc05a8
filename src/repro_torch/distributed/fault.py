"""Fault tolerance & straggler mitigation (cluster-control plane).

No real cluster exists in this container, so this module implements the
*logic* — heartbeat tracking, straggler detection, elastic replanning,
deterministic fault injection, retry/backoff policies — with
deterministic unit tests (tests/test_fault.py, tests/test_chaos.py) and
hooks used by the out-of-core engines and the training launcher:

  * ``HeartbeatMonitor``: per-worker progress tracking; flags workers
    slower than ``threshold`` x the rolling median step time — both
    from their step-time history and from going *silent* (no beat for
    longer than the threshold) — and dead workers after ``dead_after``
    missed beats.
  * ``ElasticPlan``: given the healthy-device count, picks the largest
    (data, model) mesh <= available that keeps model parallelism and
    divides the global batch — checkpoint ``place()`` then resumes on
    the degraded mesh (restore is mesh-agnostic by design).
  * ``FaultPlan`` / ``FaultInjector``: a seeded, *stateless* schedule
    of injected faults (transfer failures, payload bit-corruption,
    straggling puts, shard-write failures, process-crash points) keyed
    by transfer *identity* — ``(op, field, unit, version, attempt)`` —
    so the same plan replays identically in the live engine
    (``HostUnitStore`` / ``AsyncExecutor`` / ``ShardWriter`` hooks) and
    in the DES (``pipeline.simulate(..., faults=plan)``), regardless of
    issue order.
  * ``RetryPolicy``: bounded attempts + exponential backoff + a
    ``factor`` x expected-duration straggler deadline, applied to every
    H2D/D2H link crossing by the store and priced by the DES so model
    and live agree on the retry-attempt multiset under the same plan.
    ``ReissuePolicy`` is the legacy name, kept as a thin
    subclass: single spare-stream reissue == two bounded attempts.
"""

from __future__ import annotations

import dataclasses
import random
import statistics
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "WorkerState", "HeartbeatMonitor", "ElasticPlan", "replan",
    "RetryPolicy", "ReissuePolicy", "FaultSpec", "FaultPlan",
    "FaultInjector", "FaultError", "InjectedFault", "InjectedCrash",
    "ChecksumError", "UnrecoverableFault", "FAULT_KINDS",
]


# ----------------------------------------------------------------------
# fault taxonomy
# ----------------------------------------------------------------------
class FaultError(RuntimeError):
    """Base of every fault raised by the self-healing layer."""


class InjectedFault(FaultError):
    """A single injected transfer / shard-write failure (recoverable:
    the retry loop absorbs it while attempts remain)."""


class InjectedCrash(FaultError):
    """A process-crash point fired at a sweep boundary. Unrecoverable
    in-process: only ``RecoveryPolicy`` rollback-and-replay survives
    it."""


class ChecksumError(FaultError):
    """Integrity verification failed: the payload that arrived does not
    match the checksum recorded when the unit was committed. Raised
    *before* the corrupted bytes can reach a stencil step."""


class UnrecoverableFault(FaultError):
    """The retry budget is exhausted (or there is no valid source to
    retry from). ``AsyncExecutor.run(..., recovery=...)`` answers this
    by rolling back to the last published checkpoint."""


@dataclasses.dataclass
class WorkerState:
    last_step: int = -1
    last_beat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, workers: int, *, straggler_factor: float = 2.0,
                 dead_after: float = 60.0):
        self.workers = {i: WorkerState() for i in range(workers)}
        self.factor = straggler_factor
        self.dead_after = dead_after

    def beat(self, worker: int, step: int, now: float) -> None:
        w = self.workers[worker]
        if w.last_step >= 0 and step > w.last_step:
            dt = (now - w.last_beat) / max(1, step - w.last_step)
            w.step_times.append(dt)
            if len(w.step_times) > 32:
                w.step_times.pop(0)
        w.last_step, w.last_beat = step, now

    def median_step_time(self) -> Optional[float]:
        times = [
            statistics.median(w.step_times)
            for w in self.workers.values()
            if w.step_times
        ]
        return statistics.median(times) if times else None

    def stragglers(self, now: float) -> List[int]:
        """Workers running slower than ``factor`` x the fleet median.

        Two ways to straggle: a step-time *history* above the
        threshold (independent of ``now`` — a recorded slow cadence is
        a slow cadence), or going *silent* — last beat more than
        ``factor * median`` ago (``now`` matters: a worker that stopped
        beating entirely has a clean history and would otherwise never
        be flagged until ``dead()``). Silence past ``dead_after`` is
        the dead list's business, not this one's — the silent window is
        ``(factor * median, dead_after]``, so the two windows compose
        instead of double-reporting.
        """
        med = self.median_step_time()
        if med is None:
            return []
        out = []
        for i, w in self.workers.items():
            slow_history = w.step_times and statistics.median(
                w.step_times
            ) > self.factor * med
            quiet = now - w.last_beat if w.last_beat > 0 else 0.0
            silent = self.factor * med < quiet <= self.dead_after
            if slow_history or silent:
                out.append(i)
        return out

    def dead(self, now: float) -> List[int]:
        return [
            i
            for i, w in self.workers.items()
            if w.last_beat and now - w.last_beat > self.dead_after
        ]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def replan(
    healthy_devices: int, *, model_parallel: int, global_batch: int
) -> ElasticPlan:
    """Largest usable mesh on the surviving devices: model parallelism
    is fixed (weights must fit), the data axis shrinks to the largest
    divisor of global_batch that fits."""
    assert healthy_devices >= model_parallel, "cannot fit the model"
    max_data = healthy_devices // model_parallel
    data = max(
        d for d in range(1, max_data + 1) if global_batch % d == 0
    )
    return ElasticPlan(data, model_parallel)


# ----------------------------------------------------------------------
# retry / timeout / backoff
# ----------------------------------------------------------------------
@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff for link crossings.

    Applied by ``HostUnitStore`` to *every* H2D/D2H transfer and by
    ``ShardWriter`` to checkpoint shard writes: an injected transfer
    failure or a checksum mismatch on attempt ``a < attempts - 1`` is
    retried after ``backoff(a + 1)`` seconds (accounted, not slept —
    the DES prices the same gaps); exhausting ``attempts`` raises
    ``UnrecoverableFault``. ``factor`` keeps the straggler
    deadline: a transfer past ``factor`` x its expected duration is
    declared straggling (live: counted + reissued on the flush path;
    DES: cancel-and-reissue on the spare stream).

    * ``attempts`` — total tries per crossing (first + retries), >= 1;
    * ``backoff_s`` — delay before the first retry; retry ``n`` waits
      ``backoff_s * backoff_factor**(n-1)`` (0 = immediate, the test
      default: faults are logical, not temporal);
    * ``deadline_s`` — optional absolute per-transfer deadline: if the
      expected duration already exceeds it, the transfer is straggling
      from the start (DES reissues at the deadline).
    """

    factor: float = 3.0
    attempts: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        assert self.attempts >= 1, self.attempts

    def backoff(self, retry: int) -> float:
        """Delay (seconds) before retry number ``retry`` (1-based)."""
        if retry <= 0 or not self.backoff_s:
            return 0.0
        return self.backoff_s * self.backoff_factor ** (retry - 1)

    def should_reissue(self, elapsed: float, expected: float) -> bool:
        return elapsed > self.deadline(expected)

    def deadline(self, expected: float) -> float:
        """Elapsed time at which a task with ``expected`` duration is
        declared straggling and its reissue is launched."""
        d = self.factor * expected
        if self.deadline_s is not None:
            d = min(d, self.deadline_s)
        return d


@dataclasses.dataclass
class ReissuePolicy(RetryPolicy):
    """Legacy name for the flush-path policy: one spare-stream
    reissue == two bounded attempts. Kept as a ``RetryPolicy`` so old
    call sites (``AsyncExecutor(..., reissue=ReissuePolicy())``,
    ``pipeline.simulate(..., reissue=...)``) pick up the generalized
    retry semantics unchanged."""

    attempts: int = 2


# ----------------------------------------------------------------------
# deterministic fault injection
# ----------------------------------------------------------------------
FAULT_KINDS = ("transfer", "corrupt", "straggle", "shard", "crash")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``"*"`` / ``-1`` are wildcards.

    * ``transfer`` — the matching crossing's first ``attempts`` tries
      raise ``InjectedFault``;
    * ``corrupt`` — the payload is bit-flipped in flight on the first
      ``attempts`` tries (detected by checksum verification);
    * ``straggle`` — the matching crossing runs ``factor`` x slow
      (live: counted; DES: priced / reissued);
    * ``shard`` — the matching unit's checkpoint shard write fails on
      the first ``attempts`` tries;
    * ``crash`` — the process dies at the boundary after sweep
      ``sweep`` completes (fires once per injector).
    """

    kind: str
    op: str = "*"          # "h2d" | "d2h" | "*"
    field: str = "*"
    unit: str = "*"        # "R0", "C1", ... (kind+idx)
    version: int = -1      # -1 = any
    attempts: int = 1      # how many leading attempts fault
    factor: float = 8.0    # straggle slowdown
    sweep: int = -1        # crash boundary (after this many sweeps)

    def __post_init__(self):
        assert self.kind in FAULT_KINDS, self.kind

    def matches(self, op: str, field: str, unit: str,
                version: int) -> bool:
        return (
            self.op in ("*", op)
            and self.field in ("*", field)
            and self.unit in ("*", unit)
            and self.version in (-1, int(version))
        )


class FaultPlan:
    """A deterministic, order-independent schedule of faults.

    Decisions are pure functions of transfer *identity* — never of
    issue order — so the live engine (which defers and reorders D2H
    materialization) and the DES (which prices the graph) see the same
    fault on the same logical transfer. Two modes, composable:

    * explicit ``specs`` (targeted tests, the bench recovery row);
    * seeded probabilistic: each identity is hashed with ``seed`` into
      a uniform [0, 1) draw compared against ``p_transfer`` /
      ``p_corrupt`` / ``p_straggle`` / ``p_shard`` / ``p_crash``
      (chaos tier).
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        *,
        seed: Optional[int] = None,
        p_transfer: float = 0.0,
        p_corrupt: float = 0.0,
        p_straggle: float = 0.0,
        p_shard: float = 0.0,
        p_crash: float = 0.0,
        straggle_factor: float = 8.0,
    ):
        self.specs = tuple(specs)
        self.seed = seed
        self.p_transfer = p_transfer
        self.p_corrupt = p_corrupt
        self.p_straggle = p_straggle
        self.p_shard = p_shard
        self.p_crash = p_crash
        self.straggle_factor = straggle_factor

    # -- deterministic uniform draw per identity -----------------------
    def _u(self, *key: object) -> float:
        h = zlib.crc32(repr((self.seed,) + key).encode())
        return h / 2**32

    def _probabilistic(self) -> bool:
        return self.seed is not None

    # -- decisions -----------------------------------------------------
    def decide(self, op: str, field: str, unit: str, version: int,
               attempt: int) -> Optional[str]:
        """Fault kind for one attempt of one transfer: ``"transfer"``
        (fail), ``"corrupt"`` (bit-flip in flight), or ``None``."""
        for s in self.specs:
            if (
                s.kind in ("transfer", "corrupt")
                and s.matches(op, field, unit, version)
                and attempt < s.attempts
            ):
                return s.kind
        if self._probabilistic():
            if self._u("t", op, field, unit, version,
                       attempt) < self.p_transfer:
                return "transfer"
            if self._u("c", op, field, unit, version,
                       attempt) < self.p_corrupt:
                return "corrupt"
        return None

    def straggle(self, op: str, field: str, unit: str,
                 version: int) -> float:
        """Slowdown factor for one transfer (1.0 = on time)."""
        for s in self.specs:
            if s.kind == "straggle" and s.matches(op, field, unit, version):
                return s.factor
        if self._probabilistic() and self._u(
            "s", op, field, unit, version
        ) < self.p_straggle:
            return self.straggle_factor
        return 1.0

    def shard_fault(self, key: str, attempt: int) -> bool:
        """Whether writing checkpoint shard ``key`` fails on
        ``attempt``."""
        for s in self.specs:
            if s.kind == "shard" and attempt < s.attempts and (
                s.unit == "*" or s.unit in key
            ) and (s.field == "*" or key.startswith(s.field + ".")):
                return True
        return self._probabilistic() and self._u(
            "w", key, attempt
        ) < self.p_shard

    def crash_at(self, sweep: int) -> bool:
        """Whether a crash point is scheduled at the boundary after
        ``sweep`` completed sweeps. (The injector fires each point at
        most once — a replay must get past it.)"""
        for s in self.specs:
            if s.kind == "crash" and s.sweep == int(sweep):
                return True
        return self._probabilistic() and self._u(
            "x", int(sweep)
        ) < self.p_crash

    # -- seeded single/multi-fault sampling ----------------------------
    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        fields: Sequence[str],
        units: Sequence[str],
        sweeps: int,
        faults: int = 1,
        kinds: Sequence[str] = FAULT_KINDS,
    ) -> "FaultPlan":
        """Sample ``faults`` concrete specs from ``seed`` — the chaos
        tier's "any single injected fault" generator. Transfer/corrupt
        specs fault at most 2 leading attempts so the default
        ``RetryPolicy(attempts=3)`` keeps them survivable."""
        rng = random.Random(seed)
        specs: List[FaultSpec] = []
        for _ in range(faults):
            kind = rng.choice(list(kinds))
            if kind == "crash":
                specs.append(FaultSpec(
                    kind="crash", sweep=rng.randrange(1, max(2, sweeps))
                ))
            elif kind == "shard":
                specs.append(FaultSpec(
                    kind="shard", field=rng.choice(list(fields)),
                    unit=rng.choice(list(units)),
                ))
            elif kind == "straggle":
                specs.append(FaultSpec(
                    kind="straggle", op=rng.choice(["h2d", "d2h"]),
                    field=rng.choice(list(fields)),
                    unit=rng.choice(list(units)),
                    factor=rng.uniform(2.0, 10.0),
                ))
            else:
                specs.append(FaultSpec(
                    kind=kind, op=rng.choice(["h2d", "d2h"]),
                    field=rng.choice(list(fields)),
                    unit=rng.choice(list(units)),
                    attempts=rng.choice([1, 2]),
                ))
        return cls(specs)


class FaultInjector:
    """The stateful end of a ``FaultPlan``: counts what fired, owns the
    deterministic bit-flip, and guarantees each crash point fires at
    most once (so rollback-and-replay gets *past* the crash instead of
    looping on it). One injector per engine instance; share the plan,
    not the injector, between live and model."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {
            "transfer_faults": 0, "corruptions": 0, "straggles": 0,
            "shard_faults": 0, "crashes": 0,
        }
        self._crash_fired: set = set()

    # -- transfers -----------------------------------------------------
    def transfer_fault(self, op: str, field: str, unit: str,
                       version: int, attempt: int) -> Optional[str]:
        kind = self.plan.decide(op, field, unit, version, attempt)
        if kind == "transfer":
            self.counts["transfer_faults"] += 1
        elif kind == "corrupt":
            self.counts["corruptions"] += 1
        return kind

    def straggle(self, op: str, field: str, unit: str,
                 version: int) -> float:
        f = self.plan.straggle(op, field, unit, version)
        if f > 1.0:
            self.counts["straggles"] += 1
        return f

    # -- checkpoint shards ---------------------------------------------
    def shard_fault(self, key: str, attempt: int) -> bool:
        if self.plan.shard_fault(key, attempt):
            self.counts["shard_faults"] += 1
            return True
        return False

    # -- crash points --------------------------------------------------
    def crash_point(self, sweep: int) -> bool:
        if sweep in self._crash_fired:
            return False
        if self.plan.crash_at(sweep):
            self._crash_fired.add(sweep)
            self.counts["crashes"] += 1
            return True
        return False

    # -- the wire-corruption primitive ---------------------------------
    @staticmethod
    def corrupt(arr):
        """Deterministic in-flight corruption: flip one bit in the
        middle byte of a *copy* of ``arr`` (the original buffer — the
        retry's source of truth — is never touched)."""
        import numpy as np

        a = np.asarray(arr)
        if a.nbytes == 0:
            return a
        buf = np.frombuffer(a.tobytes(), dtype=np.uint8).copy()
        buf[len(buf) // 2] ^= 0x01
        return np.frombuffer(buf.tobytes(), dtype=a.dtype).reshape(a.shape)

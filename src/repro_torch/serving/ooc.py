"""Multi-tenant out-of-core serving: N stencil runs, one device.

Port of ``repro.serving.ooc``. ``TenantScheduler`` runs N independent
``AsyncExecutor`` runs, each with its own ``OOCConfig``, schedule, host
store, streams, pinned pool and host threads (and, optionally, a fault
injector and a recovery policy), on one device and one shared,
arbiter-managed ``DeviceResidencyManager`` (the policy is in
``core.tenancy`` and ``core.unitcache``):

* **admission**: ``submit`` grants each tenant a hard byte reserve (by
  default its working set, so a latency tenant's residency can never be
  stolen). A reserve the unreserved budget cannot cover is rejected
  (``AdmissionError``) or queued (``admission="queue"``) until running
  tenants retire.
* **interleave**: ``run`` drives each tenant one temporal round at a
  time (``AsyncExecutor.advance_round``) in ``tenancy.interleave_rounds``
  order, the order ``taskgraph.build_tenant_tasks`` replays, so each
  tenant's transfers equal its tasks in the merged graph.
* **cross-tenant flushes**: when tenant A's deposit evicts tenant B's
  dirty resident, the handback goes to B's executor, which writes the
  payload to B's own host store through B's d2h stream and pool, and
  logs the flush at B's sweep count.
* **per-tenant checkpoint cuts**: ``checkpoint_tenant`` drains and
  flushes only one tenant's namespace while the others keep their
  residency; pins and shadows never cross tenants.
* **fault isolation**: a tenant submitted with a ``RecoveryPolicy``
  rolls back alone (``TenantView.rollback_reset`` drops only its own
  residency); no other tenant restarts.

On the CUDA device every tenant's executor launches the codec and
stencil kernels on its own streams; ``device="cpu"`` runs the plain
versions.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.executor import AsyncExecutor, RecoveryPolicy
from repro_torch.core.tenancy import (
    AdmissionError,
    TenantSpec,
    TenantView,
    interleave_rounds,
    working_set_bytes,
)
from repro_torch.core.unitcache import (
    DeviceResidencyManager,
    Entry,
    ResidencyArbiter,
)
from repro_torch.distributed.fault import FaultError, FaultInjector, \
    RetryPolicy

__all__ = [
    "AdmissionError",
    "TenantRun",
    "TenantScheduler",
]


@dataclass
class TenantRun:
    """One admitted tenant: its spec, its live executor and its state."""

    spec: TenantSpec
    executor: AsyncExecutor
    recovery: Optional[RecoveryPolicy] = None
    restarts: int = 0
    done: bool = False  # reached its sweep target (window drained)
    retired: bool = False  # residency dropped, reserve revoked


class TenantScheduler:
    """N out-of-core runs on one device under one shared residency
    budget, arbitrated by quota and priority. Each tenant's executor is
    built with ``residency=TenantView(shared_manager, name, router=...)``;
    the executors are otherwise the single-run engine.

    ``device`` goes into each tenant's ``OOCConfig`` where the config
    names none (``"cpu"`` also selects the plain versions,
    ``backend="ref"``); ``None`` leaves each config as it is, which runs
    on the CUDA device unless the config says otherwise."""

    def __init__(self, budget_bytes: int, policy: str = "write-back",
                 admission: str = "reject", device=None):
        if admission not in ("reject", "queue"):
            raise ValueError(
                f"unknown admission mode {admission!r}; "
                "expected 'reject' or 'queue'"
            )
        self.budget_bytes = int(budget_bytes)
        self.policy = policy
        self.admission = admission
        self.device = device
        self.arbiter = ResidencyArbiter()
        self.manager = DeviceResidencyManager(
            self.budget_bytes, policy=policy, arbiter=self.arbiter
        )
        self.tenants: "OrderedDict[str, TenantRun]" = OrderedDict()
        self.waiting: List[Dict[str, object]] = []

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def unreserved_bytes(self) -> int:
        return self.budget_bytes - self.arbiter.reserved_total()

    def submit(
        self,
        name: str,
        cfg,
        p_prev: np.ndarray,
        p_cur: np.ndarray,
        vel2: np.ndarray,
        *,
        schedule: str = "depth2",
        sweeps: int = 1,
        reserve: Optional[int] = None,
        priority: int = 0,
        require_fit: bool = False,
        retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        recovery: Optional[RecoveryPolicy] = None,
    ) -> str:
        """Admit or queue a tenant; returns ``"admitted"`` or
        ``"queued"``.

        ``reserve=None`` reserves the tenant's working set
        (``tenancy.working_set_bytes``), the latency-class default; a
        smaller reserve makes a batch tenant that leans on slack.
        ``require_fit=True`` also rejects a tenant whose working set
        exceeds its reserve. A reserve the unreserved budget cannot
        cover raises ``AdmissionError`` under ``admission="reject"`` or
        waits under ``admission="queue"`` until running tenants
        retire."""
        if name in self.tenants or any(
            w["name"] == name for w in self.waiting
        ):
            raise ValueError(f"duplicate tenant {name!r}")
        if self.device is not None and cfg.device is None:
            cpu = str(self.device) == "cpu"
            cfg = dataclasses.replace(
                cfg, device=str(self.device),
                backend="ref" if cpu else cfg.backend,
            )
        ws = working_set_bytes(cfg, schedule)
        if reserve is None:
            reserve = ws
        reserve = int(reserve)
        if require_fit and ws > reserve:
            raise AdmissionError(
                f"tenant {name!r}: working set {ws} bytes does not fit "
                f"its reserve {reserve}"
            )
        sub: Dict[str, object] = {
            "name": name, "cfg": cfg,
            "fields": (p_prev, p_cur, vel2),
            "schedule": schedule, "sweeps": int(sweeps),
            "reserve": reserve, "priority": int(priority),
            "retry": retry, "injector": injector, "recovery": recovery,
        }
        if reserve > self.unreserved_bytes():
            if self.admission == "queue":
                self.waiting.append(sub)
                return "queued"
            raise AdmissionError(
                f"tenant {name!r}: reserve {reserve} bytes exceeds the "
                f"unreserved budget {self.unreserved_bytes()} "
                f"(budget {self.budget_bytes}, reserved "
                f"{self.arbiter.reserved_total()})"
            )
        self._admit(sub)
        return "admitted"

    def _admit(self, sub: Dict[str, object]) -> None:
        name = sub["name"]
        self.arbiter.grant(name, sub["reserve"], sub["priority"])
        view = TenantView(self.manager, name, router=self._route_flush)
        p_prev, p_cur, vel2 = sub["fields"]
        ex = AsyncExecutor(
            sub["cfg"], p_prev, p_cur, vel2,
            schedule=sub["schedule"], retry=sub["retry"],
            injector=sub["injector"], residency=view,
        )
        spec = TenantSpec(
            name, sub["cfg"], sub["schedule"], sub["sweeps"],
            sub["reserve"], sub["priority"],
        )
        run = TenantRun(spec, ex, recovery=sub["recovery"])
        self.tenants[name] = run
        rec = run.recovery
        if rec is not None and ckpt.latest(rec.directory) is None:
            # a rollback needs a last good state to roll back to
            ex.checkpoint(
                rec.directory, zstd_level=rec.zstd_level, keep=rec.keep
            )

    def _admit_waiting(self) -> int:
        admitted = 0
        still: List[Dict[str, object]] = []
        for sub in self.waiting:
            if sub["reserve"] <= self.unreserved_bytes():
                self._admit(sub)
                admitted += 1
            else:
                still.append(sub)
        self.waiting = still
        return admitted

    # ------------------------------------------------------------------
    # the interleaved run loop
    # ------------------------------------------------------------------
    def _route_flush(self, tenant: str, key: Hashable, ent: Entry) -> None:
        """Cross-tenant flush-on-evict: the victim tenant's executor
        writes its own dirty payload to its own host store (and logs the
        flush at its own sweep count)."""
        self.tenants[tenant].executor._flush_entry(key, ent, -1)

    def _recover(self, run: TenantRun, exc: FaultError) -> None:
        rec = run.recovery
        if (
            rec is None
            or run.restarts >= rec.max_restarts
            or ckpt.latest(rec.directory) is None
        ):
            raise exc
        run.restarts += 1
        # the view's rollback_reset drops only this tenant's residency
        run.executor._rollback(rec.directory, exc)

    def run(self) -> None:
        """Drive every admitted tenant to its sweep target, one temporal
        round a turn in ``interleave_rounds`` order (the sequence
        ``build_tenant_tasks`` replays). A faulting tenant with a
        recovery policy rolls back alone and replays its missing rounds
        before the interleave moves on. With submissions queued, the
        finished tenants then retire (flush and reserve handback) and
        the queue is admitted in order for the next wave."""
        while True:
            active = [r for r in self.tenants.values() if not r.done]
            if active:
                for tname, s, kr in interleave_rounds(
                    [r.spec for r in active]
                ):
                    run = self.tenants[tname]
                    target = s + kr
                    while run.executor.sweeps_done < target:
                        try:
                            run.executor.advance_round(target)
                        except FaultError as e:
                            self._recover(run, e)
                for run in active:
                    run.executor.finish()
                    run.done = True
            if not self.waiting:
                return
            for run in list(self.tenants.values()):
                if run.done and not run.retired:
                    self.retire(run.spec.name)
            if not self._admit_waiting():
                raise AdmissionError(
                    "queued tenants can never be admitted: "
                    f"{[w['name'] for w in self.waiting]} need more "
                    f"reserve than the budget frees"
                )

    def retire(self, name: str) -> None:
        """Release a finished tenant's device footprint: drain its
        window, flush its dirty residents to its host store, drop its
        entries and shadows from the shared manager and give its reserve
        back. The ``TenantRun`` and its host store stay for ``gather``."""
        run = self.tenants[name]
        run.executor.finish()
        run.executor.flush()
        self.manager.drop_tenant(name)
        self.arbiter.revoke(name)
        run.retired = True

    def close(self) -> None:
        """Stop every tenant's host threads (the stores stay readable)."""
        for run in self.tenants.values():
            run.executor.close()

    # ------------------------------------------------------------------
    # per-tenant operations
    # ------------------------------------------------------------------
    def checkpoint_tenant(self, name: str, directory: str, **kw) -> str:
        """Quiesced checkpoint of one tenant: drains its window and
        flushes its dirty residents (its namespace only) while every
        other tenant keeps its residency. Returns the path; restore with
        ``AsyncExecutor.restore`` as a solo run."""
        return self.tenants[name].executor.checkpoint(directory, **kw)

    def gather(self, name: str, fieldname: str) -> np.ndarray:
        return self.tenants[name].executor.gather(fieldname)

    def transfers(self, name: str):
        return self.tenants[name].executor.transfers

    def specs(self) -> List[TenantSpec]:
        """The admitted tenants' specs in admission order, for
        ``taskgraph.build_tenant_tasks`` and
        ``pipeline.tenant_timeline``."""
        return [r.spec for r in self.tenants.values()]

    def stats(self) -> Dict[str, object]:
        """Shared-manager counters and each tenant's breakdown
        (residency, quota, progress)."""
        out: Dict[str, object] = {
            "budget_bytes": self.budget_bytes,
            "policy": self.policy,
            "bytes_used": self.manager.bytes_used,
            "peak_bytes": self.manager.peak_bytes,
            "reserved_bytes": self.arbiter.reserved_total(),
            "shared": self.manager.stats.as_dict(),
        }
        per: Dict[str, Dict[str, object]] = {}
        for name, run in self.tenants.items():
            d = self.manager.tenant_stats_for(name).as_dict()
            d.update({
                "bytes_used": self.manager.tenant_bytes.get(name, 0),
                "peak_bytes": self.manager.tenant_peak.get(name, 0),
                "reserve": run.spec.reserve,
                "priority": run.spec.priority,
                "sweeps_done": run.executor.sweeps_done,
                "restarts": run.restarts,
                "retired": run.retired,
            })
            per[name] = d
        out["per_tenant"] = per
        return out

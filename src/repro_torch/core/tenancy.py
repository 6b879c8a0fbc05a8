"""Multi-tenant residency: N out-of-core runs, one device, one budget.

Port of ``repro.core.tenancy``, plain Python like the reference. N
independent runs, each with its own ``OOCConfig``, schedule and host
store, share one device and one arbiter-managed
``unitcache.DeviceResidencyManager``:

* ``unitcache.ResidencyArbiter`` (with ``TenantQuota``) holds each
  tenant's hard byte *reserve*, which no other tenant's deposit may
  evict below, and its *priority*, which orders victims;
* ``TenantView`` is the facade a tenant's ``AsyncExecutor`` takes as
  ``residency=`` in place of a private manager: every key becomes
  ``(tenant, unit_key)``, stats read the tenant's own ``CacheStats``,
  and an eviction flush of another tenant's dirty payload goes to that
  tenant's executor through a router (the victim writes its own payload
  to its own host store);
* ``interleave_rounds`` is the global round order that both the live
  ``serving.ooc.TenantScheduler`` and ``taskgraph.build_tenant_tasks``
  walk, so each tenant's live transfers equal its tasks in the merged
  graph.

Checkpoint cuts are per tenant: pins and copy-on-write shadows key on
the namespaced keys, so one tenant's cut freezes only its own versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Hashable, List, Optional, Tuple

from repro_torch.core.taskgraph import get_schedule, unit_wire_bytes
from repro_torch.core.unitcache import (
    DepositResult,
    DeviceResidencyManager,
    Entry,
)


class AdmissionError(RuntimeError):
    """A tenant could not be admitted: its reserve does not fit the
    unreserved budget (or, with ``require_fit``, its working set does
    not fit its reserve)."""


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's static contract, shared by the live scheduler and
    the graph builder."""

    name: str
    cfg: Any  # OOCConfig
    schedule: str = "depth2"
    sweeps: int = 1
    reserve: int = 0
    priority: int = 0


def interleave_rounds(tenants) -> List[Tuple[str, int, int]]:
    """The global round order: round-robin in submission order, each
    turn advancing one temporal round ``kr = min(k, remaining)``;
    finished tenants drop out. Returns ``(name, start_sweep, kr)``
    triples, ``start_sweep`` being the tenant's ``sweeps_done`` when it
    issues that round's fetches.

    >>> a = TenantSpec("a", None, "temporal2", sweeps=3)
    >>> b = TenantSpec("b", None, "unitgrain", sweeps=2)
    >>> interleave_rounds([a, b])
    [('a', 0, 2), ('b', 0, 1), ('a', 2, 1), ('b', 1, 1)]
    """
    temporal = {t.name: get_schedule(t.schedule).temporal for t in tenants}
    total = {t.name: int(t.sweeps) for t in tenants}
    done = {t.name: 0 for t in tenants}
    order = [t.name for t in tenants]
    out: List[Tuple[str, int, int]] = []
    while any(done[n] < total[n] for n in order):
        for n in order:
            if done[n] >= total[n]:
                continue
            kr = min(temporal[n], total[n] - done[n])
            out.append((n, done[n], kr))
            done[n] += kr
    return out


def working_set_bytes(cfg, schedule: str = "unitgrain") -> int:
    """A tenant's steady-state residency footprint: the wire bytes of
    every writeback unit of its rw fields (dirty deposits) and every
    fetch unit of its read-only fields, all resident at once. The
    natural ``reserve`` of a latency tenant, and the admission
    yardstick."""
    sched = get_schedule(schedule)
    plan = cfg.temporal_plan(sched.temporal)
    _, y, x = cfg.shape
    itemsize = 4 if cfg.dtype == "float32" else 8
    total = 0
    for spec in cfg.fields.values():
        units = set()
        for i in range(plan.ndiv):
            if spec.role == "rw":
                units.update(plan.writeback_units(i))
            else:
                units.update(plan.fetch_units(i))
        for kind, idx in units:
            lo, hi = plan.remainder(idx) if kind == "R" else plan.common(idx)
            total += unit_wire_bytes(spec, (hi - lo, y, x), itemsize)
    return total


# (victim tenant, unit key, entry) -> None: writes the victim's dirty
# payload to the victim's host store
FlushRouter = Callable[[str, Hashable, Entry], None]


class TenantView:
    """One tenant's window onto the shared residency manager.

    It has the whole surface ``AsyncExecutor`` uses of ``self.cache``,
    so an executor built with ``residency=view`` needs no other change.
    Keys are namespaced ``(tenant, key)``; gauges and stats read the
    tenant's own breakdown; flush handbacks of deposits and releases are
    split: this tenant's come back to its executor, another tenant's go
    through ``router`` to the victim's executor. Without a router a
    cross-tenant eviction raises: flushing B's payload through A's store
    would corrupt both.
    """

    def __init__(self, manager: DeviceResidencyManager, tenant: str,
                 router: Optional[FlushRouter] = None):
        if manager.arbiter is None:
            raise ValueError("TenantView needs an arbiter-managed manager")
        self.manager = manager
        self.tenant = tenant
        self.router = router
        self.stats = manager.tenant_stats_for(tenant)

    # -- configuration and gauges ---------------------------------------
    @property
    def budget_bytes(self) -> int:
        return self.manager.budget_bytes

    @property
    def policy(self) -> str:
        return self.manager.policy

    @property
    def enabled(self) -> bool:
        return self.manager.enabled

    @property
    def write_back(self) -> bool:
        return self.manager.write_back

    @property
    def bytes_used(self) -> int:
        return self.manager.tenant_bytes.get(self.tenant, 0)

    @property
    def peak_bytes(self) -> int:
        return self.manager.tenant_peak.get(self.tenant, 0)

    @property
    def dirty_bytes(self) -> int:
        return self.stats.dirty_bytes

    # -- namespacing -----------------------------------------------------
    def _key(self, key: Hashable) -> Tuple[str, Hashable]:
        return (self.tenant, key)

    def _split(self, flushes) -> List[Tuple[Hashable, Entry]]:
        """This tenant's flush handbacks, keys un-namespaced; another
        tenant's are routed to the victim's executor."""
        own: List[Tuple[Hashable, Entry]] = []
        for (owner, inner), ent in flushes:
            if owner == self.tenant:
                own.append((inner, ent))
            elif self.router is not None:
                self.router(owner, inner, ent)
            else:
                raise RuntimeError(
                    f"cross-tenant eviction flush for {owner!r} with no "
                    "router: the victim's payload has nowhere to go"
                )
        return own

    # -- the manager surface the executor drives -------------------------
    def lookup(self, key: Hashable, version: int):
        return self.manager.lookup(self._key(key), version)

    def peek(self, key: Hashable) -> Optional[Entry]:
        return self.manager.peek(self._key(key))

    def deposit(self, key: Hashable, version: int, value: Any, nbytes: int,
                dirty: bool = False, bumps: int = 0,
                rate: Optional[str] = None) -> DepositResult:
        res = self.manager.deposit(self._key(key), version, value, nbytes,
                                   dirty=dirty, bumps=bumps, rate=rate)
        return DepositResult(res.stored, self._split(res.flushes))

    def dirty_entries(self) -> List[Tuple[Hashable, Entry]]:
        return [(inner, e)
                for (owner, inner), e in self.manager.dirty_entries()
                if owner == self.tenant]

    def mark_flushed(self, key: Hashable) -> None:
        self.manager.mark_flushed(self._key(key))

    def note_d2h_elided(self, nbytes: int) -> None:
        self.manager.note_d2h_elided(nbytes, tenant=self.tenant)

    def pin(self, key: Hashable) -> Optional[Entry]:
        return self.manager.pin(self._key(key))

    def pinned_entry(self, key: Hashable) -> Optional[Entry]:
        return self.manager.pinned_entry(self._key(key))

    def release(self, key: Hashable) -> List[Tuple[Hashable, Entry]]:
        return self._split(self.manager.release(self._key(key)))

    def pinned_keys(self) -> List[Hashable]:
        return [inner for owner, inner in self.manager.pinned_keys()
                if owner == self.tenant]

    def note_ckpt_flush(self, nbytes: int) -> None:
        self.manager.note_ckpt_flush(nbytes, tenant=self.tenant)

    def rollback_reset(self) -> "TenantView":
        """A crash rollback of this tenant alone: its entries and shadows
        leave the shared manager, and its gauges reset as
        ``DeviceResidencyManager.rollback_reset`` resets a private
        manager's (the counters survive). Every other tenant's entries,
        pins and stats stay as they were."""
        self.manager.drop_tenant(self.tenant)
        self.stats.dirty_bytes = 0
        self.stats.pinned_bytes = 0
        self.stats.rate_bytes = {}
        return self

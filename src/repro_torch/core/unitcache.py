"""Device residency manager: dirty-tracking LRU over on-device units.

Port of ``repro.core.unitcache``, copied whole: the module is plain
Python (no framework), so the port keeps its own copy rather than
import the JAX package. Builder and live executor replay the same
sequence of lookups and deposits on it: ``taskgraph.build_sweep_tasks``
(``cache_bytes``/``policy``) to model the elided transfers and the
flush points, and ``executor.AsyncExecutor`` to elide them for real.

Under the default ``write-back`` policy a writeback deposits its
on-device payload as dirty instead of materializing to host: the D2H
becomes a version commit with no host copy, and the bytes cross the
link only when residency is lost (flush-on-evict, returned in
``DepositResult.flushes``; flush-on-gather and flush-on-demand, oldest
first through ``dirty_entries()``). ``pin``/``release`` keep a
checkpoint cut's payloads alive copy-on-write. ``policy=
"write-through"`` makes every deposit clean; ``budget_bytes=0``
disables residency.

>>> mgr = DeviceResidencyManager(budget_bytes=100, policy="write-back")
>>> mgr.deposit("u0", 1, "payload-bytes", 60, dirty=True).stored
True
>>> mgr.lookup("u0", 1)      # current version resident: H2D elided
(True, 'payload-bytes')
>>> res = mgr.deposit("u1", 1, "other", 60, dirty=True)  # evicts u0
>>> [(key, ent.version) for key, ent in res.flushes]     # caller pays
[('u0', 1)]
>>> mgr.mark_flushed("u1")   # gather/checkpoint drain, after the put
>>> mgr.dirty_bytes
0

Entries are versioned (``lookup`` hits only the current version), may
change size across versions (adaptive rates; the superseded entry is
dropped before the budget check), and carry an optional rate label for
the per-rate byte gauges. Values are opaque: device tensors or
``Compressed`` handles in the executor, ``None`` in the graph builder.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Tuple, Union

POLICIES = ("write-back", "write-through")


@dataclass
class TenantQuota:
    """One tenant's residency contract: ``reserve`` bytes are a hard
    floor no other tenant's deposit may evict below; anything a tenant
    holds beyond its reserve is soft burst into shared slack, stealable
    by others. ``priority`` orders victim selection: lower-priority
    tenants' (stealable) bytes are always evicted before a
    higher-priority tenant's."""

    reserve: int
    priority: int = 0


@dataclass
class ResidencyArbiter:
    """Pure multi-tenant eviction policy consulted by the residency
    manager when keys are namespaced ``(tenant, unit_key)``.

    The arbiter holds only the quota table; the victim rule lives in
    ``DeviceResidencyManager._plan_victims`` and depends solely on the
    quotas and the global LRU order — never on grant order — so two
    arbiters granted the same quotas in any order drive identical
    eviction sequences (asserted by hypothesis in
    ``tests/test_tenancy_properties.py``).

    >>> arb = ResidencyArbiter()
    >>> arb.grant("latency", reserve=60, priority=10)
    >>> arb.grant("batch", reserve=0, priority=0)
    >>> mgr = DeviceResidencyManager(budget_bytes=100, arbiter=arb)
    >>> _ = mgr.deposit(("batch", "b0"), 1, "payload", 40)
    >>> _ = mgr.deposit(("latency", "l0"), 1, "payload", 60)
    >>> _ = mgr.deposit(("latency", "l1"), 1, "payload", 40)
    >>> sorted(mgr._entries)  # batch LRU evicted before latency's set
    [('latency', 'l0'), ('latency', 'l1')]
    >>> mgr.tenant_bytes == {"batch": 0, "latency": 100}
    True
    """

    quotas: Dict[str, TenantQuota] = field(default_factory=dict)

    def grant(self, tenant: str, reserve: int, priority: int = 0) -> None:
        self.quotas[tenant] = TenantQuota(int(reserve), int(priority))

    def revoke(self, tenant: str) -> None:
        self.quotas.pop(tenant, None)

    def reserve_of(self, tenant: str) -> int:
        q = self.quotas.get(tenant)
        return q.reserve if q is not None else 0

    def priority_of(self, tenant: str) -> int:
        q = self.quotas.get(tenant)
        return q.priority if q is not None else 0

    def reserved_total(self) -> int:
        return sum(q.reserve for q in self.quotas.values())


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    deposits: int = 0
    # sweep advances the deposited payloads carry, NOT fetch/deposit
    # multiplicity: a temporal-k visit is ONE deposit / k bumps
    version_bumps: int = 0
    refusals: int = 0  # deposits rejected (entry larger than budget)
    evictions: int = 0
    hit_wire_bytes: int = 0  # h2d link bytes elided by hits
    # write-back accounting
    d2h_elided: int = 0  # writebacks committed on device, no host copy
    d2h_elided_wire_bytes: int = 0  # d2h link bytes those commits skipped
    flushes: int = 0  # dirty payloads materialized (evict/gather/ckpt)
    flush_wire_bytes: int = 0  # link bytes the flushes paid
    dirty_bytes: int = 0  # resident bytes currently newer than host
    # fault mitigation on the flush path (ReissuePolicy integration)
    flush_reissues: int = 0  # failed flush puts retried on the spare stream
    flush_stragglers: int = 0  # flush puts that exceeded the reissue deadline
    # overlapped checkpoint cut (COW pin/release accounting)
    pins: int = 0  # entries pinned at a checkpoint cut
    pin_releases: int = 0  # pins released after their snapshot flush
    cow_shadows: int = 0  # pinned payloads preserved across a supersede
    pinned_bytes: int = 0  # resident bytes currently pinned (live + shadow)
    ckpt_flushes: int = 0  # snapshot D2H materializations of pinned payloads
    ckpt_flush_wire_bytes: int = 0  # link bytes the snapshot flushes paid
    # self-healing wire: the store mirrors its retry/integrity
    # counters here so one stats surface covers the whole engine
    h2d_retries: int = 0  # fetch attempts beyond the first
    d2h_retries: int = 0  # writeback/flush attempts beyond the first
    wire_faults: int = 0  # injected transfer failures + corruptions seen
    checksum_failures: int = 0  # integrity mismatches caught on the wire
    wire_stragglers: int = 0  # crossings flagged straggling by the plan
    shard_retries: int = 0  # checkpoint shard writes retried
    recoveries: int = 0  # rollback-and-replay cycles taken by run()
    replayed_sweeps: int = 0  # sweeps re-executed after rollbacks
    # multi-device halo exchange: inter-device crossings this
    # shard *exported* (held slices + encoded boundary commons), kept
    # separate from h2d/d2h so bench rows and parity tests can assert
    # halo traffic on its own
    halo_count: int = 0  # halo payloads shipped to a neighbor shard
    halo_wire_bytes: int = 0  # link bytes those halo crossings paid
    # per-rate resident-byte gauges (adaptive rate control):
    # bytes currently held per rate label ("p12", "raw", ...); only
    # populated when deposits carry a rate label, so legacy paths keep
    # an empty dict
    rate_bytes: Dict[str, int] = field(default_factory=dict)

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict[str, Union[int, float]]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "deposits": self.deposits,
            "version_bumps": self.version_bumps,
            "refusals": self.refusals,
            "evictions": self.evictions,
            "hit_wire_bytes": self.hit_wire_bytes,
            "d2h_elided": self.d2h_elided,
            "d2h_elided_wire_bytes": self.d2h_elided_wire_bytes,
            "flushes": self.flushes,
            "flush_wire_bytes": self.flush_wire_bytes,
            "dirty_bytes": self.dirty_bytes,
            "flush_reissues": self.flush_reissues,
            "flush_stragglers": self.flush_stragglers,
            "pins": self.pins,
            "pin_releases": self.pin_releases,
            "cow_shadows": self.cow_shadows,
            "pinned_bytes": self.pinned_bytes,
            "ckpt_flushes": self.ckpt_flushes,
            "ckpt_flush_wire_bytes": self.ckpt_flush_wire_bytes,
            "h2d_retries": self.h2d_retries,
            "d2h_retries": self.d2h_retries,
            "wire_faults": self.wire_faults,
            "checksum_failures": self.checksum_failures,
            "wire_stragglers": self.wire_stragglers,
            "shard_retries": self.shard_retries,
            "recoveries": self.recoveries,
            "replayed_sweeps": self.replayed_sweeps,
            "halo_count": self.halo_count,
            "halo_wire_bytes": self.halo_wire_bytes,
            "rate_bytes": dict(self.rate_bytes),
            "hit_rate": self.hit_rate,
        }


@dataclass
class Entry:
    version: int
    value: Any
    nbytes: int
    dirty: bool = False
    # pinned by an in-flight overlapped checkpoint cut: the payload
    # must survive (shadowed, never evicted) until release()
    pinned: bool = False
    # rate label of the payload ("p12", "raw", ...) for the per-rate
    # byte gauges; None when the depositor doesn't track rates
    rate: Optional[str] = None


@dataclass
class DepositResult:
    """Outcome of a ``deposit``: whether the payload is now resident,
    and which dirty entries its admission evicted — the caller MUST
    materialize those to the host store (flush-on-evict) or their data
    is lost."""

    stored: bool
    flushes: List[Tuple[Hashable, Entry]] = field(default_factory=list)


@dataclass
class DeviceResidencyManager:
    """Byte-budgeted LRU over on-device unit payloads owning both
    transfer directions: read residency (H2D elision) and, under
    ``policy="write-back"``, dirty write residency (D2H elision with
    ordered flush).

    Parameters
    ----------
    budget_bytes:
        Residency byte budget. ``0`` (the default) disables residency
        entirely: every ``deposit`` is refused and every lookup
        misses, reducing the executor to fetch/write-every-sweep.
    policy:
        ``"write-back"`` (default) — writeback deposits are dirty and
        their D2H is elided until a flush point; ``"write-through"`` —
        every deposit is clean (the read-only cache's semantics, kept
        for A/B benchmarking). Any other value raises ``ValueError``.
    """

    budget_bytes: int = 0
    policy: str = "write-back"
    stats: CacheStats = field(default_factory=CacheStats)
    # multi-tenant mode: when an arbiter is attached, every key
    # MUST be namespaced ``(tenant, unit_key)`` and eviction follows the
    # quota/priority rule in _plan_victims instead of plain LRU. With
    # arbiter=None the manager is byte-for-byte the single-tenant LRU.
    arbiter: Optional[ResidencyArbiter] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"unknown residency policy {self.policy!r}; "
                f"expected one of {POLICIES}"
            )
        self._entries: "OrderedDict[Hashable, Entry]" = OrderedDict()
        # pre-cut payloads superseded while pinned (the COW copies):
        # still resident on device (bytes accounted) but unreachable by
        # lookups — only the snapshot's release() lets them go
        self._shadows: Dict[Hashable, Entry] = {}
        self.bytes_used = 0
        self.peak_bytes = 0
        # per-tenant breakdowns (arbiter mode only): resident bytes
        # (live + shadow), high-water mark, and a CacheStats each —
        # the same object each tenant's HostUnitStore mirrors its wire
        # counters into, so one per-tenant surface covers the engine
        self.tenant_bytes: Dict[str, int] = {}
        self.tenant_peak: Dict[str, int] = {}
        self.tenant_stats: Dict[str, CacheStats] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def enabled(self) -> bool:
        return self.budget_bytes > 0

    @property
    def write_back(self) -> bool:
        return self.policy == "write-back"

    @property
    def dirty_bytes(self) -> int:
        return self.stats.dirty_bytes

    # ------------------------------------------------------------------
    # multi-tenant plumbing (all no-ops when arbiter is None)
    # ------------------------------------------------------------------
    def tenant_stats_for(self, tenant: str) -> CacheStats:
        """The per-tenant stats object, created on first use."""
        ts = self.tenant_stats.get(tenant)
        if ts is None:
            ts = self.tenant_stats[tenant] = CacheStats()
        return ts

    def _tstats(self, key: Hashable) -> Optional[CacheStats]:
        if self.arbiter is None:
            return None
        return self.tenant_stats_for(key[0])

    def _taccount(self, key: Hashable, delta: int) -> None:
        """Adjust the owning tenant's resident-byte gauge by ``delta``."""
        if self.arbiter is None:
            return
        tenant = key[0]
        n = self.tenant_bytes.get(tenant, 0) + delta
        self.tenant_bytes[tenant] = n
        if delta > 0:
            self.tenant_peak[tenant] = max(self.tenant_peak.get(tenant, 0), n)

    # ------------------------------------------------------------------
    def lookup(self, key: Hashable, version: int) -> Tuple[bool, Any]:
        """``(hit, value)`` for the unit at ``version``; hits refresh
        LRU recency, stale *clean* entries are dropped (stale dirty
        entries stay — see below)."""
        ts = self._tstats(key)
        ent = self._entries.get(key)
        if ent is None:
            self.stats.misses += 1
            if ts is not None:
                ts.misses += 1
            return False, None
        if ent.version != version:
            # stale for this request: clean entries are dropped so
            # their bytes reclaim immediately, but a DIRTY entry is the
            # only copy of a committed-on-device payload — it stays
            # resident until superseded, evicted (flush handback) or
            # explicitly flushed, never silently lost. A PINNED entry
            # is an in-flight snapshot's cut: it stays put either way.
            if not ent.dirty and not ent.pinned:
                self._drop(key)
            self.stats.misses += 1
            if ts is not None:
                ts.misses += 1
            return False, None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        self.stats.hit_wire_bytes += ent.nbytes
        if ts is not None:
            ts.hits += 1
            ts.hit_wire_bytes += ent.nbytes
        return True, ent.value

    def peek(self, key: Hashable) -> Optional[Entry]:
        """The entry for ``key`` (any version), with no stats or LRU
        side effects — the executor's drain uses this to decide commit
        vs materialize."""
        return self._entries.get(key)

    def _rate_account(self, ent: Entry, delta: int) -> None:
        """Move ``delta`` bytes in the per-rate gauge for ``ent``'s
        label; keys reaching zero are removed so the dict only names
        rates actually resident."""
        if ent.rate is None:
            return
        rb = self.stats.rate_bytes
        new = rb.get(ent.rate, 0) + delta
        if new:
            rb[ent.rate] = new
        else:
            rb.pop(ent.rate, None)

    def deposit(
        self,
        key: Hashable,
        version: int,
        value: Any,
        nbytes: int,
        dirty: bool = False,
        bumps: int = 0,
        rate: Optional[str] = None,
    ) -> DepositResult:
        """Insert/replace the unit's payload at ``version`` (MRU),
        evicting LRU entries until the budget holds. ``dirty`` marks
        the payload newer than the host copy (writebacks); under
        write-through it is ignored and every deposit is clean. A
        payload larger than the whole budget is refused (and any stale
        entry for the key dropped). Evicted *dirty* entries are
        returned for the caller to flush.

        ``bumps`` is the number of sweeps this payload advanced its
        unit past the previous version — ``k`` for a temporal-k
        writeback deposit, ``0`` for a read-only fetch deposit. It is
        pure accounting (``CacheStats.version_bumps``): one fused
        visit counts as ONE deposit however many sweeps it carries,
        and the bump counter is what scales with simulated time.

        ``rate`` optionally labels the payload's encoding rate
        (``"p12"``, ``"raw"``, ...) for ``CacheStats.rate_bytes``;
        payload sizes may differ across versions of the same key
        (adaptive rate control), which is why the superseded entry is
        dropped *before* the budget check below."""
        ts = self._tstats(key)
        self.stats.version_bumps += int(bumps)
        if ts is not None:
            ts.version_bumps += int(bumps)
        dirty = bool(dirty) and self.write_back
        if key in self._entries:
            old = self._entries[key]
            if old.pinned:
                # copy-on-write: the old payload is an in-flight
                # snapshot's cut — move it to a shadow slot (bytes stay
                # resident, accounted as pinned) instead of dropping it
                assert key not in self._shadows, key
                del self._entries[key]
                if old.dirty:
                    # unreachable by the host path from here on: the
                    # newer deposit carries the dirty state forward
                    self.stats.dirty_bytes -= old.nbytes
                    if ts is not None:
                        ts.dirty_bytes -= old.nbytes
                    old.dirty = False
                self._shadows[key] = old
                self.stats.cow_shadows += 1
                if ts is not None:
                    ts.cow_shadows += 1
            else:
                # superseded: the old payload can never be needed again
                self._drop(key)
        if not self.enabled or nbytes > self.budget_bytes:
            self.stats.refusals += 1
            if ts is not None:
                ts.refusals += 1
            return DepositResult(False)
        if self.arbiter is None:
            flushes = self._evict_for(int(nbytes))
        else:
            # plan first, evict after: a deposit the quotas cannot make
            # room for is REFUSED without disturbing anyone's residency
            # (no over-admission across tenants), and the refusal is
            # harmless to the depositor — its writeback just pays the
            # ordinary D2H instead of committing on device.
            victims, fits = self._plan_victims(int(nbytes), key[0])
            if not fits:
                self.stats.refusals += 1
                if ts is not None:
                    ts.refusals += 1
                return DepositResult(False)
            flushes = self._commit_evictions(victims)
        ent = Entry(version, value, int(nbytes), dirty, rate=rate)
        self._entries[key] = ent
        self.bytes_used += int(nbytes)
        self.peak_bytes = max(self.peak_bytes, self.bytes_used)
        self._rate_account(ent, int(nbytes))
        self._taccount(key, int(nbytes))
        self.stats.deposits += 1
        if ts is not None:
            ts.deposits += 1
        if dirty:
            self.stats.dirty_bytes += int(nbytes)
            if ts is not None:
                ts.dirty_bytes += int(nbytes)
        return DepositResult(True, flushes)

    def _evict_for(
        self, incoming: int, for_key: Optional[Hashable] = None
    ) -> List[Tuple[Hashable, Entry]]:
        """LRU eviction until ``incoming`` more bytes fit the budget,
        skipping pinned entries (a snapshot's cut may not be evicted —
        pins raise pressure transiently instead, reclaimed at
        release). Evicted *dirty* entries are returned for the caller
        to flush (flush-on-evict). In arbiter mode the victim order is
        the quota/priority rule (best effort here — deposit handles
        refusal itself via ``_plan_victims``)."""
        if self.arbiter is not None:
            on_behalf = for_key[0] if for_key is not None else None
            victims, _ = self._plan_victims(incoming, on_behalf)
            return self._commit_evictions(victims)
        flushes: List[Tuple[Hashable, Entry]] = []
        while self.bytes_used + incoming > self.budget_bytes:
            victim = next(
                (k for k, e in self._entries.items() if not e.pinned),
                None,
            )
            if victim is None:
                break  # everything resident is pinned: over-budget
            ent = self._entries.pop(victim)
            self.bytes_used -= ent.nbytes
            self._rate_account(ent, -ent.nbytes)
            self.stats.evictions += 1
            if ent.dirty:
                # flush-on-evict: residency lost, the caller pays the
                # D2H now (ordered before anything can refetch k)
                self.stats.dirty_bytes -= ent.nbytes
                self.stats.flushes += 1
                self.stats.flush_wire_bytes += ent.nbytes
                flushes.append((victim, ent))
        return flushes

    def _plan_victims(
        self, incoming: int, for_tenant: Optional[str]
    ) -> Tuple[List[Hashable], bool]:
        """Quota/priority victim selection (arbiter mode): the ordered
        eviction list making room for ``incoming`` bytes on behalf of
        ``for_tenant``, and whether the budget can actually be met.

        The rule, applied greedily until the budget holds:

        * pinned entries (and COW shadows) are never victims — a
          snapshot's cut cannot be stolen across tenants;
        * the depositing tenant's own entries are always stealable
          (its reserve protects it from *others*, not from itself);
        * a foreign tenant's entry is stealable only while evicting it
          leaves that tenant at or above its hard reserve;
        * among stealable entries, pick the lowest ``(owner priority,
          LRU rank)`` — the batch tenant's LRU goes before a
          latency tenant's working set, and ties fall to global LRU.

        Pure planning: no state is touched, so a refused deposit
        leaves every tenant's residency exactly as it found it."""
        victims: List[Hashable] = []
        freed = 0
        remaining = dict(self.tenant_bytes)
        chosen = set()
        while self.bytes_used - freed + incoming > self.budget_bytes:
            best = None
            for rank, (k, e) in enumerate(self._entries.items()):
                if e.pinned or k in chosen:
                    continue
                owner = k[0]
                if owner != for_tenant:
                    floor = self.arbiter.reserve_of(owner)
                    if remaining.get(owner, 0) - e.nbytes < floor:
                        continue  # hard reserve: never violated
                cand = (self.arbiter.priority_of(owner), rank)
                if best is None or cand < best[0]:
                    best = (cand, k, e)
            if best is None:
                return victims, False  # cannot make room under quotas
            _, k, e = best
            chosen.add(k)
            victims.append(k)
            freed += e.nbytes
            remaining[k[0]] = remaining.get(k[0], 0) - e.nbytes
        return victims, True

    def _commit_evictions(
        self, victims: List[Hashable]
    ) -> List[Tuple[Hashable, Entry]]:
        """Evict a planned victim list, attributing each eviction (and
        any flush handback) to the VICTIM's tenant stats."""
        flushes: List[Tuple[Hashable, Entry]] = []
        for victim in victims:
            ent = self._entries.pop(victim)
            self.bytes_used -= ent.nbytes
            self._rate_account(ent, -ent.nbytes)
            self._taccount(victim, -ent.nbytes)
            ts = self._tstats(victim)
            self.stats.evictions += 1
            if ts is not None:
                ts.evictions += 1
            if ent.dirty:
                self.stats.dirty_bytes -= ent.nbytes
                self.stats.flushes += 1
                self.stats.flush_wire_bytes += ent.nbytes
                if ts is not None:
                    ts.dirty_bytes -= ent.nbytes
                    ts.flushes += 1
                    ts.flush_wire_bytes += ent.nbytes
                flushes.append((victim, ent))
        return flushes

    # ------------------------------------------------------------------
    # dirty-state management (write-back)
    # ------------------------------------------------------------------
    def dirty_entries(self) -> List[Tuple[Hashable, Entry]]:
        """Dirty entries in LRU (oldest-first) order — the
        deterministic flush order for gather/checkpoint."""
        return [(k, e) for k, e in self._entries.items() if e.dirty]

    def mark_flushed(self, key: Hashable) -> None:
        """Record that ``key``'s dirty payload was materialized to the
        host store. The entry stays resident (now clean) so later
        sweeps still hit. Call only AFTER the host put succeeded — a
        failed flush must leave the entry dirty for retry."""
        ent = self._entries[key]
        assert ent.dirty, key
        ent.dirty = False
        self.stats.dirty_bytes -= ent.nbytes
        self.stats.flushes += 1
        self.stats.flush_wire_bytes += ent.nbytes
        ts = self._tstats(key)
        if ts is not None:
            ts.dirty_bytes -= ent.nbytes
            ts.flushes += 1
            ts.flush_wire_bytes += ent.nbytes

    def note_d2h_elided(
        self, nbytes: int, tenant: Optional[str] = None
    ) -> None:
        """Account one writeback that committed on device with no host
        copy (its D2H never touches the wire as its own transfer)."""
        self.stats.d2h_elided += 1
        self.stats.d2h_elided_wire_bytes += int(nbytes)
        if tenant is not None and self.arbiter is not None:
            ts = self.tenant_stats_for(tenant)
            ts.d2h_elided += 1
            ts.d2h_elided_wire_bytes += int(nbytes)

    # ------------------------------------------------------------------
    # overlapped checkpoint cut: COW pin / release
    # ------------------------------------------------------------------
    def pin(self, key: Hashable) -> Optional[Entry]:
        """Pin ``key``'s resident entry for an in-flight snapshot.

        Until ``release(key)``, the pinned payload is guaranteed to
        survive: LRU eviction skips it, a stale lookup will not drop
        it, and a newer deposit of the same key moves it to a shadow
        slot (copy-on-write) instead of dropping it. Returns the
        pinned entry, or ``None`` if the key is not resident (nothing
        to pin). Pinning is idempotent per key; at most one snapshot
        may be in flight (a shadowed key cannot be pinned again until
        released).

        >>> mgr = DeviceResidencyManager(budget_bytes=100)
        >>> _ = mgr.deposit("u", 1, "v1-bytes", 40, dirty=True)
        >>> mgr.pin("u").version
        1
        >>> _ = mgr.deposit("u", 2, "v2-bytes", 40, dirty=True)  # COW
        >>> mgr.pinned_entry("u").value  # the snapshot still sees v1
        'v1-bytes'
        >>> mgr.release("u")  # budget re-enforced; no victims here
        []
        >>> mgr.stats.pinned_bytes
        0
        """
        ent = self._entries.get(key)
        if ent is None or ent.pinned:
            return ent
        assert key not in self._shadows, (
            "one snapshot at a time: release the previous pin first",
            key,
        )
        ent.pinned = True
        self.stats.pins += 1
        self.stats.pinned_bytes += ent.nbytes
        ts = self._tstats(key)
        if ts is not None:
            ts.pins += 1
            ts.pinned_bytes += ent.nbytes
        return ent

    def pinned_entry(self, key: Hashable) -> Optional[Entry]:
        """The payload a snapshot must persist for ``key``: the shadow
        (pre-cut payload preserved across a supersede) if one exists,
        else the live pinned entry."""
        shadow = self._shadows.get(key)
        if shadow is not None:
            return shadow
        ent = self._entries.get(key)
        return ent if ent is not None and ent.pinned else None

    def release(self, key: Hashable) -> List[Tuple[Hashable, Entry]]:
        """Release ``key``'s snapshot pin after its payload was
        persisted. A shadowed (superseded) payload is dropped and its
        bytes reclaimed; a live pinned entry loses the pin and becomes
        evictable again. Either way the budget is re-enforced: pin
        pressure may have over-admitted, so LRU victims evict here
        until the budget holds again — evicted *dirty* entries are
        returned for the caller to flush (the same flush-on-evict
        handback as ``deposit``). No-op (empty list) if nothing is
        pinned."""
        freed = False
        ts = self._tstats(key)
        shadow = self._shadows.pop(key, None)
        if shadow is not None:
            self.bytes_used -= shadow.nbytes
            self._rate_account(shadow, -shadow.nbytes)
            self._taccount(key, -shadow.nbytes)
            self.stats.pinned_bytes -= shadow.nbytes
            self.stats.pin_releases += 1
            if ts is not None:
                ts.pinned_bytes -= shadow.nbytes
                ts.pin_releases += 1
            freed = True
        else:
            ent = self._entries.get(key)
            if ent is not None and ent.pinned:
                ent.pinned = False
                self.stats.pinned_bytes -= ent.nbytes
                self.stats.pin_releases += 1
                if ts is not None:
                    ts.pinned_bytes -= ent.nbytes
                    ts.pin_releases += 1
                freed = True
        return self._evict_for(0, key) if freed else []

    def pinned_keys(self) -> List[Hashable]:
        """Keys currently pinned (live or shadowed), LRU-first."""
        out = [k for k, e in self._entries.items() if e.pinned]
        out.extend(k for k in self._shadows if k not in out)
        return out

    def note_ckpt_flush(
        self, nbytes: int, tenant: Optional[str] = None
    ) -> None:
        """Account one snapshot D2H: a pinned payload materialized
        into a checkpoint shard (distinct from host-store flushes)."""
        self.stats.ckpt_flushes += 1
        self.stats.ckpt_flush_wire_bytes += int(nbytes)
        if tenant is not None and self.arbiter is not None:
            ts = self.tenant_stats_for(tenant)
            ts.ckpt_flushes += 1
            ts.ckpt_flush_wire_bytes += int(nbytes)

    # ------------------------------------------------------------------
    # multi-tenant lifecycle
    # ------------------------------------------------------------------
    def drop_tenant(self, tenant: str) -> None:
        """Forget every entry and shadow ``tenant`` owns — its retire
        (after a flush) or its crash rollback (residency is cold after
        a restore anyway). Dirty payloads are dropped WITHOUT a flush:
        callers that need them must drain first. No other tenant's
        residency, pins, or stats are touched — the isolation edge the
        chaos tier leans on."""
        assert self.arbiter is not None, "drop_tenant needs arbiter mode"
        ts = self.tenant_stats.get(tenant)
        for k in [k for k in self._entries if k[0] == tenant]:
            ent = self._entries.pop(k)
            self.bytes_used -= ent.nbytes
            self._rate_account(ent, -ent.nbytes)
            if ent.dirty:
                self.stats.dirty_bytes -= ent.nbytes
                if ts is not None:
                    ts.dirty_bytes -= ent.nbytes
            if ent.pinned:
                self.stats.pinned_bytes -= ent.nbytes
                if ts is not None:
                    ts.pinned_bytes -= ent.nbytes
        for k in [k for k in self._shadows if k[0] == tenant]:
            shadow = self._shadows.pop(k)
            self.bytes_used -= shadow.nbytes
            self._rate_account(shadow, -shadow.nbytes)
            self.stats.pinned_bytes -= shadow.nbytes
            if ts is not None:
                ts.pinned_bytes -= shadow.nbytes
        self.tenant_bytes[tenant] = 0

    def rollback_reset(self) -> "DeviceResidencyManager":
        """A cold manager for a crash rollback: same budget/policy and
        the SAME stats object (counters survive recovery; the dirty and
        pinned gauges reset with the lost residency). The executor's
        ``_rollback`` swaps to the returned manager; a ``TenantView``
        overrides this to drop only its own tenant instead."""
        mgr = DeviceResidencyManager(self.budget_bytes, policy=self.policy)
        mgr.stats = self.stats
        self.stats.dirty_bytes = 0
        self.stats.pinned_bytes = 0
        self.stats.rate_bytes = {}
        return mgr

    # ------------------------------------------------------------------
    def _drop(self, key: Hashable) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.bytes_used -= ent.nbytes
            self._rate_account(ent, -ent.nbytes)
            self._taccount(key, -ent.nbytes)
            if ent.dirty:
                self.stats.dirty_bytes -= ent.nbytes
                ts = self._tstats(key)
                if ts is not None:
                    ts.dirty_bytes -= ent.nbytes


# The read-only cache's name: the read-side behavior (lookup/deposit/LRU/budget) is
# unchanged, so existing consumers keep working; write-back is additive.
UnitCache = DeviceResidencyManager

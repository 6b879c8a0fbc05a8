"""Synchronous out-of-core stencil engine with on-device compression.

Port of ``repro.core.outofcore``. The paper's workflow (§V): a volume
too large for device memory is decomposed along Z (``BlockPlan``);
blocks are streamed host->device, advanced ``bt`` temporally-blocked
stencil steps, and streamed back, with each storage unit (remainder or
common region) fixed-rate compressed on the device, so only compressed
payloads cross the link, and each common region fetched and written
once.

``OutOfCoreWave`` is the synchronous engine, one block visit at a time:
``HostUnitStore.stage`` -> ``zfp_ops.decompress`` ->
``stencil_ops.fused_temporal_steps`` -> ``zfp_ops.compress`` ->
``HostUnitStore.put``. Host units are numpy arrays; ``stage`` moves a
unit to the engine's device and ``put``/``gather`` bring values back
with an explicit copy. Every crossing is crc32-checked. The live engine
(``repro_torch.core.executor.AsyncExecutor``) shares the store: it moves
units through its own pinned buffers and streams and hands the store
the digests (``cross_h2d``, ``put(crc=, send=)``), and under write-back
residency it commits versions that live on the device only
(``commit_device``), so the store keeps the committed version and the
host payload's version apart.

The engine runs on the CUDA device unless ``OOCConfig.device`` names the
CPU. ``backend="cuda"`` (the default) runs the hand-written kernels and
needs a CUDA device; ``backend="ref"`` runs the plain PyTorch versions
on either device.

Field roles follow paper Table I: two read-write pressure fields, a
write-only Laplacian scratch (never transferred), and a read-only
velocity field (transferred to the device, never written back).
"""

from __future__ import annotations

import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.blocks import BlockPlan
from repro_torch.core.taskgraph import Transfer, summarize_transfers
from repro_torch.distributed.fault import (
    ChecksumError,
    FaultInjector,
    InjectedFault,
    RetryPolicy,
    UnrecoverableFault,
)
from repro_torch.kernels.stencil import ops as stencil_ops
from repro_torch.kernels.stencil.ref import HALO
from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp.ref import Compressed, dtype_key

__all__ = [
    "FieldSpec", "OOCConfig", "OutOfCoreWave", "HostUnitStore",
    "Transfer", "paper_code_fields", "unit_shards", "unit_checksum",
]

Role = Literal["rw", "ro"]


@dataclass(frozen=True)
class FieldSpec:
    role: Role
    planes: Optional[int] = None  # None = uncompressed

    @property
    def compressed(self) -> bool:
        return self.planes is not None


@dataclass
class OOCConfig:
    shape: Tuple[int, int, int]  # interior (Z, Y, X)
    ndiv: int
    bt: int
    fields: Dict[str, FieldSpec]
    backend: str = "cuda"  # stencil+codec backend ("ref" | "cuda")
    dtype: str = "float32"
    device: Optional[str] = None  # None = the CUDA device

    @property
    def plan(self) -> BlockPlan:
        return BlockPlan(self.shape[0], self.ndiv, self.bt)

    def temporal_plan(self, temporal: int = 1) -> BlockPlan:
        """The block plan a temporal-k engine runs against: fusing ``k``
        sweeps per block visit widens the halo to ``radius * bt * k``
        planes per side. Raises a clear error when the widened halo does
        not fit the block interior."""
        if temporal < 1:
            raise ValueError(
                f"temporal fusion must be >= 1 sweeps, got {temporal}"
            )
        if self.shape[0] % self.ndiv:
            raise ValueError(
                f"Z={self.shape[0]} must divide into ndiv={self.ndiv} "
                "equal blocks"
            )
        block = self.shape[0] // self.ndiv
        halo = HALO * self.bt * temporal
        # ndiv >= 3 has interior remainders [s+H, e-H), empty at
        # block == 2H; ndiv <= 2 only needs the fetched extent valid
        if 2 * halo > block or (self.ndiv >= 3 and 2 * halo >= block):
            raise ValueError(
                f"halo-width {halo} (= radius {HALO} x bt {self.bt} x "
                f"temporal {temporal}) exceeds the block interior: "
                f"block={block} planes (Z={self.shape[0]}, "
                f"ndiv={self.ndiv}) needs block "
                f"{'>' if self.ndiv >= 3 else '>='} 2*halo={2 * halo}. "
                "Lower the temporal fusion k, bt, or ndiv."
            )
        return BlockPlan(self.shape[0], self.ndiv, self.bt * temporal)

    def to_dict(self) -> Dict[str, object]:
        """JSON-able description; inverse of ``from_dict``."""
        return {
            "shape": list(self.shape),
            "ndiv": self.ndiv,
            "bt": self.bt,
            "fields": {
                name: {"role": spec.role, "planes": spec.planes}
                for name, spec in self.fields.items()
            },
            "backend": self.backend,
            "dtype": self.dtype,
            "device": self.device,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "OOCConfig":
        return cls(
            shape=tuple(d["shape"]),
            ndiv=int(d["ndiv"]),
            bt=int(d["bt"]),
            fields={
                name: FieldSpec(
                    f["role"],
                    None if f["planes"] is None else int(f["planes"]),
                )
                for name, f in d["fields"].items()
            },
            backend=d.get("backend", "cuda"),
            dtype=d.get("dtype", "float32"),
            device=d.get("device"),
        )


def paper_code_fields(code: int, f32: bool = True) -> Dict[str, FieldSpec]:
    """The four experiment codes of §VI. ``f32=False`` gives the paper's
    float64 rates 32/64 and 24/64 (planes 32 and 24, for an
    ``OOCConfig(dtype="float64")``); the default gives the float32
    equivalents 16 and 12 (same ratios)."""
    r2, r267 = (16, 12) if f32 else (32, 24)
    none = FieldSpec("rw", None)
    if code == 1:  # original (no compression)
        return {
            "p_prev": none, "p_cur": none, "vel2": FieldSpec("ro", None)
        }
    if code == 2:  # one RW dataset @ 2:1
        return {
            "p_prev": FieldSpec("rw", r2), "p_cur": none,
            "vel2": FieldSpec("ro", None),
        }
    if code == 3:  # RO dataset @ 2:1
        return {
            "p_prev": none, "p_cur": none, "vel2": FieldSpec("ro", r2)
        }
    if code == 4:  # one RW + RO @ 2.67:1
        return {
            "p_prev": FieldSpec("rw", r267), "p_cur": none,
            "vel2": FieldSpec("ro", r267),
        }
    raise ValueError(code)


# ----------------------------------------------------------------------
# host <-> device
# ----------------------------------------------------------------------


def to_host(a) -> np.ndarray:
    """A host numpy array for a tensor (one copy, also on the CPU, so
    the store never aliases a tensor the engine still holds) or an
    array (as is). uint32 tensors cross as their int32 bits."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if a.dtype == torch.uint32:
        return to_host(a.view(torch.int32)).view(np.uint32)
    return a.detach().to("cpu", copy=True).numpy()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host array on ``device`` (uint32 crosses as int32)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return to_device(a.view(np.int32), device).view(torch.uint32)
    return torch.from_numpy(a).to(device, copy=True)


def _host_value(value):
    """Host-materialized copy of a raw or compressed unit value."""
    if isinstance(value, Compressed):
        return Compressed(
            to_host(value.payload), to_host(value.emax), value.shape,
            value.planes, value.ndim_spatial, value.dtype,
        )
    return to_host(value)


def unit_bytes(value) -> Tuple[int, int]:
    """``(raw_bytes, wire_bytes)`` of a unit value, host or device: the
    bytes it stands for and the bytes it crosses the link as."""
    if isinstance(value, Compressed):
        n = int(np.prod(value.shape)) * np.dtype(value.dtype).itemsize
        return n, value.nbytes()
    n = int(value.nbytes) if isinstance(value, np.ndarray) else (
        value.numel() * value.element_size())
    return n, n


def unit_checksum(value, version: int) -> int:
    """crc32 integrity digest of one unit: payload (+emax for
    compressed units) chained with the version it realizes, so a stale
    payload can never pass as a newer one. Computed from host bytes,
    without copying them."""
    crc = zlib.crc32(str(int(version)).encode())
    if isinstance(value, Compressed):
        crc = zlib.crc32(np.ascontiguousarray(to_host(value.payload)), crc)
        crc = zlib.crc32(np.ascontiguousarray(to_host(value.emax)), crc)
    else:
        crc = zlib.crc32(np.ascontiguousarray(to_host(value)), crc)
    return crc & 0xFFFFFFFF


def unit_shards(
    field: str, kind: str, idx: int, value, version: int,
) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """Checkpoint serialization of ONE unit: ``(leaves, meta)``, in the
    reference's layout (one leaf per raw unit, payload + emax per
    compressed unit, keyed ``field.kindidx[...]``) with the codec, the
    version and the crc32 of the persisted bytes."""
    ukey = f"{field}.{kind}{idx}"
    meta: Dict[str, object] = {
        "field": field, "kind": kind, "idx": idx, "version": int(version),
    }
    leaves: Dict[str, np.ndarray] = {}
    host = _host_value(value)
    if isinstance(host, Compressed):
        leaves[f"{ukey}.payload"] = host.payload
        leaves[f"{ukey}.emax"] = host.emax
        meta.update(
            codec="zfp", shape=list(host.shape), planes=host.planes,
            ndim_spatial=host.ndim_spatial, dtype=str(host.dtype),
        )
    else:
        leaves[ukey] = host
        meta["codec"] = "raw"
    meta["crc32"] = unit_checksum(host, version)
    return leaves, meta


def engine_device(cfg: OOCConfig) -> torch.device:
    """The device an engine over ``cfg`` runs on, after checking that
    its dtype (float32 or float64) and backend can run there."""
    dtype_key(cfg.dtype)
    device = device_mod.resolve(cfg.device)
    if cfg.backend not in ("ref", "cuda"):
        raise ValueError(
            f"backend must be 'ref' or 'cuda', got {cfg.backend!r}"
        )
    if cfg.backend == "cuda" and device.type != "cuda":
        raise ValueError(
            "backend='cuda' runs the CUDA kernels and needs a CUDA "
            "device; use backend='ref' with device='cpu'"
        )
    return device


class HostUnitStore:
    """Host-side storage of units, raw (numpy) or compressed payloads:
    seeding, put/get, host->device staging and full-field gather, with
    an integrity-checked, fault-injectable wire on every crossing."""

    def __init__(
        self,
        cfg: OOCConfig,
        plan: Optional[BlockPlan] = None,
        *,
        injector: Optional[FaultInjector] = None,
        retry: Optional[RetryPolicy] = None,
        stats=None,
        rates=None,
    ):
        self.cfg = cfg
        self.device = device_mod.resolve(cfg.device)
        # optional RateController: ``seed`` encodes each unit at its
        # sweep-0 rate instead of the field spec's (None = raw)
        self.rates = rates
        # the unit layout this store is decomposed under — a temporal-k
        # engine passes its halo-widened plan
        self.plan = plan if plan is not None else cfg.plan
        self._units: Dict[Tuple[str, str, int], object] = {}
        # committed version of each unit (writebacks since seeding, in
        # sweeps; seeded units are v0) and the version the host payload
        # realizes: under write-back residency a version can be
        # committed on the device only, and the first runs ahead of the
        # second until a flush puts the payload
        self._versions: Dict[Tuple[str, str, int], int] = {}
        self._host_versions: Dict[Tuple[str, str, int], int] = {}
        # crc32 of each host payload: recorded at every put, verified
        # at every crossing and at restore
        self._crc: Dict[Tuple[str, str, int], int] = {}
        self.injector = injector
        self.retry = retry
        # an optional CacheStats mirrored by the wire counters
        self.stats = stats
        # one (op, field, unit, version, attempts) record per crossing
        self.wire_log: List[Tuple[str, str, str, int, int]] = []
        self.wire_stats: Dict[str, int] = {
            "h2d_retries": 0, "d2h_retries": 0, "wire_faults": 0,
            "checksum_failures": 0, "wire_stragglers": 0,
        }
        self.backoff_s = 0.0  # accounted backoff time (never slept)

    # ------------------------------------------------------------------
    # the integrity-checked wire
    # ------------------------------------------------------------------
    def _count(self, name: str) -> None:
        self.wire_stats[name] += 1
        if self.stats is not None:
            setattr(self.stats, name, getattr(self.stats, name) + 1)

    def _wire(self, op: str, field: str, kind: str, idx: int,
              version: int, host, crc: int, send=None):
        """One integrity-checked link crossing under the retry policy.

        ``host`` is the host-side value and ``crc`` the checksum it must
        realize. Each attempt consults the injector (transfer failure or
        in-flight bit flip), then verifies the received bytes against
        ``crc``. Failed attempts retry up to ``retry.attempts`` with
        accounted (never slept) backoff; exhaustion raises
        ``UnrecoverableFault`` chaining the last failure.

        ``send`` is the live engine's transport: called once for each
        attempt the injector lets through, it returns ``(received,
        digest)`` of what actually crossed (its first call hands over a
        copy and a digest its host threads already made; a later call
        moves the unit again). Without it the received value is
        ``host`` and the digest is taken here.
        """
        unit = f"{kind}{idx}"
        attempts = self.retry.attempts if self.retry else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self._count(f"{op}_retries")
                if self.retry is not None:
                    self.backoff_s += self.retry.backoff(attempt)
            fault = None
            if self.injector is not None:
                fault = self.injector.transfer_fault(
                    op, field, unit, version, attempt
                )
            if fault == "transfer":
                self._count("wire_faults")
                last = InjectedFault(
                    f"injected {op} failure: {field}.{unit} "
                    f"v{version} attempt {attempt}"
                )
                continue
            if fault == "corrupt":
                self._count("wire_faults")
                if isinstance(host, Compressed):
                    received = Compressed(
                        FaultInjector.corrupt(host.payload), host.emax,
                        host.shape, host.planes, host.ndim_spatial,
                        host.dtype,
                    )
                else:
                    received = FaultInjector.corrupt(host)
                got = unit_checksum(received, version)
            elif send is not None:
                received, got = send()
            else:
                received = host
                got = unit_checksum(received, version)
            if got != crc:
                self._count("checksum_failures")
                last = ChecksumError(
                    f"{op} checksum mismatch for unit {field}.{unit} "
                    f"v{version}: expected {crc:#010x}, got {got:#010x}"
                )
                continue
            if self.injector is not None and self.injector.straggle(
                op, field, unit, version
            ) > 1.0:
                self._count("wire_stragglers")
            self.wire_log.append((op, field, unit, int(version),
                                  attempt + 1))
            return received
        raise UnrecoverableFault(
            f"{op} of unit {field}.{unit} v{version} failed after "
            f"{attempts} attempt(s): {last}"
        ) from last

    def attempt_multiset(self) -> Counter:
        """Multiset of completed crossings with their attempt counts."""
        return Counter(self.wire_log)

    def put(
        self, field: str, kind: str, idx: int, value,
        version: Optional[int] = None,
        on_wire: bool = True,
        crc: Optional[int] = None,
        send=None,
    ) -> int:
        """Store; returns wire bytes (what crossed the link).

        ``version`` pins the committed version this payload realizes
        (deferred writebacks and residency flushes); without it the
        counter bumps by one. It may not be older than the host's
        payload. A device value is copied to the host here (the D2H);
        the crossing is integrity-checked. ``on_wire=False`` marks a
        host-local put (seeding) that never crosses the link: exempt
        from injection, but still digested.

        The live engine passes a host value it already brought over,
        ``crc`` (the digest of the bytes as they left the device, taken
        on its host threads) and ``send`` (see ``_wire``), so no digest
        runs here on the clean path.
        """
        key = (field, kind, idx)
        if version is None:
            version = self._versions.get(key, -1) + 1
        if version < self._host_versions.get(key, 0):
            raise ValueError(f"put of {key} v{version} older than the host")
        host = _host_value(value)
        wire = host.nbytes() if isinstance(host, Compressed) else host.nbytes
        if crc is None:
            crc = unit_checksum(host, version)
        if on_wire:
            host = self._wire("d2h", field, kind, idx, version, host, crc,
                              send)
        # the payload lands before the version maps advance: a put that
        # fails mid-copy leaves host_current() false, not true over
        # stale bytes
        self._units[key] = host
        self._crc[key] = crc
        self._versions[key] = max(version, self._versions.get(key, 0))
        self._host_versions[key] = version
        return wire

    def get(self, field: str, kind: str, idx: int):
        """The committed host payload. Under write-back residency the
        committed version may live on the device only: reading the
        host's stale bytes then raises (flush first)."""
        if not self.host_current(field, kind, idx):
            raise RuntimeError(
                f"host payload of {field}.{kind}{idx} is stale (v"
                f"{self.host_version_of(field, kind, idx)} < committed v"
                f"{self.version_of(field, kind, idx)}): flush first"
            )
        return self._units[(field, kind, idx)]

    def version_of(self, field: str, kind: str, idx: int) -> int:
        """Committed writebacks since seeding (0 = still the seed),
        device-only commits included."""
        return self._versions.get((field, kind, idx), 0)

    def host_version_of(self, field: str, kind: str, idx: int) -> int:
        """Version of the payload actually held on the host."""
        return self._host_versions.get((field, kind, idx), 0)

    def host_current(self, field: str, kind: str, idx: int) -> bool:
        """Whether the host payload realizes the committed version
        (false only between a device-side commit and its flush)."""
        key = (field, kind, idx)
        return (self._host_versions.get(key, 0)
                == self._versions.get(key, 0))

    def unit_keys(self) -> List[Tuple[str, str, int]]:
        """All stored unit keys, sorted."""
        return sorted(self._units)

    def host_payload(self, field: str, kind: str, idx: int,
                     min_version: int):
        """The host payload realizing at least ``min_version`` (a
        snapshot's frozen-cut read, which may be older than a later
        committed version); raises when the host copy is older."""
        have = self.host_version_of(field, kind, idx)
        if have < min_version:
            raise RuntimeError(
                f"host payload of {field}.{kind}{idx} is v{have}, older "
                f"than the cut's v{min_version}"
            )
        return self._units[(field, kind, idx)]

    def commit_device(self, field: str, kind: str, idx: int,
                      version: int) -> None:
        """Commit ``version`` with its payload resident on the device
        only (the write-back elision): the host entry is stale until a
        flush puts it. The caller keeps the payload resident and dirty
        until then."""
        key = (field, kind, idx)
        if version <= self._versions.get(key, 0):
            raise ValueError(
                f"device commit of {key} v{version} is not newer than "
                f"v{self._versions.get(key, 0)}"
            )
        self._versions[key] = version

    # ------------------------------------------------------------------
    # checkpoint serialization
    # ------------------------------------------------------------------
    def state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
        """Serializable snapshot ``(leaves, meta)`` in the reference's
        format: host numpy leaves and a per-unit table with codec
        descriptors, versions and crc32 digests."""
        leaves: Dict[str, np.ndarray] = {}
        units: Dict[str, Dict[str, object]] = {}
        for (field, kind, idx), stored in sorted(self._units.items()):
            if not self.host_current(field, kind, idx):
                raise RuntimeError(
                    f"state_dict of a stale host unit {field}.{kind}"
                    f"{idx}: flush residency first"
                )
            uleaves, meta = unit_shards(
                field, kind, idx, stored,
                self._versions.get((field, kind, idx), 0),
            )
            leaves.update(uleaves)
            units[f"{field}.{kind}{idx}"] = meta
        return leaves, {"units": units}

    def load_state(
        self,
        leaves: Dict[str, np.ndarray],
        meta: Dict[str, object],
    ) -> None:
        """Rebuild the store from a ``state_dict`` snapshot (the port's
        or the reference's): payloads, compressed-unit handles and the
        version vector. Every unit carrying a recorded ``crc32`` is
        re-digested and must match, or ``ChecksumError`` names it."""
        self._units.clear()
        self._versions.clear()
        self._host_versions.clear()
        self._crc.clear()
        for ukey, u in meta["units"].items():
            key = (u["field"], u["kind"], int(u["idx"]))
            # the store owns its bytes: copies, not views of the caller's
            if u["codec"] == "zfp":
                value: object = Compressed(
                    np.array(leaves[f"{ukey}.payload"], order="C"),
                    np.array(leaves[f"{ukey}.emax"], order="C"),
                    tuple(u["shape"]), int(u["planes"]),
                    int(u["ndim_spatial"]), u["dtype"],
                )
            else:
                value = np.array(leaves[ukey], order="C")
            ver = int(u["version"])
            crc = unit_checksum(value, ver)
            want = u.get("crc32")  # older snapshots carry none
            if want is not None and int(want) != crc:
                raise ChecksumError(
                    f"restore refused: unit {ukey} v{ver} does not "
                    f"match its recorded digest (expected "
                    f"{int(want):#010x}, got {crc:#010x}) — the "
                    "snapshot shard is corrupt"
                )
            self._units[key] = value
            self._crc[key] = crc
            self._versions[key] = ver
            self._host_versions[key] = ver

    def seed(self, full: Dict[str, np.ndarray]) -> None:
        """Initial decomposition of full host fields into host units,
        one unit at a time (compressed units are encoded on the
        device, each at its sweep-0 rate when a ``RateController`` is
        attached; rate None stores the unit raw)."""
        cfg, plan = self.cfg, self.plan
        for name, arr in full.items():
            spec = cfg.fields[name]
            if tuple(arr.shape) != tuple(cfg.shape):
                raise ValueError(
                    f"field {name} has shape {arr.shape}, not {cfg.shape}"
                )
            for kind, idx, (lo, hi) in plan.units():
                planes = spec.planes
                if spec.compressed and self.rates is not None:
                    planes = self.rates.rate_for(name, kind, idx, 0)
                # units take the config's dtype (a copy either way)
                part = np.asarray(arr[lo:hi], dtype=cfg.dtype)
                if planes is not None:
                    unit = zfp_ops.compress(
                        to_device(part, self.device),
                        planes=planes, ndim=3, backend=cfg.backend,
                    )
                else:
                    unit = np.array(part)
                # seeding is host-local decomposition, not a crossing
                self.put(name, kind, idx, unit, on_wire=False)

    def stage(self, field: str, kind: str, idx: int):
        """Host -> device for one unit WITHOUT decompressing.

        Returns ``(device_value, raw_bytes, wire_bytes)`` where
        ``device_value`` is a device tensor or an on-device
        ``Compressed``. The crossing is checked against the crc recorded
        when the unit was committed.
        """
        key = (field, kind, idx)
        stored = self.get(field, kind, idx)
        stored = self._wire("h2d", field, kind, idx,
                            self.host_version_of(field, kind, idx), stored,
                            self._crc[key])
        raw, wire = unit_bytes(stored)
        if isinstance(stored, Compressed):
            dev = Compressed(
                to_device(stored.payload, self.device),
                to_device(stored.emax, self.device),
                stored.shape, stored.planes, stored.ndim_spatial,
                stored.dtype,
            )
            return dev, raw, wire
        return to_device(stored, self.device), raw, wire

    def cross_h2d(self, field: str, kind: str, idx: int, send) -> None:
        """The live engine's H2D crossing of one unit: its transport
        moved the committed host payload and digested what crossed;
        ``send`` (see ``_wire``) hands that over and moves the unit
        again on a retry. Verified against the recorded digest under
        the retry policy, before the caller may decode the unit."""
        key = (field, kind, idx)
        self._wire("h2d", field, kind, idx,
                   self.host_version_of(field, kind, idx),
                   self.get(field, kind, idx), self._crc[key], send)

    def checksum_of(self, field: str, kind: str, idx: int) -> int:
        """The recorded integrity digest of the committed host payload."""
        return self._crc[(field, kind, idx)]

    def gather(self, name: str) -> np.ndarray:
        """Reassemble a full field from host units, decoding compressed
        units on the device."""
        cfg = self.cfg
        out = np.zeros(cfg.shape, dtype=cfg.dtype)
        comp_spans: List[Tuple[int, int]] = []
        comp_payloads: List[Compressed] = []
        for kind, idx, (lo, hi) in self.plan.units():
            stored = self.get(name, kind, idx)
            if isinstance(stored, Compressed):
                dev, _, _ = self.stage(name, kind, idx)
                comp_spans.append((lo, hi))
                comp_payloads.append(dev)
            else:
                out[lo:hi] = stored
        if comp_payloads:
            decoded = zfp_ops.decompress_units(
                comp_payloads, backend=cfg.backend
            )
            for (lo, hi), arr in zip(comp_spans, decoded):
                out[lo:hi] = to_host(arr)
        return out


class OutOfCoreWave:
    """The paper's out-of-core acoustic propagator (synchronous).

    One block visit at a time: fetch, decompress, compute, compress,
    write back, then the next block. The numerics ground truth of the
    port.

    ``temporal=k`` fuses ``k`` sweeps per visit: every visit fetches
    the halo-k widened footprint, advances ``bt*k`` steps on the device,
    and writes each unit back once with ``k`` version bumps.

    ``rates`` (a ``ratecontrol.RateController``) gives each unit its own
    encode rate per sweep (None = raw) and observes every writeback's
    round-trip error; ``mode="fixed"`` is bit-identical to none.
    """

    def __init__(
        self,
        cfg: OOCConfig,
        p_prev: np.ndarray,
        p_cur: np.ndarray,
        vel2: np.ndarray,
        temporal: int = 1,
        rates=None,
    ):
        self._setup(cfg, temporal, rates)
        self.store.seed({"p_prev": p_prev, "p_cur": p_cur, "vel2": vel2})

    @classmethod
    def from_state(
        cls,
        cfg: OOCConfig,
        leaves: Dict[str, np.ndarray],
        meta: Dict[str, object],
        sweeps_done: int = 0,
        temporal: int = 1,
    ) -> "OutOfCoreWave":
        """An engine whose store holds a ``state_dict`` snapshot (its
        crc32 digests verified) instead of freshly seeded fields."""
        eng = cls.__new__(cls)
        eng._setup(cfg, temporal, None)
        eng.store.load_state(leaves, meta)
        for name in cfg.fields:
            for kind, idx, (lo, hi) in eng.plan.units():
                stored = eng.store.get(name, kind, idx)
                z = stored.shape[0]
                if z != hi - lo:
                    raise ValueError(
                        f"unit {name}.{kind}{idx} holds {z} planes, the "
                        f"plan (temporal={temporal}) wants {hi - lo}"
                    )
        eng.sweeps_done = int(sweeps_done)
        return eng

    def _setup(self, cfg: OOCConfig, temporal: int, rates) -> None:
        self.device = engine_device(cfg)
        self.cfg = cfg
        self.temporal = temporal
        self.plan = cfg.temporal_plan(temporal)
        self.plan.check_cover()
        self.rates = rates
        self.store = HostUnitStore(cfg, plan=self.plan, rates=rates)
        self.transfers: List[Transfer] = []
        self.sweeps_done = 0

    # ------------------------------------------------------------------
    def _fetch_unit(self, name: str, kind: str, idx: int, sweep: int,
                    block: int) -> torch.Tensor:
        """Host -> device for one unit, decompressing on the device."""
        dev, raw, wire = self.store.stage(name, kind, idx)
        self.transfers.append(Transfer(
            "h2d", name, (kind, idx), raw, wire, sweep, block
        ))
        if isinstance(dev, Compressed):
            return zfp_ops.decompress(dev, backend=self.cfg.backend)
        return dev

    def _write_unit(self, name: str, kind: str, idx: int,
                    value: torch.Tensor, sweep: int, block: int,
                    bump: int = 1) -> None:
        """Device -> host for one unit, compressing on the device.
        ``bump`` is the number of sweeps this writeback commits."""
        spec = self.cfg.fields[name]
        raw = value.numel() * value.element_size()
        ver = self.store.version_of(name, kind, idx) + bump
        planes = spec.planes
        if self.rates is not None:
            planes = self.rates.rate_for(name, kind, idx, sweep)
        if planes is not None:
            if self.rates is not None and spec.compressed:
                q = zfp_ops.quantize(value, planes=planes, ndim=3)
                self.rates.observe(name, kind, idx, planes,
                                   float((q - value).abs().max()),
                                   float(value.abs().max()))
            value = zfp_ops.compress(
                value, planes=planes, ndim=3, backend=self.cfg.backend
            )
        elif self.rates is not None and spec.compressed:
            # lossless commit: zero error at the unit's amplitude
            self.rates.observe(name, kind, idx, None, 0.0,
                               float(value.abs().max()))
        wire = self.store.put(name, kind, idx, value, version=ver)
        self.transfers.append(
            Transfer("d2h", name, (kind, idx), raw, wire, sweep, block)
        )

    # ------------------------------------------------------------------
    def _assemble(self, name: str, i: int, shared: Optional[torch.Tensor],
                  sweep: int) -> torch.Tensor:
        """Build the fetched (B+2H, Y, X) device field for block i."""
        plan = self.plan
        h, b = plan.halo, plan.block
        _, y, x = self.cfg.shape

        dtype = getattr(torch, self.cfg.dtype)

        def zeros(n):
            return torch.zeros((n, y, x), dtype=dtype, device=self.device)

        pieces = []
        if i == 0:
            pieces.append(zeros(h))
        elif shared is not None:
            pieces.append(shared)  # C_{i-1} already on the device
        else:
            pieces.append(self._fetch_unit(name, "C", i - 1, sweep, i))
        pieces.append(self._fetch_unit(name, "R", i, sweep, i))
        if i < plan.ndiv - 1:
            pieces.append(self._fetch_unit(name, "C", i, sweep, i))
        else:
            pieces.append(zeros(h))
        out = torch.cat(pieces, dim=0)
        assert out.shape[0] == b + 2 * h, out.shape
        return out

    # ------------------------------------------------------------------
    def sweep(self, sweeps: Optional[int] = None) -> None:
        """One pass over all blocks; advances the volume by
        ``bt * sweeps`` steps (``sweeps`` defaults to the engine's
        temporal fusion and may be smaller on a truncated final round)."""
        cfg, plan = self.cfg, self.plan
        kr = self.temporal if sweeps is None else sweeps
        if not 1 <= kr <= self.temporal:
            raise ValueError(f"sweeps={kr} outside 1..{self.temporal}")
        h, b = plan.halo, plan.block
        sweep_no = self.sweeps_done
        held: Dict[str, torch.Tensor] = {}  # lower half of C_{i-1} at t+bt
        shared: Dict[str, Optional[torch.Tensor]] = {
            n: None for n in cfg.fields
        }
        for i in range(plan.ndiv):
            dev: Dict[str, torch.Tensor] = {}
            new_shared: Dict[str, torch.Tensor] = {}
            for name in cfg.fields:
                arr = self._assemble(name, i, shared[name], sweep_no)
                if i < plan.ndiv - 1:
                    # keep the time-t common region for block i+1
                    new_shared[name] = arr[b : b + 2 * h]
                dev[name] = arr
            pp, pc = stencil_ops.fused_temporal_steps(
                dev["p_prev"], dev["p_cur"], dev["vel2"],
                steps=cfg.bt * kr, backend=cfg.backend,
            )
            s, _ = plan.owned(i)
            for name, new in (("p_prev", pp), ("p_cur", pc)):
                owned = new[h : h + b]
                rlo, rhi = plan.remainder(i)
                self._write_unit(
                    name, "R", i, owned[rlo - s : rhi - s], sweep_no, i,
                    bump=kr,
                )
                if i > 0:
                    cm = torch.cat([held[name + str(i - 1)], owned[:h]])
                    self._write_unit(
                        name, "C", i - 1, cm, sweep_no, i, bump=kr
                    )
                if i < plan.ndiv - 1:
                    held[name + str(i)] = owned[b - h : b]
            shared = {n: new_shared.get(n) for n in cfg.fields}
        self.sweeps_done += kr
        if self.rates is not None:
            # sweep boundary: the new rate map applies from the next
            # sweep on (the live engine decides at the same point)
            self.rates.decide(self.sweeps_done)

    def run(self, total_steps: int) -> None:
        if total_steps % self.cfg.bt:
            raise ValueError(
                f"total_steps={total_steps} is not a multiple of "
                f"bt={self.cfg.bt}"
            )
        remaining = total_steps // self.cfg.bt
        while remaining:
            kr = min(self.temporal, remaining)
            self.sweep(kr)
            remaining -= kr

    def finish(self) -> None:
        """The live engine's drain, for a common interface: this engine
        writes back within each sweep, so there is nothing to drain."""

    # ------------------------------------------------------------------
    def gather(self, name: str) -> np.ndarray:
        return self.store.gather(name)

    # ------------------------------------------------------------------
    def transfer_summary(self) -> Dict[str, int]:
        return summarize_transfers(self.transfers)

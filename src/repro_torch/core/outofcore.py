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
with an explicit copy. Every crossing is crc32-checked.

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
from repro_torch.kernels.zfp.ref import FLOAT64_TODO, Compressed

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
    """The four experiment codes of §VI. Rates are the f32-native
    equivalents of the paper's f64 32/64 and 24/64 (same ratios)."""
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
    ):
        self.cfg = cfg
        self.device = device_mod.resolve(cfg.device)
        # the unit layout this store is decomposed under — a temporal-k
        # engine passes its halo-widened plan
        self.plan = plan if plan is not None else cfg.plan
        self._units: Dict[Tuple[str, str, int], object] = {}
        # the version each host payload realizes: writebacks since
        # seeding, in sweeps (seeded units are v0)
        self._versions: Dict[Tuple[str, str, int], int] = {}
        # crc32 of each host payload: recorded at every put, verified
        # at every crossing and at restore
        self._crc: Dict[Tuple[str, str, int], int] = {}
        self.injector = injector
        self.retry = retry
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
    def _wire(self, op: str, field: str, kind: str, idx: int,
              version: int, host, crc: int):
        """One integrity-checked link crossing under the retry policy.

        ``host`` is the host-side value and ``crc`` the checksum it must
        realize. Each attempt consults the injector (transfer failure or
        in-flight bit flip), then verifies the received bytes against
        ``crc``. Failed attempts retry up to ``retry.attempts`` with
        accounted (never slept) backoff; exhaustion raises
        ``UnrecoverableFault`` chaining the last failure.
        """
        unit = f"{kind}{idx}"
        attempts = self.retry.attempts if self.retry else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.wire_stats[f"{op}_retries"] += 1
                if self.retry is not None:
                    self.backoff_s += self.retry.backoff(attempt)
            fault = None
            if self.injector is not None:
                fault = self.injector.transfer_fault(
                    op, field, unit, version, attempt
                )
            if fault == "transfer":
                self.wire_stats["wire_faults"] += 1
                last = InjectedFault(
                    f"injected {op} failure: {field}.{unit} "
                    f"v{version} attempt {attempt}"
                )
                continue
            received = host
            if fault == "corrupt":
                self.wire_stats["wire_faults"] += 1
                if isinstance(host, Compressed):
                    received = Compressed(
                        FaultInjector.corrupt(host.payload), host.emax,
                        host.shape, host.planes, host.ndim_spatial,
                        host.dtype,
                    )
                else:
                    received = FaultInjector.corrupt(host)
            got = unit_checksum(received, version)
            if got != crc:
                self.wire_stats["checksum_failures"] += 1
                last = ChecksumError(
                    f"{op} checksum mismatch for unit {field}.{unit} "
                    f"v{version}: expected {crc:#010x}, got {got:#010x}"
                )
                continue
            if self.injector is not None and self.injector.straggle(
                op, field, unit, version
            ) > 1.0:
                self.wire_stats["wire_stragglers"] += 1
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
    ) -> int:
        """Store; returns wire bytes (what crossed the link).

        ``version`` pins the committed version this payload realizes;
        without it the counter bumps by one. A device value is copied
        to the host here (the D2H); the crossing is integrity-checked.
        ``on_wire=False`` marks a host-local put (seeding) that never
        crosses the link: exempt from injection, but still digested.
        """
        key = (field, kind, idx)
        if version is None:
            version = self._versions.get(key, -1) + 1
        if version < self._versions.get(key, 0):
            raise ValueError(f"put of {key} v{version} older than the host")
        host = _host_value(value)
        wire = host.nbytes() if isinstance(host, Compressed) else host.nbytes
        crc = unit_checksum(host, version)
        if on_wire:
            host = self._wire("d2h", field, kind, idx, version, host, crc)
        self._units[key] = host
        self._crc[key] = crc
        self._versions[key] = version
        return wire

    def get(self, field: str, kind: str, idx: int):
        return self._units[(field, kind, idx)]

    def version_of(self, field: str, kind: str, idx: int) -> int:
        """Committed writebacks since seeding (0 = still the seed)."""
        return self._versions.get((field, kind, idx), 0)

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

    def seed(self, full: Dict[str, np.ndarray]) -> None:
        """Initial decomposition of full host fields into host units,
        one unit at a time (compressed units are encoded on the
        device)."""
        cfg, plan = self.cfg, self.plan
        for name, arr in full.items():
            spec = cfg.fields[name]
            if tuple(arr.shape) != tuple(cfg.shape):
                raise ValueError(
                    f"field {name} has shape {arr.shape}, not {cfg.shape}"
                )
            for kind, idx, (lo, hi) in plan.units():
                if spec.compressed:
                    unit = zfp_ops.compress(
                        to_device(arr[lo:hi], self.device),
                        planes=spec.planes, ndim=3, backend=cfg.backend,
                    )
                else:
                    unit = np.array(arr[lo:hi])
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
        stored = self._units[key]
        version = self._versions.get(key, 0)
        stored = self._wire("h2d", field, kind, idx, version, stored,
                            self._crc[key])
        if isinstance(stored, Compressed):
            dev = Compressed(
                to_device(stored.payload, self.device),
                to_device(stored.emax, self.device),
                stored.shape, stored.planes, stored.ndim_spatial,
                stored.dtype,
            )
            raw = int(np.prod(stored.shape)) * np.dtype(stored.dtype).itemsize
            return dev, raw, stored.nbytes()
        return to_device(stored, self.device), stored.nbytes, stored.nbytes

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
    """

    def __init__(
        self,
        cfg: OOCConfig,
        p_prev: np.ndarray,
        p_cur: np.ndarray,
        vel2: np.ndarray,
        temporal: int = 1,
    ):
        self._setup(cfg, temporal)
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
        eng._setup(cfg, temporal)
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

    def _setup(self, cfg: OOCConfig, temporal: int) -> None:
        if cfg.dtype != "float32":
            raise NotImplementedError(FLOAT64_TODO)
        self.device = device_mod.resolve(cfg.device)
        if cfg.backend not in ("ref", "cuda"):
            raise ValueError(
                f"backend must be 'ref' or 'cuda', got {cfg.backend!r}"
            )
        if cfg.backend == "cuda" and self.device.type != "cuda":
            raise ValueError(
                "backend='cuda' runs the CUDA kernels and needs a CUDA "
                "device; use backend='ref' with device='cpu'"
            )
        self.cfg = cfg
        self.temporal = temporal
        self.plan = cfg.temporal_plan(temporal)
        self.plan.check_cover()
        self.store = HostUnitStore(cfg, plan=self.plan)
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
        if spec.compressed:
            value = zfp_ops.compress(
                value, planes=spec.planes, ndim=3, backend=self.cfg.backend
            )
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

        def zeros(n):
            return torch.zeros((n, y, x), dtype=torch.float32,
                               device=self.device)

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

    # ------------------------------------------------------------------
    def gather(self, name: str) -> np.ndarray:
        return self.store.gather(name)

    # ------------------------------------------------------------------
    def transfer_summary(self) -> Dict[str, int]:
        return summarize_transfers(self.transfers)

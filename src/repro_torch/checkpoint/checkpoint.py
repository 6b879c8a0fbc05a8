"""Fault-tolerant checkpointing.

Port of ``repro.checkpoint.checkpoint``; the on-disk format is the
reference's, byte for byte, so a snapshot written by either package
loads in the other:

* Atomic: write to ``<dir>/tmp.<step>``, fsync, ``os.replace`` to
  ``step_<k>``, so a preempted writer never corrupts the latest one.
* Sharded: each leaf is its own file, with the crc32 of its on-disk
  bytes in the manifest; the manifest digests itself
  (``manifest_crc32``, over its sorted-key JSON).
* Lossless-compressed with zstd when available (``zstd_level > 0``);
  ``zstd_level=0`` stores leaves raw, so checkpointing never needs the
  optional ``zstandard`` package. Optionally lossy: float32 leaves of
  1024 elements or more go through the fixed-rate ZFP codec at ndim 1
  (``lossy_planes``), on the CUDA device with the ``csrc/zfp.cu``
  kernels, or with the plain version when the caller passes
  ``device="cpu"``. The device is resolved only when a leaf is coded,
  so a checkpoint without lossy leaves touches no device.
* Self-describing: the manifest carries an ``extra`` JSON payload (the
  live engine's progress record and unit table).

A tree is nested ``dict``/``list``/``tuple`` (and namedtuples) of
numpy arrays or torch tensors on any device; its flat keys are the
reference's (dict keys sorted, sequence indices, joined by ``/``).
A ``bfloat16`` tensor is written as its 16-bit patterns under the dtype
name ``"bfloat16"`` (the name the reference's leaves carry) and read
back as a ``torch.bfloat16`` tensor through a ``uint16`` view; every
other leaf comes back as a host numpy array.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.distributed.fault import (
    ChecksumError,
    InjectedFault,
    UnrecoverableFault,
)

try:  # optional dep: only needed when (de)compressing checkpoints
    import zstandard

    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - exercised on minimal installs
    zstandard = None
    HAVE_ZSTD = False

from repro_torch.kernels.zfp import ops as zfp_ops
from repro_torch.kernels.zfp.ref import Compressed

_FLAT_SEP = "/"
LOSSY_MIN_SIZE = 1024  # smallest float32 leaf the lossy codec takes


def _require_zstd():
    if not HAVE_ZSTD:
        raise ModuleNotFoundError(
            "checkpoint compression requires the optional 'zstandard' "
            "package; pass zstd_level=0 to store leaves raw"
        )
    return zstandard


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _items(node):
    """``[(path element, child)]`` of a container node in flatten order,
    or None for a leaf (None itself has no leaves)."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree) -> Dict[str, Any]:
    """``{flat key: leaf}`` in the reference's order and naming."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        items = _items(node)
        if items is None:
            out[_FLAT_SEP.join(str(p) for p in path)] = node
            return
        for key, child in items:
            walk(child, path + (key,))

    walk(tree, ())
    return out


def _unflatten(like, leaves: Dict[str, Any]):
    """``like``'s structure with its leaves taken from ``leaves``."""

    def build(node, path):
        if node is None:
            return None
        items = _items(node)
        if items is None:
            return leaves[_FLAT_SEP.join(str(p) for p in path)]
        if isinstance(node, dict):
            return type(node)(
                (k, build(v, path + (k,))) for k, v in node.items())
        kids = [build(v, path + (k,)) for k, v in items]
        if _is_namedtuple(node):
            return type(node)(*kids)
        return type(node)(kids)

    return build(like, ())


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """``(host array, dtype name)`` of a leaf; a bfloat16 tensor becomes
    its uint16 bit patterns under the name ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        if t.dtype == torch.uint32:
            return t.view(torch.int32).cpu().numpy().view(np.uint32), \
                "uint32"
        arr = t.cpu().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _bytes_of(arr: np.ndarray) -> memoryview:
    """The C-order bytes of ``arr`` (``arr.tobytes()``, without a copy
    when it is contiguous already)."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a host array (a copy when it is read-only, as
    the arrays ``load`` reads are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _device_u32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 host array on ``device`` (crossing as int32)."""
    return _tensor(a.view(np.int32)).to(device).view(torch.uint32)


def _lossy_route(device) -> Tuple[torch.device, str]:
    """The device and codec backend for lossy leaves: the kernels on a
    CUDA device, the plain version only on the CPU asked for by name."""
    dev = device_mod.resolve(device)
    return dev, ("cuda" if dev.type == "cuda" else "ref")


class ShardWriter:
    """Incremental checkpoint writer: one durable shard at a time.

    The atomic-persist machinery of ``save`` (tmp dir, per-shard fsync,
    manifest fsync, ``os.replace`` publish, gc) as a stateful writer, so
    the live engine's overlapped cut persists its snapshot a few units a
    block visit. Until ``finalize`` the checkpoint lives in
    ``tmp.<step>/``, which ``latest()`` ignores: a writer that dies
    mid-snapshot leaves the previous checkpoint intact.

    ``add`` writes one leaf (zstd or raw, optionally lossy-ZFP float32);
    ``add_external`` records a leaf that lives in an earlier checkpoint;
    ``set_extra`` replaces the manifest's ``extra`` before ``finalize``;
    ``abort`` discards the tmp dir. ``injector``/``retry``/``stats``
    replay a ``FaultPlan``'s shard-write failures under a bounded retry
    (``stats.shard_retries`` mirrors ``shard_retries``). ``device`` is
    where lossy leaves are coded (resolved at the first one).
    ``crc_s`` and ``write_s`` sum the seconds in the shards' crc32 and
    in their writes with fsync.
    """

    def __init__(
        self,
        directory: str,
        step: int,
        *,
        zstd_level: Optional[int] = None,
        lossy_planes: Optional[int] = None,
        extra: Optional[Dict[str, Any]] = None,
        injector=None,
        retry=None,
        stats=None,
        device=None,
    ):
        self.injector = injector
        self.retry = retry
        self.stats = stats
        self.device = device
        self.shard_retries = 0
        self.crc_s = 0.0
        self.write_s = 0.0
        if zstd_level is None:
            zstd_level = 3 if HAVE_ZSTD else 0
        self._cctx = (
            _require_zstd().ZstdCompressor(level=zstd_level)
            if zstd_level > 0 else None
        )
        self._base_codec = "zstd" if self._cctx else "raw"
        self._lossy_planes = lossy_planes
        self.step = int(step)
        self.base = pathlib.Path(directory)
        self.base.mkdir(parents=True, exist_ok=True)
        self.tmp = self.base / f"tmp.{step}"
        if self.tmp.exists():
            shutil.rmtree(self.tmp)
        self.tmp.mkdir()
        self._manifest: Dict[str, Any] = {
            "step": self.step, "leaves": {}, "extra": extra or {},
        }
        self._finalized = False

    def set_extra(self, extra: Dict[str, Any]) -> None:
        self._manifest["extra"] = extra

    def _lossy_blob(self, arr: np.ndarray):
        """The ``zfp+`` blob of a float32 leaf: 8-byte block count, the
        uint32 payload, the int16 emax."""
        dev, backend = _lossy_route(self.device)
        c = zfp_ops.compress(_tensor(arr.reshape(-1)).to(dev),
                             planes=self._lossy_planes, ndim=1,
                             backend=backend)
        payload = c.payload.view(torch.int32).cpu().numpy().view(np.uint32)
        emax = c.emax.cpu().numpy().astype(np.int16)
        blob = (len(payload).to_bytes(8, "little") + payload.tobytes()
                + emax.tobytes())
        return blob, int(payload.shape[1])

    def add(self, key: str, leaf) -> int:
        """Durably write one leaf shard; returns its on-disk bytes."""
        assert not self._finalized, "writer already finalized"
        arr, dtype = _host_leaf(leaf)
        fname = key.replace(_FLAT_SEP, "__") + (
            ".zst" if self._cctx else ".bin"
        )
        entry = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype,
            "codec": self._base_codec,
        }
        if (
            self._lossy_planes
            and arr.dtype == np.float32
            and arr.size >= LOSSY_MIN_SIZE
        ):
            blob, words = self._lossy_blob(arr)
            entry.update(
                codec=f"zfp+{self._base_codec}",
                planes=self._lossy_planes,
                payload_words=words,
            )
        else:
            blob = _bytes_of(arr)
        if self._cctx:
            blob = self._cctx.compress(blob)
        # per-shard digest of the on-disk bytes, verified on every load
        t0 = time.perf_counter()
        entry["crc32"] = zlib.crc32(blob) & 0xFFFFFFFF
        t1 = time.perf_counter()
        attempts = self.retry.attempts if self.retry is not None else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if attempt:
                self.shard_retries += 1
                if self.stats is not None:
                    self.stats.shard_retries += 1
            if self.injector is not None and self.injector.shard_fault(
                key, attempt
            ):
                last = InjectedFault(
                    f"injected shard-write failure: {key} "
                    f"attempt {attempt}"
                )
                continue
            _write_durable(self.tmp / fname, blob)
            break
        else:
            raise UnrecoverableFault(
                f"shard write of {key} failed after {attempts} "
                f"attempt(s): {last}"
            ) from last
        self.crc_s += t1 - t0
        self.write_s += time.perf_counter() - t1
        self._manifest["leaves"][key] = entry
        return len(blob)

    def add_external(
        self, key: str, entry: Dict[str, Any], source_dir: str,
    ) -> int:
        """Record a leaf that already lives, byte-identical, in an
        earlier published checkpoint (the incremental snapshot): its
        entry points at the original directory (chains flatten), and the
        reference-aware gc keeps that directory while a kept manifest
        needs it. Returns 0 (no bytes written)."""
        assert not self._finalized, "writer already finalized"
        new = dict(entry)
        new["dir"] = entry.get("dir", source_dir)
        self._manifest["leaves"][key] = new
        return 0

    def finalize(self, keep: int = 3) -> str:
        """Write the self-digesting manifest, publish ``step_<k>``
        atomically (directory fsyncs around the rename), gc."""
        assert not self._finalized, "writer already finalized"
        manifest = dict(self._manifest)
        manifest["manifest_crc32"] = _manifest_digest(manifest)
        _write_durable(
            self.tmp / "manifest.json",
            json.dumps(manifest).encode(),
        )
        _fsync_dir(self.tmp)
        final = self.base / f"step_{self.step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(self.tmp, final)
        _fsync_dir(self.base)
        _gc(self.base, keep)
        self._finalized = True
        return str(final)

    def abort(self) -> None:
        """Discard the tmp dir; the previous checkpoint stays live."""
        if not self._finalized and self.tmp.exists():
            shutil.rmtree(self.tmp)
        self._finalized = True


def _manifest_digest(manifest: Dict[str, Any]) -> int:
    """crc32 over the canonical (sorted-key) JSON of the manifest with
    the digest key itself excluded."""
    body = {k: v for k, v in manifest.items() if k != "manifest_crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True).encode()
    ) & 0xFFFFFFFF


def save(
    directory: str,
    step: int,
    tree,
    *,
    zstd_level: Optional[int] = None,
    lossy_planes: Optional[int] = None,
    keep: int = 3,
    extra: Optional[Dict[str, Any]] = None,
    injector=None,
    retry=None,
    stats=None,
    device=None,
) -> str:
    """Atomically persist ``tree`` as ``<directory>/step_<step>``.

    ``zstd_level``: a positive level needs ``zstandard``, ``0`` stores
    leaves raw, ``None`` picks zstd when installed and raw otherwise.
    ``lossy_planes`` codes large float32 leaves with the fixed-rate ZFP
    codec on ``device`` (default the CUDA device). ``extra`` is embedded
    verbatim in the manifest. Returns the final path."""
    w = ShardWriter(
        directory, step, zstd_level=zstd_level,
        lossy_planes=lossy_planes, extra=extra,
        injector=injector, retry=retry, stats=stats, device=device,
    )
    try:
        for key, leaf in _flatten(tree).items():
            w.add(key, leaf)
    except BaseException:
        w.abort()
        raise
    return w.finalize(keep=keep)


def _write_durable(path: pathlib.Path, blob) -> None:
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


def _fsync_dir(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _gc(base: pathlib.Path, keep: int) -> None:
    """Drop all but the last ``keep`` checkpoints, except directories a
    retained manifest's external (``dir``) entries point into."""
    ckpts = sorted(p for p in base.iterdir() if p.name.startswith("step_"))
    retained = ckpts[-keep:] if keep > 0 else []
    referenced = {p.name for p in retained}
    for p in retained:
        try:
            manifest = json.loads((p / "manifest.json").read_text())
        except (OSError, ValueError):  # unreadable: nothing to pin
            continue
        for entry in manifest.get("leaves", {}).values():
            d = entry.get("dir")
            if d:
                referenced.add(d)
    for p in ckpts[:-keep] if keep > 0 else ckpts:
        if p.name not in referenced:
            shutil.rmtree(p)


def latest(directory: str) -> Optional[str]:
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    ckpts = sorted(p for p in base.iterdir() if p.name.startswith("step_"))
    return str(ckpts[-1]) if ckpts else None


def read_manifest(path: str) -> Dict[str, Any]:
    """The checkpoint's manifest (step, leaf table, extra), refused with
    ``ChecksumError`` naming the checkpoint when its recorded digest
    (absent in snapshots older than the digests) does not match."""
    manifest = json.loads(
        (pathlib.Path(path) / "manifest.json").read_text()
    )
    want = manifest.get("manifest_crc32")
    if want is not None and int(want) != _manifest_digest(manifest):
        raise ChecksumError(
            f"restore refused: manifest of checkpoint {path} does not "
            "match its recorded digest — the manifest (leaf table or "
            "extra payload) was modified after publish; restore from "
            "an earlier step_<k> directory"
        )
    return manifest


def _decode_leaf(p: pathlib.Path, entry: Dict[str, Any], device=None):
    # an external (incremental) entry lives in a sibling checkpoint
    # directory under the same root; its crc32 still guards the bytes
    src = p if "dir" not in entry else p.parent / entry["dir"]
    blob = (src / entry["file"]).read_bytes()
    want = entry.get("crc32")  # absent in snapshots before the digests
    if want is not None:
        got = zlib.crc32(blob) & 0xFFFFFFFF
        if got != int(want):
            raise ChecksumError(
                f"restore refused: shard {entry['file']} in {p} is "
                f"corrupt (crc32 {got:#010x}, manifest records "
                f"{int(want):#010x}) — restore from an earlier "
                "step_<k> directory"
            )
    codec = entry["codec"]
    if codec.endswith("zstd"):
        blob = _require_zstd().ZstdDecompressor().decompress(blob)
    shape = tuple(entry["shape"])
    if codec.startswith("zfp+"):
        n = int.from_bytes(blob[:8], "little")
        w = entry["payload_words"]
        payload = np.frombuffer(
            blob[8 : 8 + n * w * 4], np.uint32
        ).reshape(n, w)
        emax = np.frombuffer(blob[8 + n * w * 4 :], np.int16)
        size = int(np.prod(shape))
        dev, backend = _lossy_route(device)
        c = Compressed(
            _device_u32(payload, dev),
            torch.from_numpy(emax.astype(np.int32)).to(dev),
            (((size + 3) // 4) * 4,),
            entry["planes"],
            1,
            "float32",
        )
        out = zfp_ops.decompress(c, backend=backend)
        return out.cpu().numpy()[:size].reshape(shape)
    if entry["dtype"] == "bfloat16":
        bits = np.frombuffer(blob, np.uint16).reshape(shape)
        return torch.from_numpy(bits.view(np.int16).copy()).view(
            torch.bfloat16)
    return np.frombuffer(blob, dtype=np.dtype(entry["dtype"])).reshape(shape)


def load(path: str, device=None) -> Tuple[int, Dict[str, Any],
                                          Dict[str, Any]]:
    """Every leaf of one checkpoint, without a template tree:
    ``(step, {flat key: array}, extra)`` in manifest order. Lossy leaves
    decode on ``device`` (default the CUDA device)."""
    p = pathlib.Path(path)
    manifest = read_manifest(path)
    out = {
        key: _decode_leaf(p, entry, device)
        for key, entry in manifest["leaves"].items()
    }
    return manifest["step"], out, manifest.get("extra", {})


def restore(path: str, like_tree, device=None) -> Tuple[int, Any]:
    """``(step, tree shaped like like_tree)`` of host arrays."""
    step, out, _ = load(path, device)
    return step, _unflatten(like_tree, out)


def place(tree, axes_tree, mesh, rules):
    """Elastic resharding: put host arrays (or tensors) onto ``mesh``
    as DTensors, each leaf at the placements its logical axes resolve
    to (``sharding.named_sharding_tree``); every rank of the mesh calls
    it with the same tree. The leaves go to the mesh's device type."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import map_axes, placements, \
        resolve_spec

    def put(axes, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else _tensor(
            np.asarray(leaf))
        spec = resolve_spec(axes, tuple(t.shape), rules, mesh)
        return distribute_tensor(t.to(mesh.device_type), mesh,
                                 placements(spec, mesh))

    return map_axes(put, axes_tree, tree)

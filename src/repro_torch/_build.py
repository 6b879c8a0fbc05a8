"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library is named by a hash of its source, the shared
headers and the flags, and lives under ``build/repro_torch/`` at the
root of the checkout, so an edited source is rebuilt and an unchanged
one is reused. Nothing is built when a module is imported: the first
kernel call (or ``build_all``) builds. ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Flags of each source besides. The codec and stencil kernels (float32 in
# zfp and stencil, float64 in zfp64 and stencil64) are held bit for bit, so
# no multiply-add is contracted to an FMA; the attention kernel's decode
# rounds explicitly (__int2float_rn, __fmul_rn) and its dot products, held
# to 2e-5, may contract, as may the scan, held to rtol 1e-4 / atol 1e-5
# (and to a float64 recurrence in chip_smoke.py).
SOURCE_FLAGS = {
    "zfp": ("-fmad=false",),
    "stencil": ("-fmad=false",),
    "zfp64": ("-fmad=false",),
    "stencil64": ("-fmad=false",),
    "cdecode": (),
    "sscan": (),
}
SOURCES = tuple(SOURCE_FLAGS)

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise KernelError(
            "nvcc not found: the CUDA kernels build only on a machine "
            "with the CUDA toolkit"
        )
    return exe


def flags(name: str):
    """The ``nvcc`` flags of ``csrc/<name>.cu``."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS[name])


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source: ``(process, temp path, library
    path)``, or None if the library is built already."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.Popen(
        [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one build; move the library into place (atomically, so
    concurrent builds never load a partial file); return the
    compiler's output (register and spill report)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every source in parallel (one ``nvcc`` each); returns the
    compiler output per source (empty for a source already built)."""
    procs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, proc) for name, proc in procs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def bind(name: str, symbol: str, argtypes: List[type]):
    """One C entry point with its argument types declared; returns an
    ``int`` (the ``cudaError_t`` after the launch)."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise ``KernelError`` when a launch in ``csrc/<name>.cu``
    returned a CUDA error (refused launch or earlier fault)."""
    if err != 0:
        describe = getattr(library(name), f"{name}_error_string")
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise KernelError(
            f"{what}: CUDA error {err} ({describe(err).decode()})"
        )

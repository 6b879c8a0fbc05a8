"""Device resolution and card identification.

Every entry point of the port runs on the CUDA device unless its caller
asks for the CPU by name. Without a CUDA device and without that
request, ``resolve`` raises: the port never carries on quietly on the
CPU.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class NoCudaDevice(RuntimeError):
    """No CUDA device is present and the caller did not ask for the CPU."""


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    ``device="cpu"`` selects the plain PyTorch versions of the kernels;
    any CUDA device selects the hand-written kernels. A request for a
    CUDA device (explicit or by default) on a machine without one raises
    ``NoCudaDevice``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice(
            "no CUDA device is available; pass device='cpu' (and "
            "backend='ref') to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them
    (``--query-gpu=name,power.limit --format=csv,noheader``), first card
    only. Raises when ``nvidia-smi`` is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise FileNotFoundError("nvidia-smi not found on PATH")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def backend_for(where: Union[torch.Tensor, torch.device],
                backend: Optional[str] = None) -> str:
    """``backend`` if given, else the default for a tensor's (or a
    device's) place: ``"cuda"`` (the kernels) on a CUDA device, ``"ref"``
    (the plain versions) on the CPU."""
    if backend is not None:
        return backend
    dev = where.device if isinstance(where, torch.Tensor) else where
    return "cuda" if dev.type == "cuda" else "ref"


def check_backend(backend: str, *tensors: torch.Tensor) -> None:
    """Validate ``backend`` and, for ``"cuda"``, that every tensor is a
    CUDA tensor (no quiet switch to the plain version)."""
    if backend not in ("ref", "cuda"):
        raise ValueError(f"backend must be 'ref' or 'cuda', got {backend!r}")
    if backend == "cuda":
        for t in tensors:
            if t.device.type != "cuda":
                raise ValueError(
                    f"backend='cuda' needs CUDA tensors, got one on "
                    f"{t.device}; use backend='ref' for the CPU"
                )

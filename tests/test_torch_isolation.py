"""The port stands alone: it imports neither JAX nor the JAX package,
and its entry points never carry on quietly on the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.core.outofcore import HostUnitStore, OOCConfig, \
    OutOfCoreWave, paper_code_fields
from repro_torch.kernels.zfp import ops as zfp_ops

ROOT = Path(__file__).resolve().parents[1]

_CHILD = """
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_port_and_smoke_import_neither_jax_nor_repro():
    code = _CHILD.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was imported


def test_no_import_lines_of_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "repro"), (path, line)


def _cfg(**kw):
    return OOCConfig((96, 16, 16), 4, 2, paper_code_fields(4), **kw)


def _fields():
    z = torch.zeros((96, 16, 16)).numpy()
    return z, z, z


def test_engine_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice, match="device='cpu'"):
        OutOfCoreWave(_cfg(), *_fields())
    with pytest.raises(device_mod.NoCudaDevice):
        OutOfCoreWave(_cfg(backend="ref"), *_fields())
    with pytest.raises(device_mod.NoCudaDevice):
        HostUnitStore(_cfg(device="cuda"))
    assert device_mod.resolve("cpu") == torch.device("cpu")


def test_cuda_backend_on_cpu_tensor_raises():
    x = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        zfp_ops.compress(x, planes=12, backend="cuda")
    c = zfp_ops.compress(x, planes=12, backend="ref")
    with pytest.raises(ValueError, match="CUDA tensors"):
        zfp_ops.decompress(c, backend="cuda")


def test_serving_entry_points_without_device_raise(monkeypatch):
    import dataclasses

    from repro_torch.configs import get_config, smoke
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(smoke(get_config("qwen2-1.5b")),
                              kv_compress_planes=16)
    params = model.init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        model.init_params(cfg)
    with pytest.raises(device_mod.NoCudaDevice):
        ServeEngine(cfg, params)
    with pytest.raises(device_mod.NoCudaDevice):
        model.init_cache(cfg, 2, 128)
    with pytest.raises(device_mod.NoCudaDevice):
        serve.main(["--requests", "1"])
    with pytest.raises(device_mod.NoCudaDevice):
        serve.main(["--ooc"])


def test_cdecode_cuda_backend_on_cpu_tensor_raises():
    from repro_torch.kernels.cdecode import ops as cdecode_ops
    from repro_torch.models import kvcache

    ckv = kvcache.init_compressed_kv(1, 64, 2, 16, 16, device="cpu")
    q = torch.zeros((1, 1, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cdecode_ops.fused_compressed_decode_attention(
            q, ckv, planes=16, max_len=64, backend="cuda")
    out = cdecode_ops.fused_compressed_decode_attention(
        q, ckv, planes=16, max_len=64, backend="ref")
    assert out.shape == (1, 1, 4, 16)


def test_checkpoint_entry_points_without_device_raise(tmp_path,
                                                      monkeypatch):
    import numpy as np

    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core.executor import AsyncExecutor

    tree = {"w": np.ones(2048, np.float32)}
    path = ckpt.save(str(tmp_path / "lossy"), 1, tree, zstd_level=0,
                     lossy_planes=16, device="cpu")
    live = AsyncExecutor(_cfg(backend="ref", device="cpu"), *_fields())
    live.checkpoint(str(tmp_path / "run"), zstd_level=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.save(str(tmp_path / "b"), 1, tree, lossy_planes=16)
    with pytest.raises(device_mod.NoCudaDevice):
        ckpt.load(path)
    with pytest.raises(device_mod.NoCudaDevice):
        AsyncExecutor.restore(str(tmp_path / "run"))
    assert AsyncExecutor.restore(str(tmp_path / "run"),
                                 device="cpu").sweeps_done == 0

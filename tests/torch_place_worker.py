"""One rank of ``tests/test_torch_sharding.py``'s two-rank ``place``
check (a module of its own, so a spawned rank imports no JAX): joins a
gloo group through a ``FileStore``, places the smoke Qwen2-1.5B's
parameters on a (2, 1) and a (1, 2) mesh and writes, for each leaf, its
local shard shape, the shape its resolved spec gives, and whether the
gathered tensor is the original."""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, store_path: str, out_path: str) -> None:
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config, smoke
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import model as M

    store = dist.FileStore(store_path, 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    try:
        cfg = smoke(get_config("qwen2-1.5b"))
        model = M.init_params(cfg, device="cpu")
        tree = {k: v.detach().numpy() for k, v in model.named_parameters()}
        axes = M.param_logical_axes(cfg)
        out = {}
        for mp in (1, 2):
            mesh = tmesh.make_mesh_for_devices(2, mp)
            sizes = sh.axis_sizes(mesh)
            placed = ckpt.place(tree, axes, mesh, sh.DEFAULT_RULES)
            for name, t in placed.items():
                spec = sh.resolve_spec(axes[name], tree[name].shape,
                                       sh.DEFAULT_RULES, mesh)
                want = [n // (np.prod([sizes[a] for a in (
                    e if isinstance(e, tuple) else (e,))]) if e else 1)
                        for n, e in zip(tree[name].shape, spec)]
                out[f"{mp}/{name}"] = (
                    list(t.to_local().shape), [int(w) for w in want],
                    bool(np.array_equal(t.full_tensor().numpy(),
                                        tree[name])),
                    any(e is not None for e in spec))
        with open(out_path, "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), sys.argv[2], sys.argv[3])

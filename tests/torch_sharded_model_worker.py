"""One rank of ``tests/test_torch_sharded_model.py``'s gloo runs (a
module of its own, so a spawned rank imports no JAX): joins a gloo group
of 4 through a ``FileStore``, builds a (data 2, model 2) CPU mesh and,
for each architecture of the job file, runs the port's model on
DTensors placed as ``launch.steps.shardings_for`` places a step's
arguments (``distribute_tensor`` of the parameters, the batch and the
decode cache of an ``.npz``), under ``use_rules`` and
``implicit_replication()``:

- ``loss_fn`` and the gradient of every parameter (``train``);
- ``prefill``'s logits (``prefill``);
- ``STEPS`` ``decode_step``s from an empty raw cache (``decode``).

Rank 0 writes each result's ``full_tensor()`` to an ``.npz``:
``ARCH/loss``, ``ARCH/g/NAME``, ``ARCH/prefill``, ``ARCH/decode``.

    python tests/torch_sharded_model_worker.py RANK STORE JOBS.json OUT.npz

``JOBS.json``: ``{"archs": [...], "layers": {arch: n}, "inputs":
{arch: .npz of the parameters (by ``named_parameters`` name, under
``p/``), ``tokens``, ``labels``, ``positions`` and ``dec_tokens``},
"max_len": n}``.
"""

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _placed(t, placements, mesh):
    from torch.distributed.tensor import distribute_tensor

    if not isinstance(t, torch.Tensor):
        return t
    return distribute_tensor(t, mesh, placements)


def one_arch(arch, layers, inputs, max_len, mesh, rules):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M

    cfg = dataclasses.replace(smoke(get_config(arch)), num_layers=layers)
    toks = torch.from_numpy(inputs["tokens"])
    b, s = toks.shape
    out = {}

    def model_for(shape):
        shardings, _ = ST.shardings_for(cfg, shape, mesh, rules)
        model = M.init_params(cfg, device="meta")
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            setattr(mod, leaf, torch.nn.Parameter(_placed(
                torch.from_numpy(inputs["p/" + name]), shardings[0][name],
                mesh), requires_grad=False))
        return model, shardings

    def batch_of(names, shardings):
        return {n: _placed(torch.from_numpy(inputs[src]), shardings[-1][n],
                           mesh) for n, src in names.items()}

    with sh.use_rules(mesh, rules), implicit_replication():
        model, shardings = model_for(ShapeSpec("t", s, b, "train"))
        batch = batch_of({"tokens": "tokens", "labels": "labels",
                          "positions": "positions"}, shardings)
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        loss = M.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        out["loss"] = _whole(loss.detach()).numpy()
        for name, g in zip(params, grads):
            out["g/" + name] = _whole(g).numpy()

        with torch.inference_mode():
            model, shardings = model_for(ShapeSpec("p", s, b, "prefill"))
            batch = batch_of({"tokens": "tokens", "positions": "positions"},
                             shardings)
            logits, _ = M.prefill(cfg, model, batch["tokens"],
                                  batch["positions"])
            out["prefill"] = _whole(logits).numpy()

            shape = ShapeSpec("d", max_len, b, "decode")
            model, shardings = model_for(shape)
            cache = M.init_cache(cfg, b, max_len=max_len, device="cpu")
            cache = D._tree(lambda t, p: _placed(t, p, mesh), cache,
                            shardings[1])
            dec = inputs["dec_tokens"]
            steps = []
            for i in range(dec.shape[1]):
                t = _placed(torch.from_numpy(dec[:, i:i + 1].copy()),
                            shardings[-1]["tokens"], mesh)
                pos = _placed(torch.full((b, 1), i, dtype=torch.int32),
                              shardings[-1]["positions"], mesh)
                lg, cache = M.decode_step(cfg, model, cache, t, pos)
                steps.append(_whole(lg).numpy())
            out["decode"] = np.stack(steps)
    return out


def run(rank, store_path, jobs_path, out_path):
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as tmesh

    with open(jobs_path) as f:
        jobs = json.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = tmesh.make_mesh_for_devices(WORLD, 2, device="cpu")
        out = {}
        for arch in jobs["archs"]:
            got = one_arch(arch, jobs["layers"][arch],
                           dict(np.load(jobs["inputs"][arch])),
                           jobs["max_len"], mesh, sh.DEFAULT_RULES)
            out.update({f"{arch}/{k}": v for k, v in got.items()})
        if rank == 0:
            np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), *sys.argv[2:5])

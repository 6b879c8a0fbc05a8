"""One rank of ``tests/test_torch_moe_ep.py``'s gloo runs (a module of
its own, so a spawned rank imports no JAX): joins a gloo group through
a ``FileStore``, and for each job of its world size runs
``repro_torch.models.moe.moe_ffn`` under ``use_rules`` on the inputs of
an ``.npz``, writing ``y``, the aux loss, the gradients of
``sum(y * r) + aux`` (x, the router and the experts) and the kept set
(the assignments whose ``top_w`` gets a gradient through
``expert_parallel``, or through ``expert_ffn`` where the single-device
branch runs) to an ``.npz`` of its own. Each job runs twice: on plain
tensors (the whole tensor on every rank) and on DTensors placed as a
sharded model holds them (``distribute_tensor`` by the placements
``shardings_for`` gives the MoE leaves and activations: x and r by
``("batch", "seq", "embed")``, the router by ``(None, None)``, the
experts by ``("p_experts", "p_embed", None)`` and ``("p_experts",
None, "p_embed")``), its keys under ``dtensor/``; a DTensor result is
written as its ``full_tensor()``.

    python tests/torch_moe_ep_worker.py RANK WORLD STORE JOBS.json OUT.npz

``JOBS.json`` lists the runs: ``{"case", "inputs" (the .npz), "k",
"cf", "experts" (the rules' ``moe_experts``), "mesh" ("DATAxMODEL"),
"world"}``; a rank runs those of its world size, in order.
"""

import functools
import json
import sys

import numpy as np
import torch
import torch.distributed as dist


AXES = {"x": ("batch", "seq", "embed"), "r": ("batch", "seq", "embed"),
        "router": (None, None), "wg": ("p_experts", "p_embed", None),
        "wu": ("p_experts", "p_embed", None),
        "wd": ("p_experts", None, "p_embed")}


def _whole(t):
    """A DTensor's whole value (a plain tensor is itself)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def one_mesh(mesh, rules, inputs, k, cf, placed):
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe

    def leaf(n):
        t = torch.from_numpy(inputs[n]).clone()
        if placed:
            spec = sh.resolve_spec(AXES[n], t.shape, rules, mesh)
            t = distribute_tensor(t, mesh, sh.placements(spec, mesh))
        return t

    x, router, wg, wu, wd, r = (leaf(n) for n in ("x", "router", "wg", "wu",
                                                  "wd", "r"))
    leaves = (x, router, wg, wu, wd)
    for t in leaves:
        t.requires_grad_(True)
    b, s, d = x.shape
    e = router.shape[1]
    out = {}
    with sh.use_rules(mesh, rules), implicit_replication():
        y, aux = moe.moe_ffn(x, router, wg, wu, wd, k=k,
                             capacity_factor=cf)
        grads = torch.autograd.grad((y * r).sum() + aux, leaves)
        y2, _ = moe.moe_ffn(x, router, wg, wu, wd, k=k, capacity_factor=cf)
        # the kept set: the assignments whose weight reaches y
        tokens = x.detach().reshape(b * s, d)
        top_w, top_i, _ = moe.route(tokens, router.detach(), k)
        top_w = top_w.detach().requires_grad_(True)
        axis = moe.expert_axis(mesh, rules, e)
        ws = (wg.detach(), wu.detach(), wd.detach())
        if axis is not None:
            tspec, dp = moe.token_spec(b * s, rules, mesh)
            cap = moe._capacity(max(1, (b * s) // dp), k, e, cf)
            yk = moe.expert_parallel(tokens, top_w, top_i, *ws, k=k,
                                     capacity=cap, mesh=mesh, axis=axis,
                                     tspec=tspec)
        else:
            cap = moe._capacity(b * s, k, e, cf)
            ffn = functools.partial(moe.expert_ffn, k=k, capacity=cap)
            yk = (moe._on_every_rank(ffn, tokens, top_w, top_i, *ws)
                  if placed else ffn(tokens, top_w, top_i, *ws))
        (gw,) = torch.autograd.grad((yk.float() * r.reshape(b * s, d)).sum(),
                                    [top_w])
    y, y2 = _whole(y.detach()), _whole(y2.detach())
    out["y"] = y.numpy()
    out["y_again_same"] = np.array(torch.equal(y, y2))
    out["aux"] = np.array(float(_whole(aux.detach())))
    for n, g in zip(("x", "router", "wg", "wu", "wd"), grads):
        out["g_" + n] = _whole(g).numpy()
    out["kept"] = (_whole(gw) != 0).numpy().reshape(-1)
    out["expert_parallel"] = np.array(axis is not None)
    out["capacity"] = np.array(cap)
    return out


def run(rank, world, store_path, jobs_path, out_path):
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as tmesh

    with open(jobs_path) as f:
        jobs = [j for j in json.load(f) if j["world"] == world]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for job in jobs:
            dp, mp = (int(v) for v in job["mesh"].split("x"))
            mesh = tmesh.make_mesh_for_devices(world, mp, device="cpu")
            rules = {**sh.DEFAULT_RULES, "moe_experts": job["experts"]}
            inputs = dict(np.load(job["inputs"]))
            for form in ("", "dtensor/"):
                got = one_mesh(mesh, rules, inputs, job["k"], job["cf"],
                               placed=bool(form))
                for key, v in got.items():
                    out[f"{job['case']}/{job['mesh']}/{form}{key}"] = v
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])

"""The reference side of ``tests/test_torch_moe_ep.py``: runs
``repro.models.moe.moe_ffn`` under ``use_rules`` on JAX meshes of host
devices (a process of its own, started with ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), on the inputs
of an ``.npz``, and writes for each mesh ``y``, the aux loss,
``jax.grad`` of ``sum(y * r) + aux`` (x, the router and the experts) and
the kept set: the assignments whose ``top_w`` gets a gradient through
the reference's own ``_expert_shard``, under the ``shard_map`` specs of
its expert-parallel branch where that branch runs.

    python tests/moe_ep_reference_worker.py JOBS.json OUT.npz

with the jobs of ``tests/torch_moe_ep_worker.py`` (every world size).
"""

import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.distributed import sharding as SH
from repro.models import moe


def kept_set(tokens, top_w, top_i, wg, wu, wd, r, k, cf, mesh, rules):
    """The reference's kept set (T·k,): where d sum(y·r) / d top_w is
    not zero, ``y`` from ``_expert_shard`` as ``moe_ffn`` calls it."""
    t = tokens.shape[0]
    e = wg.shape[0]
    axis = rules.get("moe_experts")
    if axis is not None and e % mesh.shape[axis] == 0:
        tspec = SH.resolve_spec(("batch", None), tokens.shape, rules, mesh)
        dp = tspec[0]
        dp_size = 1
        for a in (dp if isinstance(dp, tuple) else (dp,)):
            if a is not None and a in mesh.shape:
                dp_size *= mesh.shape[a]
        cap = moe._capacity(max(1, t // dp_size), k, e, cf)
        fn = moe.shard_map(
            functools.partial(moe._expert_shard, k=k, capacity=cap,
                              axis=axis),
            mesh=mesh,
            in_specs=(tspec, tspec, tspec, P(axis, None, None),
                      P(axis, None, None), P(axis, None, None)),
            out_specs=tspec, check_vma=False)
    else:
        cap = moe._capacity(t, k, e, cf)
        fn = functools.partial(moe._expert_shard, k=k, capacity=cap,
                               axis=None)
    g = jax.jit(jax.grad(lambda w: jnp.sum(
        fn(tokens, w, top_i, wg, wu, wd).astype(jnp.float32) * r)))(top_w)
    return np.asarray(g).reshape(-1) != 0, cap


def one_mesh(mesh, rules, inp, k, cf):
    x, router, wg, wu, wd, r = (jnp.asarray(inp[n]) for n in (
        "x", "router", "wg", "wu", "wd", "r"))
    b, s, d = x.shape

    def loss(x, router, wg, wu, wd):
        y, aux = moe.moe_ffn(x, router, wg, wu, wd, k=k,
                             capacity_factor=cf)
        return jnp.sum(y * r) + aux, (y, aux)

    with SH.use_rules(mesh, rules):
        # jitted under the rules: they are read while tracing
        grads, (y, aux) = jax.jit(jax.grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
                x, router, wg, wu, wd)
        tokens = x.reshape(b * s, d)
        top_w, top_i, _ = jax.jit(moe.route, static_argnums=2)(
            tokens, router, k)
        kept, cap = kept_set(tokens, top_w, top_i, wg, wu, wd,
                             r.reshape(b * s, d), k, cf, mesh, rules)
    out = {"y": np.asarray(y), "aux": np.asarray(aux), "kept": kept,
           "capacity": np.array(cap)}
    for n, g in zip(("x", "router", "wg", "wu", "wd"), grads):
        out["g_" + n] = np.asarray(g)
    return out


def main(jobs_path, out_path):
    with open(jobs_path) as f:
        jobs = json.load(f)
    devs = jax.devices()
    out = {}
    for job in jobs:
        dp, mp = (int(v) for v in job["mesh"].split("x"))
        mesh = Mesh(np.array(devs[:dp * mp]).reshape(dp, mp),
                    ("data", "model"))
        rules = {**SH.DEFAULT_RULES, "moe_experts": job["experts"]}
        got = one_mesh(mesh, rules, dict(np.load(job["inputs"])), job["k"],
                       job["cf"])
        for key, v in got.items():
            out[f"{job['case']}/{job['mesh']}/{key}"] = v
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:3])

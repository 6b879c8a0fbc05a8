"""Runs of ``tests/test_torch_roofline.py`` and
``tests/test_torch_dryrun.py`` that need a ``fake`` process group (a
process of their own: the group is process-wide). Each prints one JSON
object on its last line.

    python tests/torch_fake_group_worker.py synthetic
    python tests/torch_fake_group_worker.py smoke_cells OUT_DIR ARCH...
    python tests/torch_fake_group_worker.py arg_bytes MESH ARCH...

``synthetic``: ``launch.roofline.StepCounter`` on a fake (16, 16) mesh
over the step of ``tests/test_roofline_parser.py``'s synthetic HLO: 12
iterations of an (8, 32) @ (32, 16) matrix product (a DTensor product
whose contracted dimension is sharded over ``model``, so a partial sum)
and the all-reduce of its (8, 16) result over ``model``, then an
all-gather of an (8, 16) shard to (128, 16) and a reduce-scatter of a
(128, 16) tensor to (8, 16), both over a group of 16.
``smoke_cells``: ``launch.dryrun.run_cell`` on each arch's smoke config
(the hybrid's cut to one group of its two) and smoke train, prefill and
decode shapes on a fake (2, 2) mesh.
``arg_bytes``: the dry run's per-device argument bytes (from the local
shards of ``step_args``) of each arch x shape on a production mesh
(``16x16`` or ``2x16x16``).
"""

import dataclasses
import json
import sys

import torch


def synthetic():
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL

    mesh = D.mesh_for(False)
    x = D._placed(torch.empty(128, 32 * 16, device="meta"),
                  (Shard(0), Shard(1)), mesh)
    w = D._placed(torch.empty(32 * 16, 16, device="meta"),
                  (Replicate(), Shard(0)), mesh)
    counter = RL.StepCounter()
    with counter:
        for _ in range(12):
            y = x @ w
            assert y.placements == (Shard(0), Partial())
            y = y.redistribute(mesh, (Shard(0), Replicate()))
        a = torch.empty(8, 16, device="meta")
        funcol.all_gather_tensor(a, 0, (mesh, 1))
        funcol.reduce_scatter_tensor(torch.empty(128, 16, device="meta"),
                                     "sum", 0, (mesh, 1))
    return counter.as_dict()


def smoke_cells(out_dir, archs):
    from repro_torch.configs import get_config, smoke
    from repro_torch.configs.base import SMOKE_SHAPES
    from repro_torch.launch import dryrun as D

    out = {}
    for arch in archs:
        cfg = smoke(get_config(arch))
        if cfg.attn_period:  # the hybrid: one group of its two
            cfg = dataclasses.replace(cfg, num_layers=cfg.attn_period)
        for kind, shape in SMOKE_SHAPES.items():
            rec = D.run_cell(arch, kind, False, out_dir=out_dir,
                             cfg_override=cfg, shape=shape,
                             mesh_shape=(2, 2))
            out[f"{arch}/{kind}"] = {
                k: rec.get(k) for k in ("status", "error", "memory",
                                        "collectives", "hlo_costs",
                                        "roofline", "mesh")}
    return out


def arg_bytes(mesh_name, archs):
    from repro_torch.configs import SHAPES, get_config, shape_supported
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as D

    mesh = D.mesh_for(mesh_name == "2x16x16")
    out = {}
    for arch in archs:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not shape_supported(arch, name):
                continue
            infer = (torch.inference_mode() if shape.kind != "train"
                     else torch.no_grad())
            with infer:
                args = D.step_args(cfg, shape, mesh, SH.DEFAULT_RULES)
                out[f"{arch}/{name}"] = (
                    D.local_bytes(dict(args[0].named_parameters()))
                    + D.local_bytes(args[1:]))
    return out


if __name__ == "__main__":
    what, rest = sys.argv[1], sys.argv[2:]
    if what == "synthetic":
        result = synthetic()
    elif what == "smoke_cells":
        result = smoke_cells(rest[0], rest[1:])
    else:
        result = arg_bytes(rest[0], rest[1:])
    print(json.dumps(result))

"""Dry run of every (arch x shape x mesh) cell: one step on ``meta``
DTensors over an in-process ``fake`` process group.

Port of ``repro.launch.dryrun``. ``repro`` lowers and compiles each
cell's jitted step on 256 or 512 placeholder host devices; the port's
counterpart runs each cell's step once, eagerly, on tensors that have
shapes and no storage, over a process group that has ranks and no
peers. It launches nothing on any device: that is its function (a
placeholder run, as ``repro``'s is), not a fallback. Per cell it

  1. joins a ``fake`` process group of 256 (16x16) or 512 (2x16x16)
     ranks in this process, as rank 0, and builds the production mesh
     over it (``launch.mesh``, ``device="cpu"``: the mesh's device; no
     tensor lives there);
  2. builds the step's arguments on ``meta`` (``init_params(cfg,
     device="meta")``, the optimizer state, the cache, the batch) and
     places each leaf by ``steps.shardings_for`` as a DTensor of its
     local shard (``DTensor.from_local``, no data moved);
  3. runs ``steps.step_for``'s step once under ``use_rules`` and
     ``implicit_replication()`` with ``roofline.StepCounter`` on: any
     operator DTensor cannot place, any sharding mismatch, is a fault
     of the framework, recorded with the cell;
  4. writes a JSON record with ``repro``'s keys.

The record: ``arch``, ``shape``, ``mesh``, ``rules``, ``variant``,
``status`` (``error``, ``traceback`` on a failure), ``lower_compile_s``
(here the seconds of the meta run), ``memory``, ``collectives``,
``hlo_costs`` (the counter's ``dot_flops`` and ``buffer_bytes``, plus
its ``launches``) and ``roofline`` (``Roofline.as_dict()`` against
``roofline.H100_SXM``). ``memory`` holds ``arg_bytes_per_device`` (from
the local shard shapes; ``repro``'s reckoning from its shardings) and
``argument_size_in_bytes`` (the same bytes) and
``output_size_in_bytes`` (the local shards of the step's outputs).
Left out, with no meta counterpart: ``memory_analysis``'s
``temp_size_in_bytes``, ``generated_code_size_in_bytes`` and
``alias_size_in_bytes`` (an XLA buffer assignment), ``cost_analysis_raw``
and ``hlo_chars`` (an XLA program). A host ``int`` (a cache's
``length``) is no argument of the port's step, so ``arg_bytes_per_device``
lacks the 4 bytes of ``repro``'s int32 ``length`` in a decode cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k [--multipod] [--rules baseline]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_supported
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_mesh_for_devices, make_production_mesh
from repro_torch.models import model as M

RULE_SETS = {
    "baseline": SH.DEFAULT_RULES,
    "serve_resident": {
        # decode: weights resident (model-sharded only, no per-token
        # FSDP all-gather); KV cache sharded over batch+seq
        **SH.DEFAULT_RULES,
        "p_embed": None,
        "p_embed_alt": None,
    },
    "decode_kvbatch": {
        # decode: keep cache seq unsharded (no split-K collectives),
        # shard kv heads where divisible
        **SH.DEFAULT_RULES,
        "p_embed": None,
        "cache_seq": None,
        "cache_kv_heads": "model",
    },
    "train_nofsdp": {
        **SH.DEFAULT_RULES,
        "p_embed": None,
    },
    "train_smalltp": {
        # small archs (heads < 16): give the model axis to batch too,
        # keeping only vocab/mlp on 'model'
        **SH.DEFAULT_RULES,
        "heads": None,
        "kv_heads": None,
        "p_heads": None,
        "p_kv_heads": None,
    },
}


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (its collectives complete at once and move nothing); an
    existing group of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_world_size() == world
                and dist.get_backend() == "fake"):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_for(multi_pod: bool, mesh_shape: Optional[Tuple[int, int]] = None):
    """The production mesh (or a ``(data, model)`` mesh of
    ``mesh_shape``) over a fake group of its size."""
    if mesh_shape is not None:
        fake_group(math.prod(mesh_shape))
        return make_mesh_for_devices(math.prod(mesh_shape), mesh_shape[1],
                                     device="cpu")
    fake_group(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _placed(spec, placements, mesh):
    """A ``meta`` spec as a DTensor of its local shard; a host value (a
    cache's ``length``) as itself."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    if not isinstance(spec, torch.Tensor):
        return spec
    local, _ = compute_local_shape_and_global_offset(
        spec.shape, mesh, placements)
    t = torch.empty(local, dtype=spec.dtype, device="meta")
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=spec.shape, stride=spec.stride())


def _tree(fn, specs, placements):
    """``fn(spec, placements)`` over matching trees (dicts, tuples,
    NamedTuples; None stays None)."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: _tree(fn, v, placements[k]) for k, v in specs.items()}
    if isinstance(specs, tuple) and not isinstance(specs, torch.Size):
        parts = [_tree(fn, s, p) for s, p in zip(specs, placements)]
        return (type(specs)(*parts) if hasattr(specs, "_fields")
                else tuple(parts))
    return fn(specs, placements)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def local_bytes(tree) -> int:
    """Bytes of every tensor leaf's local shard (a DTensor's, or a
    plain tensor's whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def placed_model(cfg: ModelConfig, placements, mesh) -> M.Model:
    """``init_params(cfg, device="meta")`` with each parameter replaced
    by its DTensor placed by ``placements`` (``shardings_for``'s)."""
    model = M.init_params(cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(
            _placed(p.detach(), placements[name], mesh),
            requires_grad=False))
    return model


def step_args(cfg: ModelConfig, shape: ShapeSpec, mesh, rules):
    """The step's arguments as DTensors of their local shards:
    (model, opt_state, batch), (model, cache, batch) or (model,
    batch)."""
    shardings, specs = ST.shardings_for(cfg, shape, mesh, rules)
    model = placed_model(cfg, shardings[0], mesh)
    rest = [_tree(lambda s, p: _placed(s, p, mesh), sp, sh)
            for sp, sh in zip(specs[1:], shardings[1:])]
    return (model, *rest)


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    rules_name: str = "baseline",
    out_dir: str = "experiments/dryrun",
    cfg_override: ModelConfig | None = None,
    tag: str = "",
    *,
    shape: Optional[ShapeSpec] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> dict:
    """One cell; ``shape`` overrides ``SHAPES[shape_name]`` and
    ``mesh_shape`` (data, model) the production mesh (the CPU tests'
    smoke cells on a (2, 2) mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    rules = RULE_SETS[rules_name]
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "rules": rules_name, "variant": tag, "status": "ok",
    }
    t0 = time.time()
    try:
        mesh = mesh_for(multi_pod, mesh_shape)
        counter = RL.StepCounter()
        # prefill and decode run under inference mode: their arguments
        # are made there too (a view of a DTensor made outside raises)
        infer = (torch.inference_mode() if shape.kind != "train"
                 else contextlib.nullcontext())
        with SH.use_rules(mesh, rules), infer:
            step = ST.step_for(cfg, shape)
            args = step_args(cfg, shape, mesh, rules)
            arg_bytes = (local_bytes(dict(args[0].named_parameters()))
                         + local_bytes(args[1:]))
            with implicit_replication(), counter:
                out = step(*args)
        record["lower_compile_s"] = round(time.time() - t0, 1)
        record["memory"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": local_bytes(out),
            "arg_bytes_per_device": arg_bytes,
        }
        record["collectives"] = dict(counter.collectives)
        record["hlo_costs"] = {"dot_flops": counter.dot_flops,
                               "buffer_bytes": counter.buffer_bytes,
                               "launches": counter.launches}
        roof = RL.Roofline(
            flops_per_device=counter.dot_flops,
            hbm_bytes_per_device=counter.buffer_bytes,
            collective_bytes_per_device=sum(counter.collectives.values()),
            model_flops=RL.model_flops_for(cfg, shape),
            chips=mesh.size(),
        )
        record["roofline"] = roof.as_dict()
    except Exception as e:  # record failures as artifacts, not crashes
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    out_path = pathlib.Path(out_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    fname = f"{arch}__{shape_name}__{record['mesh']}__{rules_name}{tag}"
    (out_path / f"{fname}.json").write_text(json.dumps(record, indent=1))
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--rules", default="baseline", choices=list(RULE_SETS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--kv-planes", type=int, default=0,
                    help="fixed-rate compressed KV cache (decode cells)")
    ap.add_argument("--remat", default="",
                    help="override remat policy (none|dots|full)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                if not shape_supported(arch, shape):
                    continue
                cells.append((arch, shape, False))
                cells.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.multipod)]

    failures = 0
    for arch, shape, mp in cells:
        if not shape_supported(arch, shape):
            print(f"SKIP {arch} x {shape} (long-context policy)")
            continue
        cfg_override = None
        tag = ""
        if args.kv_planes or args.remat:
            cfg_override = get_config(arch)
            if args.kv_planes:
                cfg_override = dataclasses.replace(
                    cfg_override, kv_compress_planes=args.kv_planes
                )
                tag += f"__kv{args.kv_planes}"
            if args.remat:
                cfg_override = dataclasses.replace(
                    cfg_override, remat=args.remat
                )
                tag += f"__remat-{args.remat}"
        rec = run_cell(arch, shape, mp, args.rules, args.out,
                       cfg_override=cfg_override, tag=tag)
        status = rec["status"]
        if status != "ok":
            failures += 1
            print(f"FAIL {arch} x {shape} x {rec['mesh']}: "
                  f"{rec.get('error', '')[:200]}")
        else:
            r = rec["roofline"]
            print(
                f"OK   {arch:>22s} x {shape:>11s} x {rec['mesh']:>7s} "
                f"run={rec['lower_compile_s']:6.1f}s "
                f"comp={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                f"coll={r['collective_s']:.3e}s dom={r['dominant']}"
            )
            if not args.all:  # single cell: full analyses to stdout
                print("memory:", json.dumps(rec["memory"], indent=1))
                print("counted (per device):",
                      json.dumps(rec["hlo_costs"], indent=1))
                print("collective bytes/device:",
                      json.dumps(rec["collectives"], indent=1))
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()

"""Mixture-of-experts FFN: top-k routing, capacity dispatch, expert
GLUs and the weighted combine.

Port of ``repro.models.moe``'s single-device branch. Routing is a
float32 softmax of ``x @ router_w`` and its top-k, ties broken to the
lower expert index as ``lax.top_k`` breaks them (a stable descending
sort; ``torch.topk`` promises no order among ties on CUDA), with the
Switch load-balance loss. Dispatch is the reference's: the ``(T·k)``
assignments sorted stably by expert, each expert's first ``capacity``
of them kept (the rest dropped), no ``(T, E, C)`` one-hot. Each
expert's GLU runs as batched matrix products over an ``(E, C, d)``
buffer.

Every step is deterministic on the card, so two calls on the same
input agree bit for bit, as a ``full``-remat recompute needs:
- the buffer is gathered, slot by slot, from the assignment that fills
  it (``Dispatch.rows``), never scattered, so no index is written twice;
- the combine gives each token its ``k`` kept contributions and adds
  them in float32 one after another from zero, in order of expert id:
  the order in which the reference's scatter-add meets them (its
  updates run in the sorted order, which is by expert). ``index_add_``
  on CUDA adds with atomics in no fixed order.
- the load-balance hit counts add 1.0 by ``index_add_``, exact in any
  order.

**The expert-parallel branch** (``repro``'s ``shard_map`` over
``_expert_shard``). Under ``use_rules(mesh, rules)`` it is taken where
``repro`` takes it: ``rules["moe_experts"]`` names an axis of the mesh
whose size divides E, and the mesh is a ``DeviceMesh`` of an initialized
process group (a JAX ``AbstractMesh``, which the CPU tests pass for
specs, has no ranks: the single-device branch runs there). Routing runs
on the whole token set, so the load-balance loss is the global one
(over a sharded DTensor the hit counts are local counts summed over
the token shards). Each rank of the expert axis holds the experts
``lo = index · E/m ... lo + E/m`` and runs ``expert_ffn`` on its token
shard (the tokens split over the data axes by ``resolve_spec(("batch",
None))``) with every other expert's assignment in the drop bucket, at
the capacity of ``t_local = T // dp_size`` tokens, as ``repro`` does;
its float32 partial ``y`` is summed over the expert axis by one
all-reduce. The form is ``torch.distributed.tensor``'s ``local_map``
around the local function (``_expert_sum`` with ``lo``), whatever the
inputs. Sharded DTensors are redistributed to the shard placements;
``y`` leaves as ``Partial("sum")`` over the expert axis and DTensor's
redistribute does the all-reduce and carries its gradient; the inputs'
gradients leave as partial sums over the axes each rank saw only a part
of (``x`` and ``top_w`` over the expert axis, the experts over the data
axes). Plain tensors, the same whole tensor on every rank, enter the
same ``local_map`` as views of this rank's shards and leave whole by
one all-reduce of each rank's part padded with zeros, exact, which
also brings their gradients back whole: no all-gather (the card's
torch 2.11 crashes in the functional all-gather over gloo on CUDA
tensors) and no copy of the expert shards. Each rank's local function
is as deterministic as the single-device branch, and the collectives
give every rank the same bits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH

NO_DROP_ASSIGNMENTS = 4096  # t·k at or under it: no assignment drops




def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest scores of each row, largest first, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x_tokens: torch.Tensor, router_w: torch.Tensor, k: int):
    """Top-k routing. x: (T, d) -> (top_w (T, k) float32 summing to 1 a
    row, top_i (T, k) int64, aux loss: E · Σ_e f_e · p_e)."""
    scores = torch.softmax(x_tokens.float() @ router_w.float(), dim=-1)
    top_w, top_i = top_k(scores, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    e = scores.shape[-1]
    hits = (_dtensor_hits(top_i, e) if SH.is_dtensor(top_i)
            else _hits(top_i, e))
    frac = hits / torch.clamp(hits.sum(), min=1.0)
    prob = scores.mean(0)
    aux = e * torch.sum(frac * prob)
    return top_w, top_i, aux


def _hits(top_i: torch.Tensor, e: int) -> torch.Tensor:
    """How many assignments each of the ``e`` experts has, float32."""
    flat = top_i.reshape(-1)
    hits = torch.zeros(e, dtype=torch.float32, device=top_i.device)
    hits.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                        device=top_i.device))
    return hits


def _dtensor_hits(top_i, e: int):
    """``_hits`` of a DTensor's global assignments: each rank counts its
    shard, partial over the mesh dimensions that shard the tokens."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    out = [Partial() if p.is_shard() else Replicate()
           for p in top_i.placements]
    return local_map(lambda t: _hits(t, e), out_placements=out,
                     in_placements=(top_i.placements,),
                     device_mesh=top_i.device_mesh)(top_i)


def _capacity(t_local: int, k: int, e: int, cf: float) -> int:
    """Capacity-factor dispatch at scale; exact (no-drop) dispatch for
    small token counts: decode must never drop a token."""
    cap = int(cf * k * t_local / e)
    if t_local * k <= NO_DROP_ASSIGNMENTS:
        cap = max(cap, t_local * k)
    return max(1, cap)


class Dispatch(NamedTuple):
    """Where each of the ``T·k`` assignments (flat ``t·k + j`` order)
    goes. ``keep`` (T·k,): within its expert's capacity; ``slot`` (T·k,):
    its row of the flattened ``(E·C, d)`` buffer, ``E·C`` when dropped;
    ``rows`` (E, C): the assignment that fills each buffer slot, valid
    where ``filled``."""

    keep: torch.Tensor
    slot: torch.Tensor
    rows: torch.Tensor
    filled: torch.Tensor


def dispatch(top_i: torch.Tensor, num_experts: int, capacity: int,
             lo: Optional[int] = None) -> Dispatch:
    """The reference's dispatch: a stable sort of the assignments by
    expert (token order kept within an expert), each one's position in
    its expert's run from a left ``searchsorted``, kept while that
    position is under ``capacity``. With ``lo`` (the expert-parallel
    branch) the ``num_experts`` experts are ``lo ... lo + num_experts``
    of a larger set: every other assignment goes to the drop bucket
    ``num_experts``, as ``_expert_shard``'s ``le`` does."""
    flat = top_i.reshape(-1)
    n, dev = flat.numel(), flat.device
    if lo is not None:
        local = (flat >= lo) & (flat < lo + num_experts)
        flat = torch.where(local, flat - lo, num_experts)
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    starts = torch.searchsorted(
        se, torch.arange(num_experts + 1, device=dev, dtype=se.dtype))
    pos = torch.arange(n, device=dev) - starts[se]
    full = num_experts * capacity
    kept = pos < capacity if lo is None else (pos < capacity) & (
        se < num_experts)
    slot_sorted = torch.where(kept, se * capacity + pos, full)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    # slot (e, c) holds sorted position starts[e] + c while c < count[e]
    at = starts[:-1, None] + torch.arange(capacity, device=dev)[None]
    filled = at < starts[1:, None]
    rows = order[at.clamp(max=n - 1)]
    return Dispatch(slot < full, slot, rows, filled)


def expert_ffn(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
               k: int, capacity: int) -> torch.Tensor:
    """``_expert_shard`` with ``axis=None``: x (T, d) -> y (T, d) in x's
    type, Σ over each token's kept assignments of weight · expert GLU."""
    return _expert_sum(x, top_w, top_i, wg, wu, wd, k=k,
                       capacity=capacity).to(x.dtype)


def _expert_sum(x, top_w, top_i, wg, wu, wd, *, k: int, capacity: int,
                lo: Optional[int] = None) -> torch.Tensor:
    """``expert_ffn``'s float32 sum, before the cast; with ``lo`` only
    experts ``lo ... lo + E_local`` (``wg``'s) contribute (the
    expert-parallel branch's local function)."""
    t, d = x.shape
    e = wg.shape[0]
    plan = dispatch(top_i, e, capacity, lo)
    buf = torch.where(plan.filled[..., None], x[plan.rows // k], 0)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd).reshape(e * capacity, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    scale = (top_w.reshape(-1) * plan.keep).to(out.dtype)
    vals = (out[plan.slot] * scale[:, None]).reshape(t, k, d)
    # each token's contributions by expert id, the reference's order
    by_expert = torch.sort(top_i, dim=-1).indices
    vals = vals.gather(1, by_expert[..., None].expand(t, k, d))
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + vals[:, j].float()
    return y


def expert_axis(mesh, rules, num_experts: int) -> Optional[str]:
    """The mesh axis the experts shard over under ``use_rules(mesh,
    rules)``, or None for the single-device branch: ``repro``'s
    condition (``rules["moe_experts"]`` an axis of the mesh whose size
    divides E) on a ``DeviceMesh`` of an initialized process group."""
    axis = rules.get("moe_experts") if rules else None
    if mesh is None or axis is None or not isinstance(axis, str):
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        return None
    sizes = SH.axis_sizes(mesh)
    if axis not in sizes or num_experts % sizes[axis]:
        return None
    return axis


def token_spec(n_tokens: int, rules, mesh):
    """The tokens' spec and the number of token shards: ``repro``'s
    ``resolve_spec(("batch", None), ...)`` and ``dp_size``."""
    tspec = SH.resolve_spec(("batch", None), (n_tokens, 1), rules, mesh)
    sizes = SH.axis_sizes(mesh)
    dp = tspec[0]
    dp_size = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        if a is not None and a in sizes:
            dp_size *= sizes[a]
    return tspec, dp_size


def expert_parallel(tokens, top_w, top_i, wg, wu, wd, *, k: int,
                    capacity: int, mesh, axis: str, tspec):
    """``repro``'s ``shard_map`` of ``_expert_shard``: tokens (T, d),
    top_w/top_i (T, k), experts (E, ...) -> y (T, d) in the tokens'
    type, each rank's local experts on its token shard, the shards'
    float32 partial ``y`` summed over ``axis`` by all-reduce. DTensors
    give a DTensor in the tokens' placements. Plain tensors, the
    same whole tensor on every rank, enter as views of this rank's
    shards (``_ShardOf``) and give the whole plain ``y`` (``_Whole``):
    all-reduces only, both ways."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    data = {a for entry in tspec if entry is not None
            for a in (entry if isinstance(entry, tuple) else (entry,))}
    if axis in data:
        raise ValueError(f"the tokens and the experts both shard over "
                         f"{axis!r}")
    e_l = wg.shape[0] // SH.axis_sizes(mesh)[axis]
    lo = mesh.get_local_rank(axis) * e_l
    dtype = tokens.dtype
    part = Partial()
    tok = tuple(Shard(0) if n in data else Replicate() for n in names)
    exp = tuple(Shard(0) if n == axis else Replicate() for n in names)
    # y, and the gradient of what a rank sees only part of (x and top_w:
    # its experts; the experts' weights: its tokens), is a partial sum
    # over that axis
    tok_part = tuple(part if n == axis else p for n, p in zip(names, tok))
    exp_part = tuple(part if n in data else p for n, p in zip(names, exp))

    def local(x, w, i, g, u, d):
        return _expert_sum(x, w, i, g, u, d, k=k, capacity=capacity, lo=lo)

    places = (tok, tok, tok, exp, exp, exp)
    fn = local_map(local, out_placements=list(tok_part),
                   in_placements=places,
                   in_grad_placements=(tok_part, tok_part, tok, exp_part,
                                       exp_part, exp_part),
                   device_mesh=mesh)
    args = (tokens, top_w, top_i, wg, wu, wd)
    if not SH.is_dtensor(tokens):
        y = fn(*(_ShardOf.apply(a, mesh, p) for a, p in zip(args, places)))
        return _Whole.apply(y).to(dtype)
    y = fn(*(a.redistribute(mesh, p) for a, p in zip(args, places)))
    # back in the tokens' own placements
    return y.redistribute(mesh, tokens.placements).to(dtype)


def _box(shape, mesh, placements):
    """The index of this rank's shard of a tensor of ``shape``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    n, at = compute_local_shape_and_global_offset(shape, mesh, placements)
    return tuple(slice(a, a + m) for a, m in zip(at, n))


def _summed(local, placements, shape, mesh):
    """The whole tensor of ``shape`` from each rank's ``local`` part:
    the parts written into zeros at their places and summed by
    all-reduce over the mesh dimensions that shard or split them into
    partial sums (exact: a part meets only zeros from the ranks that
    hold other rows)."""
    import torch.distributed as dist

    out = local.new_zeros(shape)
    out[_box(shape, mesh, placements)] = local
    for i, p in enumerate(placements):
        if not p.is_replicate() and mesh.size(i) > 1:
            dist.all_reduce(out, group=mesh.get_group(i))
    return out


class _ShardOf(torch.autograd.Function):
    """A plain tensor, the same whole tensor on every rank, as the
    DTensor of this rank's shard under ``placements`` (a view: no copy,
    no collective); its gradient comes back whole on every rank by
    ``_summed``."""

    @staticmethod
    def forward(ctx, whole, mesh, placements):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.shape = mesh, whole.shape
        return DTensor.from_local(
            whole[_box(whole.shape, mesh, placements)], mesh, placements,
            run_check=False, shape=whole.shape, stride=whole.stride())

    @staticmethod
    def backward(ctx, grad):
        return (_summed(grad.to_local(), grad.placements, ctx.shape,
                        ctx.mesh), None, None)


class _Whole(torch.autograd.Function):
    """A DTensor (rows sharded, partial sums over the expert axis) as the
    whole plain tensor on every rank, by ``_summed``; its gradient is
    this rank's part of the whole's."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        ctx.shape, ctx.stride = t.shape, t.stride()
        return _summed(t.to_local(), t.placements, t.shape, t.device_mesh)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Replicate

        # the gradient of a partial sum is the whole sum's: replicated
        whole = [Replicate() if p.is_partial() else p for p in ctx.placements]
        part = grad[_box(ctx.shape, ctx.mesh, ctx.placements)]
        return DTensor.from_local(part.contiguous(), ctx.mesh, whole,
                                  run_check=False, shape=ctx.shape,
                                  stride=ctx.stride)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor, *, k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), router_w (d, E), wg/wu (E, d, f), wd (E, f, d) ->
    (y (B, S, d), aux loss). Under ``use_rules`` on a mesh of ranks the
    expert-parallel branch (``expert_axis``), else the single-device
    one (over DTensors on every rank's replicated copy)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    tokens = x.reshape(b * s, d)
    top_w, top_i, aux = route(tokens, router_w, k)
    mesh, rules = SH.current_mesh(), SH.current_rules()
    axis = expert_axis(mesh, rules, e)
    if axis is not None:
        tspec, dp_size = token_spec(b * s, rules, mesh)
        capacity = _capacity(max(1, (b * s) // dp_size), k, e,
                             capacity_factor)
        y = expert_parallel(tokens, top_w, top_i, wg, wu, wd, k=k,
                            capacity=capacity, mesh=mesh, axis=axis,
                            tspec=tspec)
        return y.reshape(b, s, d), aux
    capacity = _capacity(b * s, k, e, capacity_factor)
    ffn = functools.partial(expert_ffn, k=k, capacity=capacity)
    if SH.is_dtensor(tokens):
        y = _on_every_rank(ffn, tokens, top_w, top_i, wg, wu, wd)
    else:
        y = ffn(tokens, top_w, top_i, wg, wu, wd)
    return y.reshape(b, s, d), aux


def _on_every_rank(fn, *args):
    """``fn`` of DTensors run whole on every rank, on their replicated
    values: the single-device branch over sharded tensors."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = args[0].device_mesh
    whole = tuple(Replicate() for _ in range(mesh.ndim))
    return local_map(fn, out_placements=list(whole),
                     in_placements=(whole,) * len(args), device_mesh=mesh,
                     redistribute_inputs=True)(*args)

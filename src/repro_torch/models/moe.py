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

The expert-parallel branch (experts sharded over a mesh axis under
``shard_map``, a ``psum`` combining the shards) waits for the logical
sharding axes: ROADMAP.md queue 1 item 21.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

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
    flat = top_i.reshape(-1)
    hits = torch.zeros(e, dtype=torch.float32, device=scores.device)
    hits.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                        device=scores.device))
    frac = hits / torch.clamp(hits.sum(), min=1.0)
    prob = scores.mean(0)
    aux = e * torch.sum(frac * prob)
    return top_w, top_i, aux


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


def dispatch(top_i: torch.Tensor, num_experts: int, capacity: int) -> Dispatch:
    """The reference's dispatch: a stable sort of the assignments by
    expert (token order kept within an expert), each one's position in
    its expert's run from a left ``searchsorted``, kept while that
    position is under ``capacity``."""
    flat = top_i.reshape(-1)
    n, dev = flat.numel(), flat.device
    order = torch.sort(flat, stable=True).indices
    se = flat[order]
    starts = torch.searchsorted(
        se, torch.arange(num_experts + 1, device=dev, dtype=se.dtype))
    pos = torch.arange(n, device=dev) - starts[se]
    full = num_experts * capacity
    slot_sorted = torch.where(pos < capacity, se * capacity + pos, full)
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
    t, d = x.shape
    e = wg.shape[0]
    plan = dispatch(top_i, e, capacity)
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
    return y.to(x.dtype)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, wg: torch.Tensor,
            wu: torch.Tensor, wd: torch.Tensor, *, k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), router_w (d, E), wg/wu (E, d, f), wd (E, f, d) ->
    (y (B, S, d), aux loss)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    tokens = x.reshape(b * s, d)
    top_w, top_i, aux = route(tokens, router_w, k)
    capacity = _capacity(b * s, k, e, capacity_factor)
    y = expert_ffn(tokens, top_w, top_i, wg, wu, wd, k=k, capacity=capacity)
    return y.reshape(b, s, d), aux

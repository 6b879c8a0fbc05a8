"""Transfer audit log of the out-of-core engines.

Port of the ``Transfer`` record and ``summarize_transfers`` of
``repro.core.taskgraph``. The task graph, its schedules and the
residency model come with the live executor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class Transfer:
    """One realized host<->device transfer (the engines' audit log)."""

    direction: str  # "h2d" | "d2h" | "halo"
    field: str
    unit: Tuple[str, int]
    raw_bytes: int
    wire_bytes: int
    sweep: int
    block: int
    # write-back residency flush (evict/gather/checkpoint) rather than
    # an in-order writeback
    flush: bool = False
    # the transfer is a spare-stream reissue of a failed/straggling
    # flush (ReissuePolicy mitigation on the snapshot path)
    reissued: bool = False
    # overlapped-checkpoint snapshot D2H: a pinned payload materialized
    # into a checkpoint shard (never touches the host store)
    ckpt: bool = False


def summarize_transfers(transfers: List[Transfer]) -> Dict[str, int]:
    """Per-direction raw/wire byte totals of a transfer log, with the
    write-back flush and overlapped-snapshot shares of d2h broken out.
    Shared by both engines so their summaries stay dict-comparable.

    Per-direction *counts* are reported too (one Transfer record = one
    link crossing): a temporal-k visit logs one fetch per unit no
    matter how many fused sweeps it advances, so counts — like the
    residency manager's lookup/deposit denominators — stay comparable
    across schedules while version counters advance k per visit.
    """
    tot = {
        "h2d_raw": 0, "h2d_wire": 0, "d2h_raw": 0, "d2h_wire": 0,
        "halo_raw": 0, "halo_wire": 0,
        "d2h_flush_wire": 0, "d2h_ckpt_wire": 0,
        "h2d_count": 0, "d2h_count": 0, "halo_count": 0,
    }
    for t in transfers:
        tot[f"{t.direction}_raw"] += t.raw_bytes
        tot[f"{t.direction}_wire"] += t.wire_bytes
        tot[f"{t.direction}_count"] += 1
        if t.flush:
            tot["d2h_flush_wire"] += t.wire_bytes
        if t.ckpt:
            tot["d2h_ckpt_wire"] += t.wire_bytes
    return tot

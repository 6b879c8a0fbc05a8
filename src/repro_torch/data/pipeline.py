"""Deterministic, resumable data pipeline (port of
``repro.data.pipeline``: numpy, the same batches bit for bit).

Every batch is a pure function of (seed, step, host slice): resuming
from a checkpoint at step k reproduces the exact token stream with no
persisted iterator state — the property large-scale fault tolerance
actually needs (restart 4000 hosts without coordinating file offsets).

Two sources:
  * ``SyntheticLM`` — zipf-ish token stream (benchmarks, smoke tests)
  * ``MemmapLM``    — fixed-width token shards on disk (np.memmap),
    deterministic shuffled window addressing
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Zipf-distributed tokens with a next-token structure so the loss
    is learnable (token t+1 correlates with t)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index)
        )
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        base = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        drift = rng.integers(0, 7, size=(b, s + 1))
        toks = ((base + drift) % v).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "positions": np.broadcast_to(
                np.arange(s, dtype=np.int32)[None], (b, s)
            ),
        }


class MemmapLM:
    """Token shards: a flat int32 file per shard; window addressing is
    a seeded permutation of window indices — deterministic resume."""

    def __init__(self, cfg: PipelineConfig, path: str):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.windows = len(self.data) // (cfg.seq_len + 1)
        assert self.windows >= cfg.host_batch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        epoch = (step * cfg.global_batch) // self.windows
        rng = np.random.default_rng((cfg.seed, epoch))
        perm = rng.permutation(self.windows)
        start = (step * cfg.global_batch + cfg.host_index * b) % (
            self.windows
        )
        idx = perm[(start + np.arange(b)) % self.windows]
        rows = np.stack(
            [self.data[i * (s + 1) : (i + 1) * (s + 1)] for i in idx]
        )
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
            "positions": np.broadcast_to(
                np.arange(s, dtype=np.int32)[None], (b, s)
            ),
        }


class Prefetcher:
    """One-batch lookahead on a background thread (overlaps host data
    work with device steps — the data-side analogue of the paper's
    pipeline). Batches come in step order; an error raised by the source
    is raised by ``next``. ``close`` stops the thread."""

    def __init__(self, source, start_step: int = 0):
        import queue
        import threading

        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()

        def worker():
            s = start_step
            item = None
            while not self._stop.is_set():
                if item is None:
                    try:
                        item = (s, source.batch_at(s), None)
                    except Exception as e:  # handed to the consumer
                        item = (s, None, e)
                try:
                    self._q.put(item, timeout=0.5)
                except queue.Full:
                    continue
                if item[2] is not None:
                    return
                item, s = None, s + 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        s, batch, err = self._q.get()
        if err is not None:
            raise err
        self.step = s + 1
        return s, batch

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._t.join(timeout)

"""Batched serving engine with continuous batching + compressed KV.

Port of ``repro.serving.engine``: a fixed slot count; new requests
enter a free slot while other slots keep decoding (continuous
batching); a per-slot KV cache, or the fixed-rate compressed cache of
``repro_torch.models.kvcache`` when the config sets
``kv_compress_planes``; greedy or temperature sampling, deterministic
under a seed (the sampler runs on the host in float64, as in the
reference).

The engine runs on the CUDA device unless ``device="cpu"`` is passed,
and raises ``NoCudaDevice`` without a card. ``backend`` follows the
device (``"cuda"``: the hand-written kernels of the compressed path and
of the selective scan; ``"ref"``: their plain versions, the default on
the CPU).

The compressed cache is slot-synchronous, as in the reference: it is
right only when every slot is admitted at once with equal prompt
lengths and equal ``max_new`` (a request admitted later would attend
to the earlier request's history). Where the reference would serve such
a request wrongly, this engine refuses it: admitting a request into a
compressed cache that already holds tokens raises ``ValueError``.

An SSM cache (``conv`` and ``h``: falcon-mamba's a Mamba-1 layer, the
zamba2 hybrid's a Mamba-2 layer beside its raw K/V a group) holds each
slot's recurrent state, which the next step reads as it is. A request
admitted into a slot starts from zero state, as ``mamba1_seq`` and
``mamba2_seq`` with ``state=None`` do: the engine zeroes that slot's
``conv`` and ``h`` rows in every layer. The reference engine resets only
the slot's position, so a request it admits into a freed slot starts
from the previous request's state (and from the idle steps taken on
token 0 since).

The engine feeds token ids, as the reference's does: a config that
takes embeddings (``embeds_input``: the audio and vision-language
families) is refused with ``ValueError``; drive those through
``models.model.decode_step`` with embeddings and, for qwen2-vl, (3, B, 1)
M-RoPE positions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a config the engine cannot feed."""
    if cfg.embeds_input:
        raise ValueError(
            f"{cfg.name} takes embeddings ({cfg.family} family), and the "
            f"serving engine feeds token ids only, as the reference's "
            f"does: drive it through models.model.decode_step instead")


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: M.Model,
        *,
        slots: int = 4,
        max_len: int = 256,
        temperature: float = 0.0,
        seed: int = 0,
        device: device_mod.DeviceLike = None,
        backend: Optional[str] = None,
    ):
        check_servable(cfg)
        # an index-free "cuda" names the current card, as tensors record it
        self.device = torch.empty(0, device=device_mod.resolve(device)).device
        if params.device != self.device:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}")
        self.backend = backend or (
            "cuda" if self.device.type == "cuda" else "ref")
        device_mod.check_backend(self.backend, params.final_norm)
        self.cfg, self.params = cfg, params
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        with torch.inference_mode():
            self.cache = M.init_cache(cfg, slots, max_len, self.device)
        self.active: Dict[int, Optional[Request]] = {
            i: None for i in range(slots)
        }
        self.pending: List[Request] = []
        self.pos = np.zeros(slots, np.int32)
        self._rid = 0
        self._step = functools.partial(M.decode_step, cfg,
                                       backend=self.backend)

    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        self._rid += 1
        self.pending.append(Request(self._rid, list(prompt), max_new))
        return self._rid

    def _admit(self) -> None:
        for slot, req in self.active.items():
            if req is None and self.pending:
                if isinstance(self.cache, M.CompressedCache) and \
                        self.cache.length:
                    raise ValueError(
                        f"request {self.pending[0].rid} would enter a "
                        f"compressed KV cache that holds "
                        f"{self.cache.length} tokens of earlier requests: "
                        f"the cache is slot-synchronous, so submit at most "
                        f"`slots` requests, all before the first step")
                self.active[slot] = self.pending.pop(0)
                self.pos[slot] = 0
                if isinstance(self.cache, M.DecodeCache) and \
                        self.cache.conv is not None:
                    with torch.inference_mode():
                        self.cache.conv[:, slot].zero_()
                        self.cache.h[:, slot].zero_()

    def _sample(self, row: np.ndarray) -> int:
        """Temperature sampling in float64. The softmax must be computed
        and renormalized in double precision: a float32 softmax can sum
        to 1 +/- ~1e-7, which `np.random.Generator.choice` rejects
        (its tolerance on `p` is ~1.49e-8)."""
        z = row.astype(np.float64) / self.temperature
        z = z - z.max()
        prob = np.exp(z)
        prob = prob / prob.sum()
        return int(self.rng.choice(len(prob), p=prob))

    def step(self) -> Dict[int, List[int]]:
        """One engine iteration: feed each active slot one token
        (prompt token while prefilling, else the model's own sample).
        Slot-synchronous decode, the standard continuous-batching inner
        loop."""
        self._admit()
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, req in self.active.items():
            if req is None:
                continue
            p = self.pos[slot]
            if p < len(req.prompt):
                tokens[slot, 0] = req.prompt[p]
            elif req.out:
                tokens[slot, 0] = req.out[-1]
        positions = self.pos[:, None].astype(np.int32)
        logits, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(tokens),
            torch.from_numpy(positions),
        )
        logits = logits.float().cpu().numpy()
        finished: Dict[int, List[int]] = {}
        for slot, req in list(self.active.items()):
            if req is None:
                continue
            self.pos[slot] += 1
            if self.pos[slot] < len(req.prompt):
                continue  # still prefilling
            if self.temperature > 0:
                tok = self._sample(logits[slot])
            else:
                tok = int(logits[slot].argmax())
            req.out.append(tok)
            if (
                len(req.out) >= req.max_new
                or self.pos[slot] >= self.max_len - 1
            ):
                req.done = True
                finished[req.rid] = req.out
                self.active[slot] = None
        return finished

    def run_all(self, max_iters: int = 10_000) -> Dict[int, List[int]]:
        done: Dict[int, List[int]] = {}
        it = 0
        while (self.pending or any(self.active.values())) and (
            it < max_iters
        ):
            done.update(self.step())
            it += 1
        return done

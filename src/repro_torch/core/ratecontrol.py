"""Error-budgeted adaptive per-unit compression rates.

Port of ``repro.core.ratecontrol``: the same deterministic, replayable
``RateController``, plain Python and serializable. It assigns each
storage unit its own ZFP rate from the observed per-unit error,
re-deciding at sweep boundaries under a global relative-error ceiling.
Three consumers share one instance (or its decision log):

* the engines (``OutOfCoreWave`` and ``AsyncExecutor``) encode each
  writeback at ``rate_for(field, kind, idx, sweep)`` and feed the
  controller one ``observe(...)`` per encode;
* ``taskgraph.build_sweep_tasks(rates=...)`` replays the decision log,
  pricing every transfer at the exact encoded payload size;
* a checkpoint persists ``state_dict()``.

``mode="fixed"`` (default) returns the field spec's planes everywhere
and is bit-identical to not passing a controller. ``mode="adaptive"``
starts read-write compressed fields lossless (rate ``None``), then at
every sweep boundary gives each observed unit the smallest ladder rate
whose predicted error (a lossy observation extrapolated by
``2**(p_obs - p)``, else the codec's analytic bound at the unit's
amplitude), normalised by the field's largest unit amplitude, stays
under ``error_budget * margin``. Decisions are a sweep-indexed log of
cumulative rate maps, so ``rate_for`` is a bisect and a lookup.

The analytic bound reads the port's codec tables of the field's type
(float32 or float64).
"""

from __future__ import annotations

import math
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.kernels.zfp import ref as zfp_ref

__all__ = ["RateController", "rate_label", "DEFAULT_LADDER"]

# Candidate bit-plane counts, ascending (fewer planes = fewer bits =
# more aggressive). Spans 4:1 .. ~1.1:1 for f32.
DEFAULT_LADDER: Tuple[int, ...] = (6, 8, 10, 12, 14, 16, 20, 24, 28)

Rate = Optional[int]  # bit-planes, or None = lossless/raw


def rate_label(rate: Rate) -> str:
    """Stable string label of a rate — the key of the residency
    manager's per-rate byte gauges (``CacheStats.rate_bytes``) and of
    the bench histogram."""
    return "raw" if rate is None else f"p{int(rate)}"


def _ukey(field: str, kind: str, idx: int) -> str:
    return f"{field}.{kind}{idx}"


def _field_of(ukey: str) -> str:
    return ukey.rsplit(".", 1)[0]


def _analytic_bound(scale: float, planes: int, ndim: int,
                    dtype: str) -> float:
    """Pure-Python worst-case round-trip error of one encode at
    ``planes`` for a block of amplitude ``scale``: the formula of
    ``zfp.ref.max_abs_error_bound``, from the codec's tables of
    ``dtype`` (``_FRAC``, ``_WIDTH``: 26 and 32 for float32, 55 and 64
    for float64)."""
    key = zfp_ref.dtype_key(dtype)
    if scale <= 0.0:
        return 0.0
    frac, w = zfp_ref._FRAC[key], zfp_ref._WIDTH[key]
    emax = math.frexp(scale)[1] - 1
    pmin = min(zfp_ref.subband_planes(int(planes), ndim, w))
    bound = math.ldexp(1.0, emax - frac) * (2 ** ndim)
    if pmin < w:
        bound += math.ldexp(1.0, emax + (w - pmin) + 1 + ndim - frac)
    return bound


class RateController:
    """Deterministic per-unit rate policy under a global error budget.

    Parameters
    ----------
    cfg:
        The run's ``OOCConfig``. Only fields with ``spec.compressed``
        are managed; raw fields always get ``None`` and are untouched.
    mode:
        ``"fixed"`` (bit-identical to the spec-rate engine) or
        ``"adaptive"``.
    error_budget:
        Global ceiling on the *per-encode* relative error: for every
        re-encode, ``max|roundtrip - x| / global_field_scale`` must
        stay under this. ``max_observed_rel`` audits it live.
    ladder:
        Candidate planes, ascending. Defaults to ``DEFAULT_LADDER``.
    margin:
        Safety factor applied to the budget when deciding (predictions
        extrapolate one sweep ahead; the margin absorbs growth of a
        unit's amplitude between the observation and the next encode).
    lossless:
        ``(field, kind, idx)`` units pinned lossless forever — e.g. a
        region of interest that must stay bitwise-exact. Honored in
        both modes, ahead of every decision.
    """

    def __init__(
        self,
        cfg,
        mode: str = "fixed",
        error_budget: float = 1e-3,
        ladder: Optional[Iterable[int]] = None,
        margin: float = 0.25,
        lossless: Iterable[Tuple[str, str, int]] = (),
    ):
        if mode not in ("fixed", "adaptive"):
            raise ValueError(
                f"unknown rate mode {mode!r}; expected 'fixed' or "
                "'adaptive'"
            )
        if not (0.0 < margin <= 1.0):
            raise ValueError(f"margin must be in (0, 1], got {margin}")
        self.cfg = cfg
        self.mode = mode
        self.error_budget = float(error_budget)
        self.margin = float(margin)
        self.ladder: Tuple[int, ...] = tuple(
            sorted({int(p) for p in (ladder or DEFAULT_LADDER)})
        )
        if self.ladder and self.ladder[0] < 1:
            raise ValueError(f"ladder planes must be >= 1: {self.ladder}")
        self.lossless = frozenset(
            (f, k, int(i)) for f, k, i in lossless
        )
        # decision log: _starts[i] is the first sweep _maps[i] applies
        # to; maps are CUMULATIVE unit->rate assignments, so rate_for
        # is one bisect + one dict lookup
        self._starts: List[int] = [0]
        self._maps: List[Dict[str, Rate]] = [{}]
        # latest observation per unit: [planes-or-None, abs_err, scale]
        self._obs: Dict[str, List[object]] = {}
        # live audit of the ceiling: running max of abs_err at the
        # ACTUAL encode rate over the field's global scale
        self.max_observed_rel = 0.0
        self.decides = 0

    # ------------------------------------------------------------------
    # the rate map
    # ------------------------------------------------------------------
    def seed_rate(self, field: str, kind: str, idx: int) -> Rate:
        """The sweep-0 rate of a unit before any decision applies."""
        spec = self.cfg.fields[field]
        if not spec.compressed:
            return None
        if (field, kind, idx) in self.lossless:
            return None
        if self.mode == "adaptive" and spec.role == "rw":
            # conservative start: nothing is risked before it has been
            # observed (read-only fields are encoded exactly once, at
            # seed, so they keep the paper's spec rate)
            return None
        return spec.planes

    def rate_for(self, field: str, kind: str, idx: int,
                 sweep: int) -> Rate:
        """Planes for (re-)encoding this unit during ``sweep`` —
        ``None`` means ship it raw (lossless)."""
        spec = self.cfg.fields[field]
        if not spec.compressed:
            return None
        if (field, kind, idx) in self.lossless:
            return None
        if self.mode == "fixed":
            return spec.planes
        m = self._maps[bisect_right(self._starts, int(sweep)) - 1]
        key = _ukey(field, kind, idx)
        if key in m:
            return m[key]
        return self.seed_rate(field, kind, idx)

    def rate_histogram(self, plan, sweep: int) -> Dict[str, int]:
        """Unit count per rate label over every managed unit of
        ``plan`` at ``sweep`` (the bench row's per-rate histogram)."""
        hist: Dict[str, int] = {}
        for name, spec in self.cfg.fields.items():
            if not spec.compressed:
                continue
            for kind, idx, _ in plan.units():
                lbl = rate_label(self.rate_for(name, kind, idx, sweep))
                hist[lbl] = hist.get(lbl, 0) + 1
        return hist

    # ------------------------------------------------------------------
    # observation -> decision
    # ------------------------------------------------------------------
    def observe(
        self,
        field: str,
        kind: str,
        idx: int,
        planes: Rate,
        abs_err: float,
        scale: float,
    ) -> None:
        """Record one encode's measured round-trip error.

        ``planes`` is the rate the unit was actually encoded at
        (``None`` for a lossless commit, whose error is exactly 0),
        ``abs_err`` the measured ``max|roundtrip - x|`` and ``scale``
        the unit's amplitude ``max|x|``. No-op in fixed mode. The
        engines call this once per read-write writeback; order within
        a sweep is irrelevant (only the latest observation per unit
        feeds ``decide``)."""
        if self.mode != "adaptive":
            return
        spec = self.cfg.fields[field]
        if not spec.compressed or spec.role != "rw":
            return
        key = _ukey(field, kind, idx)
        self._obs[key] = [
            None if planes is None else int(planes),
            float(abs_err), float(scale),
        ]
        gscale = self._field_scale(field)
        if gscale > 0.0:
            self.max_observed_rel = max(
                self.max_observed_rel, float(abs_err) / gscale
            )

    def _field_scale(self, field: str) -> float:
        s = 0.0
        for key, (_, _, scale) in self._obs.items():
            if _field_of(key) == field:
                s = max(s, scale)
        return s

    def _predict_rel(
        self, planes_obs: Rate, abs_err: float, scale: float,
        planes: int, gscale: float,
    ) -> float:
        """Predicted relative error of the next encode at ``planes``,
        from the latest observation: one dropped bit-plane halves the
        error (the ``2**-p`` structure of the codec's bound), so a
        lossy observation extrapolates multiplicatively; a lossless
        one falls back to the analytic worst case at the observed
        amplitude."""
        if gscale <= 0.0:
            return 0.0
        if planes_obs is not None and abs_err > 0.0:
            return abs_err * (2.0 ** (planes_obs - planes)) / gscale
        return _analytic_bound(
            scale, planes, 3, self.cfg.dtype
        ) / gscale

    def decide(self, sweep: int) -> bool:
        """Re-decide the rate map at a sweep boundary: the new map
        applies to every sweep ``>= sweep``. Each observed unit gets
        the smallest ladder rate whose predicted relative error stays
        under ``error_budget * margin`` — or lossless when none does.
        Deterministic (sorted unit order, pure arithmetic); a no-op in
        fixed mode or before any observation. Returns whether the map
        changed."""
        if self.mode != "adaptive" or not self._obs:
            return False
        self.decides += 1
        target = self.error_budget * self.margin
        new = dict(self._maps[-1])
        gscale: Dict[str, float] = {}
        for key in sorted(self._obs):
            planes_obs, abs_err, scale = self._obs[key]
            field = _field_of(key)
            if field not in gscale:
                gscale[field] = self._field_scale(field)
            chosen: Rate = None
            for p in self.ladder:
                if self._predict_rel(
                    planes_obs, abs_err, scale, p, gscale[field]
                ) <= target:
                    chosen = p
                    break
            new[key] = chosen
        if new == self._maps[-1]:
            return False
        if self._starts[-1] == int(sweep):
            self._maps[-1] = new  # same boundary re-decided
        else:
            self._starts.append(int(sweep))
            self._maps.append(new)
        return True

    # ------------------------------------------------------------------
    # serialization (checkpoint manifest `extra["rates"]`)
    # ------------------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """JSON-able snapshot of the whole policy: configuration,
        decision log, pending observations, and the ceiling audit.
        ``from_state`` round-trips it bit-identically (floats survive
        JSON exactly in Python), so a restored run re-decides exactly
        what the uninterrupted run would have."""
        return {
            "mode": self.mode,
            "error_budget": self.error_budget,
            "margin": self.margin,
            "ladder": list(self.ladder),
            "lossless": sorted(
                [f, k, i] for f, k, i in self.lossless
            ),
            "starts": list(self._starts),
            "maps": [dict(m) for m in self._maps],
            "obs": {k: list(v) for k, v in sorted(self._obs.items())},
            "max_observed_rel": self.max_observed_rel,
            "decides": self.decides,
        }

    def load_state(self, d: Dict[str, object]) -> None:
        self.mode = d["mode"]
        self.error_budget = float(d["error_budget"])
        self.margin = float(d["margin"])
        self.ladder = tuple(int(p) for p in d["ladder"])
        self.lossless = frozenset(
            (f, k, int(i)) for f, k, i in d["lossless"]
        )
        self._starts = [int(s) for s in d["starts"]]
        self._maps = [
            {k: (None if v is None else int(v)) for k, v in m.items()}
            for m in d["maps"]
        ]
        self._obs = {
            k: [None if v[0] is None else int(v[0]),
                float(v[1]), float(v[2])]
            for k, v in d["obs"].items()
        }
        self.max_observed_rel = float(d["max_observed_rel"])
        self.decides = int(d["decides"])

    @classmethod
    def from_state(cls, cfg, d: Dict[str, object]) -> "RateController":
        ctrl = cls(cfg, mode=d["mode"])
        ctrl.load_state(d)
        return ctrl

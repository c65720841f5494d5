"""Runtime bandwidth-budget controller: adaptive top-n restoration (a
copy of ``repro/serve/controller.py``; numpy only).

The paper's headline word is *Adaptive*, yet ``QuantConfig.top_n_restore``
is a frozen field — every layer, request, and load level compensates the
same n experts.  This module closes the loop from live offload metering
to per-layer restoration intensity:

    offload/store.py meters wire bytes per decode chunk
        │
        ▼
    BandwidthController.update(bytes, tokens)     (between decode chunks)
        │   integral step on a per-layer intensity ladder
        ▼
    ControllerPlan: per-layer (top_n, rank_cap)
        │
        ├──► (L, 2) int32 plan array copied into the decode graph's
        │    plan buffer (fixed shape → the graph is NEVER recaptured)
        └──► per-layer top_n / rank_cap into the metering replay

Exploits that ``CompressedExpertStack`` factors are rank-padded with true
ranks tracked: capping the rank is a mask over the rank-space activation
(a slice of the padded factors), not a re-SVD.

Determinism: the controller state advances only on metered byte counters
(never wall-clock), so the same routing trace + budget always produces
the same plan sequence — pinned by ``tests/test_torch_serve.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import ControlConfig


class ControllerPlan(NamedTuple):
    """Per-MoE-layer restoration intensity."""
    top_n: np.ndarray        # (L,) int32: experts compensated per token
    rank_cap: np.ndarray     # (L,) int32: compensator rank ceiling

    def as_array(self) -> np.ndarray:
        """(L, 2) int32 — the fixed-shape array the decode step consumes."""
        return np.stack([self.top_n, self.rank_cap], axis=1).astype(np.int32)

    def summary(self) -> dict:
        return {"mean_top_n": float(self.top_n.mean()) if self.top_n.size else 0.0,
                "mean_rank_cap": (float(self.rank_cap.mean())
                                  if self.rank_cap.size else 0.0)}


def static_plan(pad_ranks: Sequence[int], top_n: int) -> ControllerPlan:
    """The frozen pre-controller operating point: ``top_n`` everywhere,
    ranks uncapped (cap = the layer's padded rank)."""
    l = len(pad_ranks)
    return ControllerPlan(np.full((l,), int(top_n), np.int32),
                          np.asarray(pad_ranks, np.int32))


@dataclasses.dataclass
class ControllerRecord:
    """One ``update`` observation (telemetry / convergence reporting)."""
    chunk: int
    tokens: int
    bytes_per_token: float
    level: int


class BandwidthController:
    """Integral controller over a per-layer (top_n, rank_cap) ladder.

    Each layer has the same ladder of intensity *rungs*::

        [(0, 0), (1, c1), ..., (1, R_l), (2, c1), ..., (top_k, R_l)]

    where the rank caps ``c_i`` are ``ControlConfig.rank_fracs`` fractions
    of the layer's padded rank ``R_l``.  The controller state is one
    global *level* in ``[0, L * (rungs - 1)]``: level ``g`` puts every
    layer at rung ``g // L`` and the first ``g % L`` layers one rung
    higher — L micro-steps per rung, so plan granularity is per layer,
    not per model.

    ``update`` moves the level by an integral step proportional to the
    relative budget error (capped at ``gain`` of the whole ladder), with
    a ``deadband`` inside which the plan holds.  With no budget (or
    ``enabled=False``) the plan stays pinned at the static operating
    point and ``update`` only records telemetry.
    """

    def __init__(self, pad_ranks: Sequence[int], top_k: int,
                 ccfg: ControlConfig, static_top_n: int):
        if len(pad_ranks) == 0:
            raise ValueError("controller needs at least one MoE layer")
        self.ccfg = ccfg
        self.top_k = int(top_k)
        self.pad_ranks = tuple(int(r) for r in pad_ranks)
        self.static_top_n = int(static_top_n)
        self.num_layers = len(self.pad_ranks)

        lo = max(0, ccfg.min_top_n)
        hi = self.top_k if ccfg.max_top_n < 0 else min(ccfg.max_top_n,
                                                       self.top_k)
        hi = max(hi, lo)
        # rung schedule shared by all layers: (top_n, rank fraction index);
        # per-layer caps resolve the fraction against that layer's pad rank
        self._rungs: List[Tuple[int, float]] = []
        for n in range(lo, hi + 1):
            if n == 0:
                self._rungs.append((0, 0.0))
            else:
                for f in ccfg.rank_fracs:
                    self._rungs.append((n, float(f)))
        self.max_level = self.num_layers * (len(self._rungs) - 1)
        self._level = self._static_level()
        self._ema: Optional[float] = None   # smoothed bytes/token signal
        self.history: List[ControllerRecord] = []
        self._chunks = 0

    # -- plan mapping ------------------------------------------------------
    def _static_level(self) -> int:
        """Ladder level of the frozen (static_top_n, full-rank) point."""
        n = min(max(self.static_top_n, self._rungs[0][0]),
                self._rungs[-1][0])
        idx = max(i for i, (rn, rf) in enumerate(self._rungs)
                  if rn == n)               # full-rank rung of that top_n
        return idx * self.num_layers

    def _rung_cap(self, rung: int, layer: int) -> int:
        n, frac = self._rungs[rung]
        if n == 0:
            return 0
        return max(1, int(np.ceil(self.pad_ranks[layer] * frac)))

    def plan_at(self, level: int) -> ControllerPlan:
        level = int(np.clip(level, 0, self.max_level))
        base, extra = divmod(level, self.num_layers)
        top_n = np.zeros((self.num_layers,), np.int32)
        cap = np.zeros((self.num_layers,), np.int32)
        for l in range(self.num_layers):
            rung = min(base + (1 if l < extra else 0), len(self._rungs) - 1)
            top_n[l] = self._rungs[rung][0]
            cap[l] = self._rung_cap(rung, l)
        return ControllerPlan(top_n, cap)

    def plan(self) -> ControllerPlan:
        if not self.active:
            return static_plan(self.pad_ranks, self.static_top_n)
        return self.plan_at(self._level)

    @property
    def active(self) -> bool:
        """True when the controller actually moves the plan."""
        return bool(self.ccfg.enabled
                    and self.ccfg.target_bytes_per_token > 0)

    @property
    def level(self) -> int:
        return self._level

    # -- feedback ----------------------------------------------------------
    def update(self, nbytes: int, tokens: int) -> ControllerPlan:
        """Consume one chunk's metered wire bytes; return the next plan.

        The per-chunk bytes/token sample is EMA-smoothed (chunk-scale LRU
        hit/miss dynamics make the raw signal noisy) and the ladder step
        is capped at ``max_step_frac`` of the whole ladder — uncapped
        proportional jumps limit-cycle around the budget instead of
        settling.  Driven purely by byte counters (no wall-clock), so the
        same trace + budget reproduces the same plan sequence exactly.
        (The JAX controller's per-shard budget scope comes with
        expert-parallel serving, not ported yet.)
        """
        self._chunks += 1
        measured = nbytes / tokens if tokens > 0 else 0.0
        target = self.ccfg.target_bytes_per_token
        if self.active and tokens > 0:
            a = min(max(self.ccfg.ema, 0.0), 1.0)
            self._ema = (measured if self._ema is None
                         else a * measured + (1.0 - a) * self._ema)
            err = (self._ema - target) / target
            if abs(err) > self.ccfg.deadband:
                cap = max(1, int(round(self.max_level
                                       * self.ccfg.max_step_frac)))
                step = min(cap, max(1, int(round(
                    self.ccfg.gain * min(abs(err), 1.0) * self.max_level))))
                self._level = int(np.clip(
                    self._level - step if err > 0 else self._level + step,
                    0, self.max_level))
        self.history.append(ControllerRecord(
            self._chunks, int(tokens), float(measured), self._level))
        return self.plan()

    # -- construction ------------------------------------------------------
    @classmethod
    def from_stacks(cls, stacks_by_layer: Sequence[dict], top_k: int,
                    ccfg: ControlConfig, static_top_n: int
                    ) -> "BandwidthController":
        """Build from the per-layer ``CompressedExpertStack`` dicts the
        engine's offload metering already holds.

        The rank ladder tops out at each layer's largest TRUE allocated
        rank — not the padded rank.  Under calibrated heterogeneous
        allocation (or an artifact padded for alignment) ``pad_rank``
        can exceed every true rank, and rungs in that gap would be
        identity plans: caps above an expert's true rank neither change
        the math (padding columns are exact zeros) nor the metered
        bytes (``compensator_bytes`` clamps at the true rank).  Topping
        out at the true rank makes every rung a real operating point,
        and the inactive-controller static plan (cap = ladder top) stays
        bit- and byte-identical to the uncontrolled path."""
        tops = []
        for stacks in stacks_by_layer:
            true_top = max(max(s.ranks) for s in stacks.values())
            tops.append(max(true_top, 1))
        return cls(tops, top_k, ccfg, static_top_n)

"""Calibration stage 2: heterogeneous precision allocation under a global
bytes budget.

Port of ``repro/calib/allocate.py``.  The measured calibration
statistics drive a water-filling/knapsack allocation of per-expert
bit-widths and per-(projection, expert) compensator ranks under one
wire-byte budget:

    minimize   sum_l sum_p sum_e  imp_e * err(e, p, bits_e, rank_ep)
    subject to sum of wire bytes <= budget

``err`` is the whitened-residual tail norm: for each candidate width the
experts are quantized (HQQ) and the singular spectrum of their
(activation-whitened) residual computed, so the objective is the
quantity compression realizes.  The tables are built on the device the
weights live on, batched over the experts of a projection: HQQ over the
(E, K, N) stack at each width, and the spectrum from ``eigvalsh`` of the
smaller Gram matrix in float64 (the route of ``core/pipeline.py``'s
factorization) instead of the JAX package's per-expert host SVD.  The
lazy-greedy knapsack itself is host Python over float64, as in JAX.

The kurtosis heuristic survives as one pluggable *scorer* (``SCORERS``):
scorers only set the per-expert importance weights.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import QuantConfig
from ..core.kurtosis import kurtosis
from ..core.pipeline import hqq_quantize_stack, whiten_vector
from ..core.quantize import (PLANES, dequantize_codes, factor_wire_bytes,
                             quant_wire_bytes)
from .stats import LayerCalibStats

PROJS = ("w1", "w2", "w3")
DEFAULT_BITS_CANDIDATES = (2, 3, 4, 8)


# ---------------------------------------------------------------------------
# plan containers (JSON round-trippable for the artifact manifest)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerAllocation:
    """One MoE layer's allocation: per-expert bits (shared by the three
    projections of an expert) and per-(projection, expert) ranks."""
    bits: np.ndarray                  # (E,) int
    ranks: Dict[str, np.ndarray]      # proj -> (E,) int

    def to_json(self) -> Dict:
        return {"bits": np.asarray(self.bits, np.int64).tolist(),
                "ranks": {p: np.asarray(r, np.int64).tolist()
                          for p, r in self.ranks.items()}}

    @classmethod
    def from_json(cls, d: Dict) -> "LayerAllocation":
        return cls(np.asarray(d["bits"], np.int64),
                   {p: np.asarray(r, np.int64)
                    for p, r in d["ranks"].items()})


@dataclasses.dataclass
class CompressionPlan:
    """Output of the budget allocator; input to ``compress_moe_params``."""
    layers: List[LayerAllocation]
    budget_bytes: float
    spent_bytes: int
    scorer: str
    predicted_err: float = 0.0        # objective value at the allocation

    def to_json(self) -> Dict:
        return {"layers": [l.to_json() for l in self.layers],
                "budget_bytes": float(self.budget_bytes),
                "spent_bytes": int(self.spent_bytes),
                "scorer": self.scorer,
                "predicted_err": float(self.predicted_err)}

    @classmethod
    def from_json(cls, d: Dict) -> "CompressionPlan":
        return cls([LayerAllocation.from_json(l) for l in d["layers"]],
                   d["budget_bytes"], d["spent_bytes"], d["scorer"],
                   d.get("predicted_err", 0.0))

    def summary(self) -> Dict:
        bits = np.concatenate([l.bits for l in self.layers])
        ranks = np.concatenate([r for l in self.layers
                                for r in l.ranks.values()])
        return {"mean_bits": float(bits.mean()),
                "bits_hist": {int(b): int((bits == b).sum())
                              for b in np.unique(bits)},
                "mean_rank": float(ranks.mean()),
                "spent_bytes": int(self.spent_bytes),
                "budget_bytes": float(self.budget_bytes)}


# ---------------------------------------------------------------------------
# importance scorers
# ---------------------------------------------------------------------------

def _score_calibrated(weights: Dict[str, torch.Tensor],
                      stats: Optional[LayerCalibStats]) -> np.ndarray:
    if stats is None:
        raise ValueError("scorer 'calibrated' needs collected LayerCalibStats")
    return stats.importance()


def _score_kurtosis(weights: Dict[str, torch.Tensor],
                    stats: Optional[LayerCalibStats]) -> np.ndarray:
    """The paper's proxy: heavier-tailed experts matter more (no corpus)."""
    e = weights["w1"].shape[0]
    k = np.zeros(e)
    for w in weights.values():
        k += np.asarray([float(kurtosis(w[i])) for i in range(e)])
    k = np.maximum(k - k.min(), 1e-6)
    return k / k.sum()


def _score_uniform(weights: Dict[str, torch.Tensor],
                   stats: Optional[LayerCalibStats]) -> np.ndarray:
    e = weights["w1"].shape[0]
    return np.full(e, 1.0 / e)


SCORERS = {
    "calibrated": _score_calibrated,
    "kurtosis": _score_kurtosis,
    "uniform": _score_uniform,
}


# ---------------------------------------------------------------------------
# per-candidate error model (actual quantization, whitened spectra)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ExpertTable:
    """Error/cost lookup for one (layer, projection, expert):
    ``tails[b_idx]`` are the whitened-residual singular spectrum's tail
    norms, so err(bits b_idx, rank r) = tails[b_idx][r]; relative to the
    whitened weight norm."""
    tails: List[np.ndarray]           # per bits candidate: (min(k, n) + 1,)
    k: int
    n: int


@torch.no_grad()
def _projection_tables(w: torch.Tensor, qcfg: QuantConfig,
                       bits_candidates: Sequence[int],
                       moments: Optional[np.ndarray]) -> List[_ExpertTable]:
    """Tables of every expert of one (E, K, N) projection stack, built on
    the stack's device.  Each candidate width quantizes the stack with
    ``hqq_quantize_stack``, the route of ``compress_expert_stack``; the
    residual, whitened
    by ``whiten_vector`` of each expert's (K,) moment, gives its squared
    singular values as the eigenvalues of its smaller Gram matrix in
    float64."""
    e, k, n = w.shape
    g = min(qcfg.group_size, k) if qcfg.group_size > 0 else k
    w32 = w.float()
    white = None
    if moments is not None:
        white = torch.as_tensor(np.stack([whiten_vector(m)
                                          for m in moments]),
                                dtype=torch.float64, device=w.device)
    wn = w32.double()
    if white is not None:
        wn = wn * white[:, :, None]
    wnorm = torch.clamp(torch.linalg.norm(wn.reshape(e, -1), dim=1),
                        min=1e-12)
    del wn
    tails = []
    for b in bits_candidates:
        s, z, q = hqq_quantize_stack(w32, b, g, qcfg)
        resid = (w32 - dequantize_codes(q, s, z, g)).double()
        del s, z, q
        if white is not None:
            resid = resid * white[:, :, None]
        gram = resid @ resid.mT if k <= n else resid.mT @ resid
        del resid
        lam = torch.clamp(torch.linalg.eigvalsh(gram), min=0.0)  # ascending
        del gram
        tail2 = torch.cat([torch.flip(torch.cumsum(lam, dim=-1), (-1,)),
                           torch.zeros_like(lam[:, :1])], dim=-1)
        tails.append((torch.sqrt(torch.clamp(tail2, min=0.0))
                      / wnorm[:, None]).cpu().numpy())
    return [_ExpertTable([t[ei] for t in tails], k, n) for ei in range(e)]


# ---------------------------------------------------------------------------
# the budgeted lazy-greedy knapsack
# ---------------------------------------------------------------------------

def _rank_candidates(buckets: Sequence[int], max_rank: int) -> List[int]:
    return sorted({0} | {int(b) for b in buckets if 0 < b <= max_rank})


def allocate_budget(weights_by_layer: List[Dict[str, torch.Tensor]],
                    qcfg: QuantConfig, budget_bytes: float, *,
                    stats: Optional[List[LayerCalibStats]] = None,
                    scorer: str = "calibrated",
                    bits_candidates: Sequence[int] = DEFAULT_BITS_CANDIDATES
                    ) -> CompressionPlan:
    """Allocate per-expert bits + per-(projection, expert) ranks under a
    global wire-byte budget (water-filling by marginal benefit/byte).

    ``budget_bytes`` constrains the summed wire bytes of every expert's
    quantized weights + allocated compensator.

    Every expert starts at the smallest candidate width and rank 0;
    upgrades are applied best-benefit-per-byte first until the budget is
    exhausted.  Infeasible budgets return the floor allocation with
    ``spent_bytes`` > ``budget_bytes``.
    """
    bits_candidates = sorted(set(int(b) for b in bits_candidates))
    for b in bits_candidates:
        if b not in PLANES:
            raise ValueError(f"bits candidate {b} unsupported "
                             f"(PLANES: {sorted(PLANES)})")
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; one of "
                         f"{sorted(SCORERS)}")
    if stats is not None and len(stats) != len(weights_by_layer):
        raise ValueError(f"{len(stats)} stats layers for "
                         f"{len(weights_by_layer)} weight layers")

    layers = []
    tables: Dict[Tuple[int, str, int], _ExpertTable] = {}
    imps: List[np.ndarray] = []
    for li, weights in enumerate(weights_by_layer):
        lstats = stats[li] if stats is not None else None
        imps.append(SCORERS[scorer](weights, lstats))
        e = weights["w1"].shape[0]
        for proj in PROJS:
            if proj not in weights:
                continue
            mom = lstats.moment_for(proj) if lstats is not None else None
            for ei, t in enumerate(_projection_tables(
                    weights[proj], qcfg, bits_candidates, mom)):
                tables[(li, proj, ei)] = t
        layers.append(LayerAllocation(
            np.full((e,), bits_candidates[0], np.int64),
            {p: np.zeros((e,), np.int64) for p in PROJS if p in weights}))

    rank_cands = {key: _rank_candidates(qcfg.rank_buckets, min(t.k, t.n))
                  for key, t in tables.items()}
    bidx = {(li, ei): 0 for li, l in enumerate(layers)
            for ei in range(len(l.bits))}
    ridx = {key: 0 for key in tables}

    def expert_err(li, proj, ei) -> float:
        t = tables[(li, proj, ei)]
        r = rank_cands[(li, proj, ei)][ridx[(li, proj, ei)]]
        return float(imps[li][ei] * t.tails[bidx[(li, ei)]][r])

    def total_err() -> float:
        """Importance-weighted relative error, mean over the (layer,
        projection) pools (the normalization of
        :func:`weighted_restoration_error`)."""
        pools = len({(li, p) for (li, p, _) in tables})
        return sum(expert_err(li, p, ei)
                   for (li, p, ei) in tables) / max(pools, 1)

    def quant_bytes(li, ei, b) -> float:
        g = qcfg.group_size
        tot = 0
        for proj in layers[li].ranks:
            t = tables[(li, proj, ei)]
            gg = min(g, t.k) if g > 0 else t.k
            tot += quant_wire_bytes(b, t.k, t.n, gg)
        return tot

    def rank_bytes(li, proj, ei, r) -> float:
        t = tables[(li, proj, ei)]
        return factor_wire_bytes(r, t.k, t.n, qcfg.factor_bits)

    spent = 0.0
    for li, l in enumerate(layers):
        for ei in range(len(l.bits)):
            spent += quant_bytes(li, ei, bits_candidates[0])

    def bits_upgrade(li, ei):
        """(gain, cost) of stepping expert (li, ei) one width up."""
        bi = bidx[(li, ei)]
        if bi + 1 >= len(bits_candidates):
            return None
        gain = 0.0
        for proj in layers[li].ranks:
            t = tables[(li, proj, ei)]
            r = rank_cands[(li, proj, ei)][ridx[(li, proj, ei)]]
            gain += imps[li][ei] * (t.tails[bi][r] - t.tails[bi + 1][r])
        cost = (quant_bytes(li, ei, bits_candidates[bi + 1])
                - quant_bytes(li, ei, bits_candidates[bi]))
        return gain, cost

    def rank_upgrade(li, proj, ei):
        key = (li, proj, ei)
        ri = ridx[key]
        cands = rank_cands[key]
        if ri + 1 >= len(cands):
            return None
        t = tables[key]
        bi = bidx[(li, ei)]
        gain = imps[li][ei] * (t.tails[bi][cands[ri]]
                               - t.tails[bi][cands[ri + 1]])
        cost = (rank_bytes(li, proj, ei, cands[ri + 1])
                - rank_bytes(li, proj, ei, cands[ri]))
        return gain, cost

    def push(heap, knob):
        up = (bits_upgrade(*knob[1:]) if knob[0] == "bits"
              else rank_upgrade(*knob[1:]))
        if up is None:
            return
        gain, cost = up
        if cost <= 0:
            return
        heapq.heappush(heap, (-gain / cost, gain, cost, knob))

    heap: list = []
    for (li, ei) in bidx:
        push(heap, ("bits", li, ei))
    for (li, proj, ei) in tables:
        push(heap, ("rank", li, proj, ei))

    # lazy-greedy: a popped entry's gain may be stale (its expert's other
    # knob moved since the push); recompute and re-push unless it is
    # still the best on offer
    while heap:
        prio, gain, cost, knob = heapq.heappop(heap)
        cur = (bits_upgrade(*knob[1:]) if knob[0] == "bits"
               else rank_upgrade(*knob[1:]))
        if cur is None:
            continue
        cgain, ccost = cur
        if ccost <= 0:
            continue
        cprio = -cgain / ccost
        if heap and cprio > heap[0][0] + 1e-15:
            heapq.heappush(heap, (cprio, cgain, ccost, knob))
            continue
        if spent + ccost > budget_bytes:
            continue                      # too big; cheaper knobs may fit
        spent += ccost
        if knob[0] == "bits":
            _, li, ei = knob
            bidx[(li, ei)] += 1
            layers[li].bits[ei] = bits_candidates[bidx[(li, ei)]]
        else:
            _, li, proj, ei = knob
            ridx[(li, proj, ei)] += 1
            layers[li].ranks[proj][ei] = \
                rank_cands[(li, proj, ei)][ridx[(li, proj, ei)]]
        push(heap, knob)

    return CompressionPlan(layers, float(budget_bytes), int(round(spent)),
                           scorer, predicted_err=total_err())


# ---------------------------------------------------------------------------
# uniform baseline + evaluation helpers
# ---------------------------------------------------------------------------

def uniform_plan(weights_by_layer: List[Dict[str, torch.Tensor]],
                 qcfg: QuantConfig, bits: int, rank: int) -> CompressionPlan:
    """The ablation baseline: every expert at ``bits`` with rank ``rank``
    compensators (the equal-bytes comparison point)."""
    layers = []
    for weights in weights_by_layer:
        e = weights["w1"].shape[0]
        layers.append(LayerAllocation(
            np.full((e,), bits, np.int64),
            {p: np.full((e,), min(rank, min(weights[p].shape[1:])),
                        np.int64)
             for p in PROJS if p in weights}))
    return CompressionPlan(layers, 0.0, plan_wire_bytes(layers, qcfg,
                                                        weights_by_layer),
                           "uniform-fixed")


def plan_wire_bytes(layers: List[LayerAllocation], qcfg: QuantConfig,
                    weights_by_layer: List[Dict[str, torch.Tensor]]) -> int:
    """Total wire bytes a plan occupies (weights + compensators), by the
    formulas the stacks and the offload meter use."""
    total = 0
    for l, weights in zip(layers, weights_by_layer):
        for proj, ranks in l.ranks.items():
            _, k, n = weights[proj].shape
            g = min(qcfg.group_size, k) if qcfg.group_size > 0 else k
            for ei, r in enumerate(ranks):
                total += quant_wire_bytes(int(l.bits[ei]), k, n, g)
                total += factor_wire_bytes(int(r), k, n, qcfg.factor_bits)
    return total


def stacks_wire_bytes(stacks_by_layer: List[Dict]) -> int:
    """Total wire bytes of compressed stacks (all experts, compensated at
    their true ranks)."""
    return sum(s.expert_wire_bytes(e, compensated=True)
               for stacks in stacks_by_layer for s in stacks.values()
               for e in range(s.scale.shape[0]))


@torch.no_grad()
def weighted_restoration_error(stacks_by_layer: List[Dict],
                               weights_by_layer: List[Dict[str, torch.Tensor]],
                               importance: List[np.ndarray]) -> float:
    """Importance-weighted relative restoration error of compressed stacks
    against the original weights: sum_e imp_e * ||W_e - W_hat_e|| /
    ||W_e||, mean over projections and layers; float64 on the weights'
    device."""
    errs = []
    for stacks, weights, imp in zip(stacks_by_layer, weights_by_layer,
                                    importance):
        for proj, stack in stacks.items():
            w = weights[proj].double()
            e = w.shape[0]
            diff = (w - stack.dequantize_all().double()
                    - stack.compensation_all().double()).reshape(e, -1)
            nw = torch.clamp(torch.linalg.norm(w.reshape(e, -1), dim=1),
                             min=1e-12)
            rel = (torch.linalg.norm(diff, dim=1) / nw).cpu().numpy()
            del w, diff
            errs.append(float((imp * rel).sum()))
    return float(np.mean(errs))


def moe_weights_by_layer(params, cfg) -> List[Dict[str, torch.Tensor]]:
    """Each MoE layer's dense (E, K, N) projection stacks from a parameter
    dict, global layer order (that of ``compress_moe_params``).  The
    tensors are the parameters themselves, on their device: no copy."""
    from ..models.transformer import layer_specs
    return [{k: lp["moe"][k] for k in PROJS if k in lp["moe"]}
            for lp, spec in zip(params["layers"], layer_specs(cfg))
            if spec.ffn == "moe"]

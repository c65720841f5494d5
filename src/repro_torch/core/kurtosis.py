"""Kurtosis-guided rank allocation (paper §3.1, step 1).

Port of ``repro/core/kurtosis.py``: experts with heavier-tailed weights
get larger compensator ranks, greedily from a bucket set under the
global budget ``sum(r_i) <= N * R_avg``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import RANK_BUCKETS


def kurtosis(w: torch.Tensor) -> torch.Tensor:
    """Pearson kurtosis over all elements of ``w``."""
    w = w.float().reshape(-1)
    mu = torch.mean(w)
    d = w - mu
    var = torch.mean(d * d)
    return torch.mean(d ** 4) / torch.clamp(var, min=1e-12) ** 2


def allocate_ranks(kurt: Sequence[float], rank_budget: int,
                   buckets: Tuple[int, ...] = RANK_BUCKETS,
                   max_rank: int | None = None) -> np.ndarray:
    """Greedy bucket assignment under ``sum(r) <= N * rank_budget``, in
    descending-kurtosis order (each expert gets the largest bucket that
    keeps the running total within budget)."""
    kurt = np.asarray(kurt, dtype=np.float64)
    n = len(kurt)
    budget = n * rank_budget
    usable = sorted((b for b in buckets
                     if max_rank is None or b <= max_rank), reverse=True)
    order = np.argsort(-kurt, kind="stable")
    ranks = np.zeros(n, dtype=np.int64)
    spent = 0
    for idx in order:
        for b in usable:
            if spent + b <= budget:
                ranks[idx] = b
                spent += b
                break
    return ranks


def uniform_ranks(n: int, rank_budget: int,
                  buckets: Tuple[int, ...] = RANK_BUCKETS) -> np.ndarray:
    """Ablation baseline: same bucket rank for every expert."""
    feasible = [b for b in buckets if b <= rank_budget]
    r = max(feasible) if feasible else 0
    return np.full(n, r, dtype=np.int64)

"""Layer-ahead expert prefetcher (related-work systems [5,19,33,42]); a
copy of ``repro/offload/prefetch.py`` (numpy only).

While layer l computes, predict layer l+1's experts and issue their
fetches.  Prediction uses the previous token's routing at l+1 (decode-time
temporal locality) — the cheap predictor HOBBIT-class systems use; accuracy
and the wasted-fetch ratio are metered so benchmarks can quantify the
prediction-miss penalty the paper's related-work section describes.

The prediction set is capped at ``top_k`` experts per active request
stream (ranked by how many streams routed to them last step): ``top_k``
is the router's per-token fetch width, so the prefetcher never issues
more speculative traffic per stream than the demand path would.
``ExpertStore.prefetch`` inserts the predictions into the device LRU and
meters their bytes — correct predictions become cache *hits* on the
demand access, mispredictions are metered as wasted prefetch bytes
(``offload/store.py::replay_decode_trace``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PrefetchStats:
    issued: int = 0
    useful: int = 0
    wasted: int = 0

    @property
    def accuracy(self) -> float:
        return self.useful / self.issued if self.issued else 0.0


class LayerAheadPrefetcher:
    """Predicts layer l+1 experts = previous token's experts at l+1."""

    def __init__(self, num_layers: int, top_k: int):
        self.top_k = int(top_k)
        self.prev_token: List[Optional[np.ndarray]] = [None] * num_layers
        self.stats = PrefetchStats()

    def predict(self, layer: int) -> Optional[np.ndarray]:
        return self.prev_token[layer]

    def observe(self, layer: int, experts: np.ndarray):
        """Score the pending prediction against this step's experts and
        remember them for the next step.  ``experts`` may be any shape
        (batched decode passes the whole step's (rows, k) ids); entries
        < 0 (masked scheduler slots) are ignored; the stored prediction
        keeps at most ``top_k`` experts per observed row, most-frequent
        first."""
        a = np.asarray(experts)
        rows = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
        rows = rows[(rows >= 0).any(axis=1)]
        flat = rows.reshape(-1)
        flat = flat[flat >= 0]
        if flat.size == 0:
            # Fully-masked step: the pending prediction went unconsumed.
            # Expire it rather than keep it alive — a later step would
            # meter the stale warm as a fresh (and likely wasted)
            # prefetch for routing that is now a full step old.
            self.prev_token[layer] = None
            return
        uniq, counts = np.unique(flat, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        cap = self.top_k * max(len(rows), 1)
        experts = np.sort(uniq[order[:cap]])
        pred = self.prev_token[layer]
        if pred is not None:
            hit = len(np.intersect1d(pred, experts))
            self.stats.issued += len(pred)
            self.stats.useful += hit
            self.stats.wasted += len(pred) - hit
        self.prev_token[layer] = experts.copy()

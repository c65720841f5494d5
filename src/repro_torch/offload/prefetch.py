"""Layer-ahead expert prefetcher (related-work systems [5,19,33,42]) and
the speculative lookahead prefetcher; a copy of
``repro/offload/prefetch.py`` (numpy only).

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
from typing import Dict, List, Optional, Sequence

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


class LookaheadPrefetcher:
    """Router-speculative lookahead prefetcher (serve/speculative.py).

    The speculative verify pass computes router decisions for all k+1
    round positions in one batched forward, so while layer l streams the
    routing of every not-yet-verified token at layer l is already known:
    predictions are *exact* routing, not a heuristic.  What is
    speculative is the tokens themselves: warms issued for positions the
    rejection sampler later discards are the attributable cost of
    speculation, metered separately (``bytes_wasted`` = draft overhead
    bytes) from the layer-ahead heuristic's misprediction waste.

    Per round, ``begin_round`` installs the verify trace
    (steps, layers, rows, k); ``predict(step, layer)`` returns the
    deduplicated expert set that position touches; ``score`` splits the
    issued prediction into useful (used by a scheduler-accepted
    position) and wasted (rejected suffix / dead slot) and accumulates
    the byte attribution.
    """

    def __init__(self, num_layers: int, top_k: int):
        self.num_layers = int(num_layers)
        self.top_k = int(top_k)
        self.stats = PrefetchStats()
        self.bytes_issued = 0          # all lookahead prefetch bytes fetched
        self.bytes_wasted = 0          # subset issued for rejected positions
        self._trace: Optional[np.ndarray] = None

    def begin_round(self, trace: np.ndarray):
        """Install one verify round's router trace, shaped
        (steps, layers, rows, k) with masked entries < 0."""
        t = np.asarray(trace)
        assert t.ndim == 4 and t.shape[1] == self.num_layers, t.shape
        self._trace = t

    def predict(self, step: int, layer: int) -> Optional[np.ndarray]:
        if self._trace is None:
            return None
        flat = self._trace[step, layer].reshape(-1)
        flat = np.unique(flat[flat >= 0])
        return flat if flat.size else None

    def score(self, pred: np.ndarray, accepted_rows: np.ndarray,
              fetched: Dict[int, int]) -> int:
        """Score one (step, layer) prediction.  ``accepted_rows`` holds
        the routing of the scheduler-accepted rows at that position
        (empty when the position was rejected wholesale); ``fetched``
        maps expert -> bytes actually moved by the warm.  Returns the
        wasted-byte subtotal so the caller can charge the store's
        wasted-prefetch meter."""
        used = np.unique(accepted_rows[accepted_rows >= 0]) \
            if accepted_rows.size else np.empty((0,), np.int64)
        hit = len(np.intersect1d(pred, used))
        self.stats.issued += len(pred)
        self.stats.useful += hit
        self.stats.wasted += len(pred) - hit
        used_set = set(used.tolist())
        wasted_b = sum(b for e, b in fetched.items() if e not in used_set)
        self.bytes_issued += sum(fetched.values())
        self.bytes_wasted += wasted_b
        return wasted_b

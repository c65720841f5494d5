"""Deterministic synthetic LM data: a Zipfian Markov stream with enough
structure (bigram dependencies) that a small model measurably learns —
perplexity drops well below unigram entropy — so compression benchmarks
can report honest quality deltas.

Port of ``repro/data/synthetic.py`` (numpy only): the same seed gives
the same token batches, bit for bit.  ``batch`` reads each Markov
state's cumulative distribution from a table built once, instead of
sorting a vocabulary-wide permutation per token: the same floats in the
same summation order, so the same draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticLMConfig:
    vocab_size: int = 512
    seq_len: int = 128
    batch_size: int = 8
    zipf_a: float = 1.2          # unigram skew
    markov_states: int = 4       # bigram structure (few states = learnable)
    seed: int = 0


class SyntheticLM:
    """Stateless, shardable token stream: batch i is a pure function of
    (seed, step, i), so restarts and elastic re-sharding reproduce the
    exact stream."""

    def __init__(self, cfg: SyntheticLMConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # unigram Zipf over vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (ranks ** -cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # each "state" (prev token % states) has its own permuted Zipf
        self.perms = np.stack([rng.permutation(v)
                               for _ in range(cfg.markov_states)])
        # (states, V) per-state CDF: row s is _token_probs of a token in
        # state s, cumulated along the vocabulary as ``batch`` draws it
        self._cdf = np.stack([self._token_probs(np.array([s]))[0].cumsum()
                              for s in range(cfg.markov_states)])

    def _token_probs(self, prev: np.ndarray) -> np.ndarray:
        state = prev % self.cfg.markov_states
        return self.unigram[np.argsort(self.perms[state], axis=-1)]

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xBEA]))
        toks = np.zeros((cfg.batch_size, cfg.seq_len), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=cfg.batch_size,
                                p=self.unigram)
        for t in range(1, cfg.seq_len):
            cdf = self._cdf[toks[:, t - 1] % cfg.markov_states]
            u = rng.random((cfg.batch_size, 1))
            toks[:, t] = (cdf < u).sum(axis=-1)
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def entropy_floor(self) -> float:
        """Per-token entropy of the conditional distribution (nats) — the
        best achievable loss; useful to judge training progress."""
        p = self.unigram
        return float(-(p * np.log(p)).sum())

"""Speculative decoding: drafters and rejection-sampling acceptance (port
of ``repro/serve/speculative.py``).

One serve-loop iteration becomes a *round*: a drafter proposes ``k``
continuation tokens per slot, and one batched step-mode forward over all
``k+1`` round positions (the sampled token + the k drafts) verifies them
against the target model: the expensive pass runs once per round instead
of once per token, and its router trace is known for every
not-yet-verified position, which is what the ``LookaheadPrefetcher``
(offload/prefetch.py) turns into expert warms.

Acceptance (``accept_drafts``) is standard rejection sampling for
point-mass proposals.  Draft token d_i at verify position i is accepted
with probability p_target(d_i) (greedy: iff d_i == argmax), and
acceptance is cumulative: the first rejection truncates the round, so per
slot the committed tokens are 1 sampled token + the accepted draft prefix
(accepted length in [1, k+1]).  The rejected token is *banned* from the
next round's first sample (``mask_banned``): the next round's carry
logits are the distribution at the rejection position, so masking d there
IS sampling the residual of point-mass rejection sampling.  At
temperature 0 a rejected draft is not the argmax, so banning it never
changes the argmax and greedy speculative decode stays token-identical to
the autoregressive engine.

Randomness at temperature > 0 comes in as uniforms drawn from an explicit
``torch.Generator`` before the round (the JAX package splits a key inside
its jitted round): ``accept_drafts`` compares them with p_target(d_i), and
``sample_uniform`` turns one per row into a categorical sample by
inverting the row's CDF.  A round captured as a CUDA graph thus reads its
randomness from input buffers, and a re-run of a round (streaming) reuses
the same draws.

KV semantics: the verify pass appends cache entries for all k+1
positions; ``models/transformer.py::cache_rollback`` then invalidates and
zeroes everything past each slot's accepted length in place, leaving the
cache bit-identical to never having drafted the rejected suffix.

The drafters run on the host (the n-gram tables) or re-read a window of
each slot's committed tokens through a cache-free forward in the train
context (the draft model), as the JAX package's drafter does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig, SpecConfig


# ---------------------------------------------------------------------------
# device-side acceptance math (run inside the engine's verify round)
# ---------------------------------------------------------------------------

def mask_banned(logits: torch.Tensor, banned: torch.Tensor) -> torch.Tensor:
    """Mask each row's banned token (-1 = none) to -inf.

    ``banned`` carries the previous round's first-rejected draft token:
    removing it from this round's first sample realizes the residual
    distribution of point-mass rejection sampling (module docstring)."""
    v = logits.shape[-1]
    hit = (torch.arange(v, device=logits.device)[None, :]
           == banned.clamp(min=0)[:, None]) & (banned >= 0)[:, None]
    return logits.masked_fill(hit, float("-inf"))


def accept_drafts(logits: torch.Tensor, draft: torch.Tensor,
                  uniforms: Optional[torch.Tensor],
                  temperature: float) -> torch.Tensor:
    """Cumulative acceptance mask (S, k) for point-mass draft proposals.

    ``logits``: (S, k, V) target distributions at the draft positions (row
    i scores draft token i).  temperature <= 0 accepts while the draft
    matches the argmax (``uniforms`` unused); otherwise draft i is
    accepted when ``uniforms[:, i]`` (S, k) in [0, 1) falls below
    p_target(draft_i).  The cumulative product enforces the prefix
    property: everything after the first rejection is rejected."""
    if temperature <= 0.0:
        ok = draft == torch.argmax(logits, dim=-1).to(draft.dtype)
    else:
        p = torch.softmax(logits.float() / temperature, dim=-1)
        pd = p.gather(-1, draft.long()[..., None])[..., 0]
        ok = uniforms < pd
    return torch.cumprod(ok.to(torch.int32), dim=1).bool()


def sample_uniform(logits: torch.Tensor, uniforms: Optional[torch.Tensor],
                   temperature: float) -> torch.Tensor:
    """(S,) i32 tokens from (S, V) logits: the argmax at temperature <= 0;
    otherwise the categorical sample of softmax(logits / temperature) that
    ``uniforms`` (S,) in [0, 1) selects by inverting each row's CDF (a
    token of zero probability, a banned one, is never chosen)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    # u in (0, total]: the first index whose cdf reaches it has p > 0
    u = ((1.0 - uniforms) * cdf[:, -1])[:, None]
    idx = torch.searchsorted(cdf, u.contiguous())[:, 0]
    return idx.clamp(max=logits.shape[-1] - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# drafters (host-side: they only see committed tokens)
# ---------------------------------------------------------------------------

class NGramDrafter:
    """Backoff n-gram proposer over each slot's committed stream.

    Per slot, one table per context length n in [1, order-1] maps the
    last n tokens to the most recently seen continuation; proposals back
    off from the longest matching context to the shortest, falling back
    to repeating the last token when even the unigram context is unseen.
    """

    def __init__(self, order: int = 3):
        assert order >= 2, order
        self.order = int(order)
        self._hist: Dict[int, List[int]] = {}
        self._tables: Dict[int, Dict[int, Dict[tuple, int]]] = {}

    def _fresh_tables(self) -> Dict[int, Dict[tuple, int]]:
        return {n: {} for n in range(1, self.order)}

    def reset_slot(self, slot: int, prompt_tokens: np.ndarray):
        """(Re)bind ``slot`` to a fresh request; seed from its prompt."""
        self._hist[slot] = []
        self._tables[slot] = self._fresh_tables()
        self.observe(slot, prompt_tokens)

    def observe(self, slot: int, tokens: np.ndarray):
        """Append committed tokens to the slot's stream."""
        h = self._hist.setdefault(slot, [])
        tabs = self._tables.setdefault(slot, self._fresh_tables())
        for t in np.asarray(tokens).reshape(-1).tolist():
            h.append(int(t))
            for n in range(1, self.order):
                if len(h) > n:
                    tabs[n][tuple(h[-n - 1:-1])] = int(t)

    def propose(self, slot: int, k: int) -> np.ndarray:
        h = self._hist.get(slot)
        if not h:
            return np.zeros((k,), np.int32)
        tabs = self._tables.get(slot) or self._fresh_tables()
        cur = list(h)
        out = []
        for _ in range(k):
            nxt = None
            for n in range(self.order - 1, 0, -1):
                nxt = tabs[n].get(tuple(cur[-n:]))
                if nxt is not None:
                    break
            if nxt is None:
                nxt = cur[-1]
            out.append(nxt)
            cur.append(nxt)
        return np.asarray(out, np.int32)

    def propose_all(self, num_slots: int, k: int) -> np.ndarray:
        """(num_slots, k) proposals; slots never reset draft zeros (their
        rows are dead scheduler slots, masked out downstream)."""
        return np.stack([self.propose(s, k) for s in range(num_slots)])


class DraftModelDrafter:
    """Greedy proposals from a small stand-in draft model.

    The draft model re-reads a fixed ``window`` of each slot's committed
    tail per proposal step (a cache-free forward: no draft KV
    cache to keep in sync with the target's commit and rollback) and
    extends with its argmax ``k`` times.  Proposals are point-mass: the
    verify pass applies the same rejection rule as the n-gram path.

    ``moe_ep_fn`` (``distributed.moe_parallel.make_moe_ep_fn``): the MoE
    layers of ``params`` hold one rank's slice of the experts, and the
    forward dispatches into them by all-to-all, as a mesh engine's
    prefill does."""

    def __init__(self, cfg: ModelConfig, params, window: int = 32,
                 kernel_impl: Optional[str] = None,
                 quantized: bool = False, moe_ep_fn=None):
        from ..models.transformer import ExecContext
        self.cfg = cfg
        self.params = params
        self.window = int(window)
        self.device = params["embed"]["tok"].device
        self._ctx = ExecContext(
            mode="train", quantized=quantized, exact_capacity=True,
            kernel_impl=kernel_impl, moe_ep_fn=moe_ep_fn,
            ep_mode="none" if moe_ep_fn is None else "a2a")
        self._hist: Dict[int, List[int]] = {}

    @classmethod
    def from_target(cls, target_cfg: ModelConfig, *, seed: int = 0,
                    window: int = 32, kernel_impl: Optional[str] = None,
                    device=None) -> "DraftModelDrafter":
        """Build a 1-layer dense stand-in sharing the target's vocab and
        width (random f32 weights from ``seed`` on ``device``)."""
        from ..models.transformer import init_params
        small = dataclasses.replace(
            target_cfg, name=target_cfg.name + "-draft", family="dense",
            num_layers=1, moe=None, first_layer_dense=False,
            block_pattern=("global",), tie_embeddings=True,
            quant=dataclasses.replace(target_cfg.quant, enabled=False))
        params = init_params(small, seed, torch.float32, device)
        return cls(small, params, window=window, kernel_impl=kernel_impl)

    @classmethod
    def self_draft(cls, cfg: ModelConfig, params, *, window: int = 64,
                   quantized: bool = False,
                   kernel_impl: Optional[str] = None, moe_ep_fn=None
                   ) -> "DraftModelDrafter":
        """Draft with the serving model itself (windowed re-read): the
        idealized high-acceptance drafter, so lookahead-prefetch numbers
        isolate the prefetcher from drafter quality."""
        return cls(cfg, params, window=window, kernel_impl=kernel_impl,
                   quantized=quantized, moe_ep_fn=moe_ep_fn)

    def reset_slot(self, slot: int, prompt_tokens: np.ndarray):
        self._hist[slot] = np.asarray(prompt_tokens).reshape(-1) \
            .astype(np.int32).tolist()

    def observe(self, slot: int, tokens: np.ndarray):
        self._hist.setdefault(slot, []).extend(
            int(t) for t in np.asarray(tokens).reshape(-1).tolist())

    @torch.no_grad()
    def propose_all(self, num_slots: int, k: int) -> np.ndarray:
        from ..models import model as lm
        w = self.window
        win = np.zeros((num_slots, w), np.int32)
        ln = np.zeros((num_slots,), np.int64)
        for s in range(num_slots):
            tail = self._hist.get(s, [])[-w:]
            win[s, :len(tail)] = tail
            ln[s] = len(tail)
        win_t = torch.as_tensor(win, device=self.device)
        ln_t = torch.as_tensor(ln, device=self.device)
        rows = torch.arange(num_slots, device=self.device)
        toks = []
        for _ in range(k):
            out = lm.forward(self.params, win_t, self.cfg, self._ctx)
            lg = out.logits[rows, (ln_t - 1).clamp(min=0)]
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            toks.append(nxt)
            full = ln_t >= w
            win_t = torch.where(full[:, None], torch.roll(win_t, -1, 1),
                                win_t)
            win_t[rows, ln_t.clamp(max=w - 1)] = nxt
            ln_t = (ln_t + 1).clamp(max=w)
        return torch.stack(toks, dim=1).cpu().numpy()


def make_drafter(spec: SpecConfig, target_cfg: ModelConfig, *,
                 target_params=None, target_quantized: bool = False,
                 kernel_impl: Optional[str] = None, device=None,
                 moe_ep_fn=None):
    """Resolve a SpecConfig drafter name into a drafter instance: 'ngram'
    needs nothing beyond the config; 'model' builds the small random-init
    dense stand-in on ``device``; 'self' re-reads the target itself and
    needs the target's params (and, when they are a mesh rank's, the
    engine's ``moe_ep_fn``)."""
    if spec.drafter == "ngram":
        return NGramDrafter(order=spec.ngram_order)
    if spec.drafter == "self":
        assert target_params is not None, \
            "'self' drafter needs the target model's params"
        return DraftModelDrafter.self_draft(
            target_cfg, target_params, window=spec.draft_window,
            quantized=target_quantized, kernel_impl=kernel_impl,
            moe_ep_fn=moe_ep_fn)
    return DraftModelDrafter.from_target(target_cfg,
                                         window=spec.draft_window,
                                         kernel_impl=kernel_impl,
                                         device=device)

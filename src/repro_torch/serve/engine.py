"""Batched serving engine: bucketed prefill + a decode loop with sampling
on the device (port of the ``generate`` path of ``repro/serve/engine.py``).

Prompts right-pad to a power-of-two length and the padded cache slots
are invalidated afterwards (``mask_cache_padding``), so padded decode
matches unpadded decode; cache lengths round up to powers of two.  Each
(batch, cache length) bucket keeps one resident cache set, reset in place
before every prefill into it.

The JAX package's decode loop is a ``lax.scan`` compiled once per bucket.
Its counterpart here, on a CUDA engine, is one decode step captured as a
CUDA graph per bucket (``DecodeGraph``) and replayed for every step of
every ``generate`` in that bucket; sampling runs eagerly between replays.
On the CPU the loop calls ``decode_step`` directly.  Tokens, log-probs and
router traces stay on the device until the loop ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import ModelConfig, ServeConfig
from ..models import model as lm
from ..models.transformer import (ExecContext, init_caches, layer_specs,
                                  mask_cache_padding, reset_caches)

PROMPT_BUCKET_MIN = 16     # smallest padded-prompt length
CACHE_BUCKET_MIN = 32      # smallest bucketed cache length


def bucket_len(n: int, minimum: int = CACHE_BUCKET_MIN) -> int:
    """Round ``n`` up to the next power of two (>= minimum)."""
    return max(minimum, 1 << max(int(n) - 1, 0).bit_length())


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray             # (B, max_new)
    logprobs: Optional[np.ndarray]
    prefill_s: float
    decode_s: float
    steps: int
    # (steps, moe_layers, B, k) decode-time router decisions (None when
    # the model has no MoE layer)
    router_trace: Optional[np.ndarray] = None
    # seconds of decode_s spent warming up and capturing the bucket's
    # decode graph (0 when an earlier call had captured it)
    capture_s: float = 0.0

    @property
    def decode_tokens_per_s(self) -> float:
        b = self.tokens.shape[0]
        return b * self.steps / self.decode_s if self.decode_s else 0.0


class Decoded(NamedTuple):
    tokens: torch.Tensor               # (B, max_new) i32
    logprobs: torch.Tensor             # (B, max_new) f32
    trace: Optional[torch.Tensor]      # (max_new, moe_layers, B, k) i32
    capture_s: float


@dataclasses.dataclass
class DecodeGraph:
    """One decode step of a bucket, captured.  A replay reads ``tokens``
    (B,) i32, ``plan`` ((moe_layers, 2) i32, when captured with one) and
    the bucket's resident ``caches``, advances the caches, and overwrites
    ``logits`` (B, V) and ``trace``: read them before the next replay."""
    graph: torch.cuda.CUDAGraph
    caches: Dict
    tokens: torch.Tensor
    plan: Optional[torch.Tensor]
    logits: torch.Tensor
    trace: Optional[torch.Tensor]


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           temperature: float) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig = None,
                 quantized: bool = False, collect_router_trace: bool = True,
                 kernel_impl: Optional[str] = None,
                 cache_dtype: Optional[torch.dtype] = None, device=None,
                 decode_graph: Optional[bool] = None):
        """``params`` must live on ``device`` (default: the CUDA device;
        raises if there is none).  ``kernel_impl``: 'auto' | 'cuda' |
        'ref' (see ``kernels.ops``).  ``decode_graph``: replay each
        bucket's decode step as a captured CUDA graph (None: on a CUDA
        engine; True on a CPU engine raises; False keeps the eager
        loop)."""
        self.device = resolve_device(device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(f"params are on {tok.device}, engine device "
                             f"is {self.device}")
        if decode_graph and self.device.type != "cuda":
            raise ValueError("decode_graph=True needs a CUDA engine; the "
                             f"engine device is {self.device}")
        self.decode_graph = (self.device.type == "cuda"
                             if decode_graph is None else bool(decode_graph))
        self.cfg = cfg
        self.scfg = scfg or ServeConfig()
        self.params = params
        self.quantized = quantized
        self.kernel_impl = kernel_impl
        self.cache_dtype = tok.dtype if cache_dtype is None else cache_dtype
        # a model without MoE layers routes nothing: no trace
        self.collect_router_trace = collect_router_trace and any(
            s.ffn == "moe" for s in layer_specs(cfg))
        self._prefill_ctx = ExecContext(mode="prefill", quantized=quantized,
                                        exact_capacity=True,
                                        kernel_impl=kernel_impl)
        self._step_ctx = ExecContext(mode="step", quantized=quantized,
                                     exact_capacity=True,
                                     kernel_impl=kernel_impl,
                                     collect_trace=self.collect_router_trace)
        # resident caches by (batch, cache length)
        self._caches: Dict[Tuple[int, int], Dict] = {}
        # captured decode steps by (batch, cache length, with a plan)
        self.graphs: Dict[Tuple[int, int, bool], DecodeGraph] = {}

    @property
    def num_graphs(self) -> int:
        """Decode-step captures so far, one per (batch, cache bucket) and
        plan/no plan: the counterpart of the JAX engine's
        ``num_compiles['decode']``."""
        return len(self.graphs)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_prompt(self, prompt_tokens: np.ndarray) -> np.ndarray:
        """Right-pad prompts to their length bucket (id 0)."""
        b, plen = prompt_tokens.shape
        lp = bucket_len(plen, PROMPT_BUCKET_MIN)
        if lp == plen:
            return prompt_tokens
        out = np.zeros((b, lp), np.int32)
        out[:, :plen] = prompt_tokens
        return out

    def _bucket_caches(self, b: int, cache_len: int) -> Dict:
        """The resident caches of a bucket, reset (allocated at first
        use)."""
        caches = self._caches.get((b, cache_len))
        if caches is None:
            caches = self._caches[(b, cache_len)] = init_caches(
                self.cfg, b, cache_len, self.cache_dtype, device=self.device)
            return caches
        return reset_caches(caches)

    @torch.no_grad()
    def prefill(self, prompt_tokens: np.ndarray, max_new: int):
        """Prefill a prompt batch into the resident caches of its bucket
        (reset first), sized for ``max_new`` more tokens.  Returns
        (last-real-token logits (B, V), caches)."""
        b, plen = prompt_tokens.shape
        padded = self._pad_prompt(np.asarray(prompt_tokens, np.int32))
        cache_len = bucket_len(padded.shape[1] + max_new + 1)
        caches = self._bucket_caches(b, cache_len)
        tokens = torch.as_tensor(padded, device=self.device)
        out = lm.forward(self.params, tokens, self.cfg, self._prefill_ctx,
                         caches=caches)
        plen_t = torch.full((b,), plen, dtype=torch.int32,
                            device=self.device)
        mask_cache_padding(self.cfg, caches, plen_t)
        return out.logits[:, plen - 1], caches

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, caches,
             plan: Optional[torch.Tensor] = None) -> lm.LMOutput:
        """One eager decode step for (B,) tokens; logits come back as
        (B, V).  ``plan``: optional (moe_layers, 2) i32 [top_n, rank_cap]
        rows on the engine's device."""
        out = lm.decode_step(self.params, tokens[:, None], caches, self.cfg,
                             self._step_ctx, plan=plan)
        return out._replace(logits=out.logits[:, 0])

    def _capture(self, key: Tuple[int, int, bool], tokens: torch.Tensor,
                 caches, plan: Optional[torch.Tensor]):
        """Run one eager decode step as the warm-up (it is the step's real
        result), then capture the same step on the same buffers as the
        bucket's graph.  The warm-up loads the kernel libraries, sets
        their launch attributes and caches flash-decode's cluster
        capacity and the RoPE frequencies; it runs on a side stream, as capture asks,
        and under ``set_sync_debug_mode('error')``, so a host sync in the
        step raises here.  A failed capture raises: nothing falls back
        to the eager loop.  Returns (logits, trace, graph), the graph
        kept under ``key``."""
        tokens = tokens.clone()
        plan = None if plan is None else plan.clone()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            torch.cuda.set_sync_debug_mode("error")
            with torch.cuda.stream(side):
                warm = self.step(tokens, caches, plan)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.step(tokens, caches, plan)
        g = self.graphs[key] = DecodeGraph(graph, caches, tokens, plan,
                                           out.logits, out.trace)
        return warm.logits, warm.trace, g

    @torch.no_grad()
    def decode(self, logits: torch.Tensor, caches, max_new: int,
               seed: int = 0, plan=None) -> Decoded:
        """``max_new`` steps from a prefill's (logits, caches): sample,
        then step the model, through the bucket's decode graph on a graph
        engine (captured at the bucket's first step).  ``plan``: optional
        (moe_layers, 2) [top_n, rank_cap] rows, copied into the graph's
        plan buffer, so a new plan never captures again."""
        b = logits.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        plan_t = None if plan is None else torch.as_tensor(
            np.asarray(plan, np.int32)).to(self.device)
        key = (b, caches["layers"][0]["k"].shape[1], plan is not None)
        g = self.graphs.get(key) if self.decode_graph else None
        if g is not None:
            if g.caches is not caches:
                raise ValueError("a decode graph replays its bucket's "
                                 "resident caches: pass the caches that "
                                 "prefill returned")
            if plan_t is not None:
                g.plan.copy_(plan_t)
        trace = None
        if self.collect_router_trace:
            n_moe = sum(s.ffn == "moe" for s in layer_specs(self.cfg))
            trace = torch.empty((max_new, n_moe, b, self.cfg.moe.top_k),
                                dtype=torch.int32, device=self.device)
        toks, lps = [], []
        capture_s = 0.0
        for i in range(max_new):
            nxt = sample(logits, gen, self.scfg.temperature)
            # before the step: a replay overwrites the graph's logits
            lp = torch.log_softmax(logits.float(), dim=-1)
            lps.append(lp.gather(1, nxt.long()[:, None])[:, 0])
            toks.append(nxt)
            if not self.decode_graph:
                out = self.step(nxt, caches, plan_t)
                logits, tr = out.logits, out.trace
            elif g is None:
                t0 = time.perf_counter()
                logits, tr, g = self._capture(key, nxt, caches, plan_t)
                capture_s = time.perf_counter() - t0
            else:
                g.tokens.copy_(nxt)
                g.graph.replay()
                logits, tr = g.logits, g.trace
            if trace is not None:
                trace[i].copy_(tr)
        return Decoded(torch.stack(toks, dim=1), torch.stack(lps, dim=1),
                       trace, capture_s)

    @torch.no_grad()
    def generate(self, prompt_tokens: np.ndarray, max_new: int = 32,
                 seed: int = 0, plan=None) -> GenerationResult:
        """Prefill, then ``max_new`` decode steps (``decode``)."""
        t0 = time.perf_counter()
        logits, caches = self.prefill(prompt_tokens, max_new)
        self._sync()
        t_prefill = time.perf_counter() - t0
        t1 = time.perf_counter()
        d = self.decode(logits, caches, max_new, seed, plan)
        self._sync()
        t_decode = time.perf_counter() - t1
        return GenerationResult(
            d.tokens.cpu().numpy(), d.logprobs.cpu().numpy(), t_prefill,
            t_decode, max_new,
            router_trace=None if d.trace is None else d.trace.cpu().numpy(),
            capture_s=d.capture_s)

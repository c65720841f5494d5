"""Batched serving engine: bucketed prefill, a decode loop with sampling
on the device, and continuous-batching request serving (port of the
contiguous-cache paths of ``repro/serve/engine.py``).

Prompts right-pad to a power-of-two length and the padded cache slots
are invalidated afterwards (``mask_cache_padding``), so padded decode
matches unpadded decode; cache lengths round up to powers of two.  Each
(batch, cache length) bucket keeps one resident cache set, reset in place
before every prefill into it.

The JAX package's decode loop is a ``lax.scan`` compiled once per bucket.
Its counterpart here, on a CUDA engine, is one decode step captured as a
CUDA graph per bucket (``DecodeGraph``) and replayed for every step of
every ``generate`` and every ``serve`` chunk in that bucket; sampling runs
eagerly between replays.  On the CPU the loop calls ``decode_step``
directly.  Tokens, log-probs and router traces stay on the device until
the loop (or chunk) ends.

``serve`` keeps one slot-indexed cache of ``num_slots`` rows (the
bucket's resident caches) for a whole workload: between chunks the
``serve/scheduler.py`` scheduler retires finished requests and refills
their slots, each admission prefilled at batch 1 and claimed into its
slot row in place.  With expert stores attached (``attach_offload``)
every accepted token's routing is replayed into the per-layer metered
``ExpertStore``s between chunks, and an attached ``BandwidthController``
turns each chunk's wire bytes into the next chunk's (top_n, rank_cap)
plan, copied into the decode graph's plan buffer.

With async expert streaming attached (``attach_streaming``) the metered
bytes are real copies: the MoE layers serve from device containers
booted from a low-bit fallback, every byte the meter charges is copied
from a pinned host image into them (``offload/staging.py``), and a chunk
that routed to an expert not yet staged is either staged and re-run from
a snapshot of the caches until it matches the all-resident path
(``miss_policy='block'``) or served by the fallback ('degrade').  The
containers are written in place, so the decode graphs captured after
``attach_streaming`` keep reading them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import ControlConfig, ModelConfig, ServeConfig
from ..models import model as lm
from ..models.transformer import (ExecContext, cache_claim_slot,
                                  init_caches, layer_specs,
                                  mask_cache_padding, reset_caches)
from .controller import BandwidthController, ControllerPlan
from .scheduler import Request, RequestResult, Scheduler

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
    # live offload metering (attach_offload): bytes/token, hit rate, ...
    offload_report: Optional[Dict] = None
    # async streaming engine counters (attach_streaming): overlap
    # efficiency, stalls, degraded tokens, observed copies, ...
    stream_report: Optional[Dict] = None

    @property
    def decode_tokens_per_s(self) -> float:
        b = self.tokens.shape[0]
        return b * self.steps / self.decode_s if self.decode_s else 0.0

    def request_trace(self, b: int = 0) -> Optional[np.ndarray]:
        """(steps, layers, k) routing of one request stream."""
        if self.router_trace is None:
            return None
        return self.router_trace[:, :, b, :]


class Decoded(NamedTuple):
    tokens: torch.Tensor               # (B, max_new) i32
    logprobs: torch.Tensor             # (B, max_new) f32
    trace: Optional[torch.Tensor]      # (max_new, moe_layers, B, k) i32
    capture_s: float
    # (B, V) logits after the last step, the ones a next chunk samples
    # from (on a graph engine the graph's own output buffer)
    logits: torch.Tensor


@dataclasses.dataclass
class ServeStats:
    """Outcome of one continuous-batching ``serve`` run."""
    results: List[RequestResult]       # submission order
    num_slots: int
    chunk: int
    total_s: float
    prefill_s: float
    decode_s: float
    chunks: int
    generated_tokens: int              # accepted tokens across requests
    offload_report: Optional[Dict] = None
    # (total_steps, moe_layers, num_slots, k) with -1 on inactive slots
    router_trace: Optional[np.ndarray] = None
    # (chunks, moe_layers, 2) per-chunk controller plan [top_n, rank_cap]
    # (None when no bandwidth controller is attached)
    plan_trace: Optional[np.ndarray] = None
    # device bytes held by the serve run's slot caches (every plane)
    cache_hbm_bytes: int = 0
    # padded prompt tokens pushed through prefill
    prefill_tokens: int = 0
    # host seconds spent replaying chunk traces into the expert stores
    # and updating the controller (between chunks, the card idle)
    meter_s: float = 0.0
    # seconds of decode_s spent warming up and capturing the slot
    # bucket's decode graph (0 when an earlier call had captured it)
    capture_s: float = 0.0
    # async streaming counters (attach_streaming): overlap efficiency,
    # transfer/stall seconds, degraded tokens, observed copies, ...
    stream_report: Optional[Dict] = None

    def __post_init__(self):
        # zero-token requests carry first_token_s = NaN (an explicit
        # sentinel, excluded from percentiles); any *negative* finite
        # latency is a scheduler timing bug and must never leak out
        for r in self.results:
            if r.latency_s < 0:
                raise AssertionError(
                    f"negative latency {r.latency_s} for uid {r.uid}")
            if np.isfinite(r.first_token_s) and r.ttft_s < 0:
                raise AssertionError(
                    f"negative ttft {r.ttft_s} for uid {r.uid}")

    @property
    def cache_hbm_bytes_per_token(self) -> float:
        return (self.cache_hbm_bytes / self.generated_tokens
                if self.generated_tokens else 0.0)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.total_s if self.total_s else 0.0

    @property
    def busy_s(self) -> float:
        """Engine busy time: prefill + decode, excluding the idle gaps
        where the scheduler waited on request arrivals."""
        return self.prefill_s + self.decode_s

    @property
    def goodput_tokens_per_s(self) -> float:
        """Accepted tokens per busy second (comparable across offered
        loads, unlike the wall-clock ``tokens_per_s``)."""
        return (self.generated_tokens / self.busy_s) if self.busy_s else 0.0

    @property
    def busy_frac(self) -> float:
        return self.busy_s / self.total_s if self.total_s else 0.0

    def latency_percentiles(self, qs: Sequence[float] = (50.0, 95.0)
                            ) -> Dict[float, float]:
        lat = [r.latency_s for r in self.results]
        return {q: float(np.percentile(lat, q)) for q in qs} if lat else {}

    def ttft_percentiles(self, qs: Sequence[float] = (50.0, 95.0)
                         ) -> Dict[float, float]:
        """First-token latency percentiles over requests that emitted at
        least one token (NaN-sentinel zero-budget requests excluded)."""
        tt = [r.ttft_s for r in self.results if np.isfinite(r.ttft_s)]
        return {q: float(np.percentile(tt, q)) for q in qs} if tt else {}


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
        # prefill with the router trace: streaming stages what it routed to
        self._prefill_traced_ctx = ExecContext(
            mode="prefill", quantized=quantized, exact_capacity=True,
            kernel_impl=kernel_impl, collect_trace=True)
        # resident caches by (batch, cache length)
        self._caches: Dict[Tuple[int, int], Dict] = {}
        # captured decode steps by (batch, cache length, with a plan)
        self.graphs: Dict[Tuple[int, int, bool], DecodeGraph] = {}
        self._stores = None            # per-MoE-layer ExpertStore
        self._prefetcher = None
        self._offload_policy = "ours"
        self._controller = None        # BandwidthController
        self._stream = None            # ExpertStreamEngine (attach_streaming)

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
        plen = prompt_tokens.shape[1]
        padded = self._pad_prompt(np.asarray(prompt_tokens, np.int32))
        return self._prefill_into(padded, plen,
                                  bucket_len(padded.shape[1] + max_new + 1))

    def _prefill_request(self, req: Request, cache_len: int):
        """(last-token logits (1, V), batch-1 prefilled cache) for one
        request, in the resident (1, ``cache_len``) bucket of the serve
        run."""
        toks = self._pad_prompt(np.asarray(req.tokens,
                                           np.int32).reshape(1, -1))
        if self._stream is not None:
            return self._prefill_streamed(toks, req.prompt_len, cache_len)
        return self._prefill_into(toks, req.prompt_len, cache_len)

    def _prefill_into(self, padded: np.ndarray, plen: int, cache_len: int,
                      traced: bool = False):
        """Prefill into the reset (B, ``cache_len``) bucket.  Returns
        (last-real-token logits, caches), and the (moe_layers, B * T, k)
        router trace when ``traced``."""
        b = padded.shape[0]
        caches = self._bucket_caches(b, cache_len)
        tokens = torch.as_tensor(padded, device=self.device)
        out = lm.forward(self.params, tokens, self.cfg,
                         self._prefill_traced_ctx if traced
                         else self._prefill_ctx, caches=caches)
        plen_t = torch.full((b,), plen, dtype=torch.int32,
                            device=self.device)
        mask_cache_padding(self.cfg, caches, plen_t)
        if traced:
            return out.logits[:, plen - 1], caches, out.trace
        return out.logits[:, plen - 1], caches

    def _prefill_streamed(self, padded: np.ndarray, plen: int,
                          cache_len: int):
        """Prefill under streaming: run optimistically on the current
        containers, stage every expert the prompt's routing touched
        (padded positions included) that is not yet resident (at the
        static top_n, full rank), and re-run until the routing is fully
        served by true weights — so a streamed request's FIRST sampled
        token already matches the all-resident path.  Prefill always
        blocks on its stages; a stalled copy degrades the prefill after
        ``stall_timeout_s`` like any other miss."""
        eng = self._stream
        top_n = (self.cfg.moe.quant.top_n_restore
                 if self.cfg.moe is not None else 0)
        lg = caches = None
        for _ in range(eng.cfg.max_reruns + 1):
            lg, caches, tr = self._prefill_into(padded, plen, cache_len,
                                                traced=True)
            needs = eng.missing_for_forward_trace(tr.cpu().numpy(), top_n)
            if not needs:
                return lg, caches
            unresolved = eng.demand_stage(needs)
            eng.reruns += 1
            if unresolved:
                break          # stalled copies: serve this prefill degraded
        return lg, caches

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
               seed: int = 0, plan=None,
               generator: Optional[torch.Generator] = None) -> Decoded:
        """``max_new`` steps from a prefill's (logits, caches): sample,
        then step the model, through the bucket's decode graph on a graph
        engine (captured at the bucket's first step).  ``plan``: optional
        (moe_layers, 2) [top_n, rank_cap] rows, copied into the graph's
        plan buffer, so a new plan never captures again.  ``generator``:
        the sampling generator to draw from (``serve`` threads one across
        its chunks); by default a new one seeded with ``seed``."""
        b = logits.shape[0]
        gen = generator or torch.Generator(device=self.device) \
            .manual_seed(seed)
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
            trace = torch.empty((max_new, self._n_moe, b, self.cfg.moe.top_k),
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
                       trace, capture_s, logits)

    @property
    def _n_moe(self) -> int:
        return sum(s.ffn == "moe" for s in layer_specs(self.cfg))

    @torch.no_grad()
    def generate(self, prompt_tokens: np.ndarray, max_new: int = 32,
                 seed: int = 0, plan=None) -> GenerationResult:
        """Prefill, then ``max_new`` decode steps (``decode``).  ``plan``
        defaults to the attached controller's current plan; with expert
        stores attached the decode trace is metered under that plan into
        ``offload_report``, whose bytes feed the controller."""
        b, plen = prompt_tokens.shape
        t0 = time.perf_counter()
        if self._stream is not None:
            padded = self._pad_prompt(np.asarray(prompt_tokens, np.int32))
            logits, caches = self._prefill_streamed(
                padded, plen, bucket_len(padded.shape[1] + max_new + 1))
        else:
            logits, caches = self.prefill(prompt_tokens, max_new)
        self._sync()
        t_prefill = time.perf_counter() - t0
        if plan is None and self._controller is not None:
            plan = self._current_plan().as_array()
        t1 = time.perf_counter()
        if self._stream is not None:
            d, _deg = self._run_chunk(logits, caches, max_new, plan,
                                      np.ones((b,), bool), seed=seed)
        else:
            d = self.decode(logits, caches, max_new, seed, plan)
        self._sync()
        t_decode = time.perf_counter() - t1
        trace = None if d.trace is None else d.trace.cpu().numpy()
        report = None
        if trace is not None and self._stores:
            report = self._meter_offload(trace, plan)
            if self._controller is not None:
                self._controller.update(report["total_bytes"],
                                        report["tokens"])
        return GenerationResult(
            d.tokens.cpu().numpy(), d.logprobs.cpu().numpy(), t_prefill,
            t_decode, max_new, router_trace=trace, capture_s=d.capture_s,
            offload_report=report,
            stream_report=(self._stream.report()
                           if self._stream is not None else None))

    # -- offload wiring ----------------------------------------------------
    def attach_offload(self, stacks_by_layer: List[Dict],
                       policy: str = "ours",
                       cache_capacity: Optional[int] = None,
                       prefetch: bool = True):
        """Meter every generated token's expert fetches through per-layer
        host-side ``ExpertStore``s (LRU device cache + compensator bytes).

        As in the JAX engine, the stores start afresh and so does the
        prefetcher when ``prefetch``; an attached controller stays (its
        level and history carry on over the new stores) unless
        ``scfg.control.enabled`` attaches a new one.  (The stores'
        expert-parallel split of the JAX engine's serving mesh is not
        ported.)"""
        from ..offload.prefetch import LayerAheadPrefetcher
        from ..offload.store import make_expert_stores
        cap = (self.scfg.cache_experts if cache_capacity is None
               else cache_capacity)
        self._stores = make_expert_stores(stacks_by_layer,
                                          cache_capacity=cap)
        self._offload_policy = policy
        if prefetch:
            self._prefetcher = LayerAheadPrefetcher(len(stacks_by_layer),
                                                    self.cfg.moe.top_k)
        if self.scfg.control.enabled:
            self.attach_controller(self.scfg.control)
        if self.scfg.stream.enabled:
            self.attach_streaming()
        return self

    def attach_streaming(self, stream=None, backend=None) -> "ServeEngine":
        """Turn the metered offload into a real streamed data path.

        The MoE layers' serving stacks are replaced (once) by
        fallback-initialized device *containers* of the same shapes; an
        ``ExpertStreamEngine`` copies true expert payloads into them in
        place from pinned host images, driven by the stores' metering
        events, with a per-layer ring of async H2D copies on a copy
        stream for the prefetcher's layer-ahead predictions.  Decode runs
        optimistically on the current containers and blocks only on a
        true miss (``StreamConfig.miss_policy='block'``: stage + re-run
        until the routing is fully served, token-identical to
        all-resident; ``'degrade'``: accept the chunk served by the
        resident low-bit fallback and stage in the background).

        Every decode graph captured before this call replays the true
        stacks, so they are dropped; the graphs captured after it read
        the containers, and integrations and plan changes never capture
        again.

        ``stream``: ``StreamConfig`` override (default ``scfg.stream``);
        ``backend``: transfer backend override (fault injection).
        Requires ``attach_offload`` on the LIVE serving stacks and an
        'ours'/'quant' fetch policy."""
        from ..offload.staging import ExpertStreamEngine
        stream = stream or self.scfg.stream
        if self._stores is None:
            raise ValueError("attach_offload must be called before "
                             "attach_streaming (the stream engine is "
                             "driven by its metered stores)")
        if not self.collect_router_trace:
            raise ValueError("streaming detects misses from the router "
                             "trace; collect_router_trace must be on")
        if self._offload_policy not in ("ours", "quant"):
            raise ValueError("streaming moves compressed containers; fetch "
                             f"policy {self._offload_policy!r} unsupported")
        moe_params = [lp["moe"] for lp in self.params["layers"]
                      if isinstance(lp.get("moe"), dict)
                      and "stacks" in lp["moe"]]
        if len(moe_params) != len(self._stores):
            raise ValueError(f"{len(moe_params)} compressed MoE layers in "
                             f"params vs {len(self._stores)} stores")
        for mp, store in zip(moe_params, self._stores):
            if mp["stacks"] is not store.stacks:
                raise ValueError("attach_offload was given stacks that are "
                                 "not the live serving stacks; streaming "
                                 "must stage into the containers the "
                                 "decode graph reads")
        self._stream = ExpertStreamEngine(self._stores, stream,
                                          policy=self._offload_policy,
                                          backend=backend)
        for li, mp in enumerate(moe_params):
            mp["stacks"] = self._stream.layer_containers(li)
        self.graphs.clear()
        return self

    @property
    def stream(self):
        return self._stream

    def attach_controller(self, control: ControlConfig) -> "ServeEngine":
        """Close the loop from offload metering to restoration intensity.

        Requires ``attach_offload`` (the controller reads the stores' byte
        counters and derives its rank ladder from their stacks).  With no
        budget set (``target_bytes_per_token == 0``) the plan stays pinned
        at the static ``top_n_restore`` / full-rank point, and decode and
        metering are bit-identical to the uncontrolled path."""
        if self._stores is None:
            raise ValueError("attach_offload must be called before "
                             "attach_controller (it provides the metered "
                             "stores the controller feeds on)")
        self._controller = BandwidthController.from_stacks(
            [s.stacks for s in self._stores], self.cfg.moe.top_k, control,
            static_top_n=self.cfg.moe.quant.top_n_restore)
        return self

    @property
    def controller(self) -> Optional[BandwidthController]:
        return self._controller

    def _current_plan(self) -> Optional[ControllerPlan]:
        return self._controller.plan() if self._controller else None

    def _meter_offload(self, trace: np.ndarray, plan=None) -> Dict:
        """Feed decode routing (steps, layers, B, k) into the stores under
        ``plan``'s (moe_layers, 2) [top_n, rank_cap] rows (None: the
        static top_n, full rank).  Under streaming, staged copies the
        routing never touched are flushed as wasted prefetch inside the
        report's window, so the report covers every byte put on the
        link."""
        from ..offload.store import (offload_report, replay_decode_trace,
                                     snapshot_offload)
        arr = None if plan is None else np.asarray(plan, np.int32)
        snap = snapshot_offload(self._stores, self._prefetcher)
        ntok, _ = replay_decode_trace(
            self._stores, trace, policy=self._offload_policy,
            top_n=(self.cfg.moe.quant.top_n_restore if arr is None
                   else arr[:, 0]),
            rank_caps=None if arr is None else arr[:, 1],
            prefetcher=self._prefetcher)
        if self._stream is not None:
            self._stream.flush_unclaimed()
        return offload_report(self._stores, self._prefetcher, snap, ntok,
                              self._offload_policy)

    # -- streamed decode -----------------------------------------------------
    def _run_chunk(self, logits: torch.Tensor, caches, steps: int, plan,
                   active: np.ndarray, seed: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Decoded, int]:
        """One decode chunk (``decode``) under streaming.

        Warm steady state (``may_miss`` False) decodes untouched.
        Otherwise the chunk runs optimistically on the current
        containers from a snapshot of everything the decode writes in
        place (the caches, the logits it samples from, the generator);
        on a true miss it either stages and re-runs from the snapshot to
        a fixpoint (miss_policy 'block': the accepted chunk is
        token-identical to all-resident) or accepts the fallback-served
        chunk and stages asynchronously for later chunks ('degrade').
        Returns (the ``Decoded`` chunk, its degraded token count)."""
        eng = self._stream
        eng.integrate_ready()
        top_ns, caps = eng.plan_vectors(
            len(self._stores), plan,
            self.cfg.moe.quant.top_n_restore if self.cfg.moe else 0)
        if not eng.may_miss(top_ns, caps):
            return self.decode(logits, caches, steps, seed, plan,
                               generator), 0
        tensors = [t for c in caches["layers"] for t in c.values()] \
            + [caches["pos"], logits]
        snap = [t.clone() for t in tensors]
        gen_state = None if generator is None else generator.get_state()
        out = needs = None
        for attempt in range(eng.cfg.max_reruns + 1):
            if attempt:
                for t, s in zip(tensors, snap):
                    t.copy_(s)
                if generator is not None:
                    generator.set_state(gen_state)
            out = self.decode(logits, caches, steps, seed, plan, generator)
            tr = out.trace.cpu().numpy()
            needs = eng.missing_for_trace(tr, active, top_ns, caps)
            if not needs:
                return out, 0
            if eng.cfg.miss_policy == "degrade":
                eng.stage_async(needs)
                break
            unresolved = eng.demand_stage(needs)
            eng.reruns += 1
            if unresolved:
                bad = set(unresolved)
                needs = [n for n in needs if (n[0], n[1]) in bad]
                break
        degraded = eng.count_affected_tokens(
            out.trace.cpu().numpy(), active,
            [(l, e) for (l, e, _w, _f) in needs])
        eng.degraded_tokens += degraded
        return out, degraded

    def _claim(self, caches, req_caches, logits: torch.Tensor,
               req_logits: torch.Tensor, slot: int) -> None:
        """Write one request's prefilled batch-1 cache and last-token
        logits into row ``slot`` of the slot caches and of the logits the
        next chunk samples from, in place (the counterpart of the JAX
        engine's donated ``claim``).  With one slot the request was
        prefilled into the slot caches themselves."""
        if req_caches is not caches:
            cache_claim_slot(self.cfg, caches, req_caches, slot)
        logits[slot].copy_(req_logits[0])

    # -- continuous-batching serving ---------------------------------------
    @torch.no_grad()
    def serve(self, requests: Iterable[Request], *,
              num_slots: Optional[int] = None, chunk: Optional[int] = None,
              seed: int = 0, page_size: Optional[int] = None,
              prefix_cache: Optional[bool] = None,
              spec_k: Optional[int] = None, drafter=None) -> ServeStats:
        """Serve a request workload through the continuous-batching loop.

        One slot-indexed cache of ``num_slots`` rows (the resident caches
        of the (num_slots, cache length) bucket) and that bucket's decode
        graph stay resident for the whole workload; each chunk decodes
        ``chunk`` steps, and between chunks the scheduler retires finished
        requests (EOS / max-token) and refills their slots from the
        arrival queue.  Requests with future ``arrival_s`` wait in the
        queue; latencies are wall-clock from arrival.

        With a bandwidth controller attached, each chunk decodes under
        the controller's current (moe_layers, 2) plan (copied into the
        graph's plan buffer: no new capture), the chunk's metered wire
        bytes feed ``controller.update`` at the chunk boundary, and the
        per-chunk plans come back as ``ServeStats.plan_trace``.

        The paged cache (``page_size``, ``prefix_cache``) and speculative
        rounds (``spec_k``, ``drafter``) are not ported: asking for either
        raises."""
        from ..offload.store import (offload_report, replay_decode_trace,
                                     snapshot_offload)
        if page_size or prefix_cache:
            raise NotImplementedError(
                "the paged KV cache and prefix reuse are not ported yet "
                "(ROADMAP A9): serve() runs the contiguous cache only")
        if spec_k or drafter is not None:
            raise NotImplementedError(
                "speculative rounds are not ported yet (ROADMAP A11)")
        cfg = self.cfg
        num_slots = num_slots or self.scfg.num_slots
        chunk = chunk or self.scfg.chunk_steps
        reqs = list(requests)
        order = [r.uid for r in reqs]       # results in submission order
        reqs = sorted(reqs, key=lambda r: r.arrival_s)
        if not reqs:
            return ServeStats([], num_slots, chunk, 0.0, 0.0, 0.0, 0, 0)

        def padded_plen(r: Request) -> int:
            return bucket_len(r.prompt_len, PROMPT_BUCKET_MIN)

        cache_len = bucket_len(max(padded_plen(r) + r.max_new
                                   for r in reqs) + 1)
        caches = self._bucket_caches(num_slots, cache_len)
        cache_hbm = sum(t.numel() * t.element_size()
                        for c in caches["layers"] for t in c.values()) \
            + caches["pos"].numel() * caches["pos"].element_size()
        sched = Scheduler(num_slots)
        for r in reqs:
            sched.submit(r)

        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits = None
        top_n = cfg.moe.quant.top_n_restore if cfg.moe is not None else 1
        snap = (snapshot_offload(self._stores, self._prefetcher)
                if self._stores else None)
        traces: List[np.ndarray] = []
        plans: List[np.ndarray] = []
        prefill_s = decode_s = meter_s = capture_s = 0.0
        chunks = generated = metered_tokens = prefill_tok = 0
        t0 = time.perf_counter()
        while sched.has_work():
            now = time.perf_counter() - t0
            admits = sched.admit(now)
            if not admits and sched.num_active == 0:
                # idle: nothing resident, next request hasn't arrived yet
                gap = max(sched.next_arrival() - now, 0.0)
                time.sleep(gap + 1e-4)
                continue
            for slot, req in admits:
                tp = time.perf_counter()
                lg, rc = self._prefill_request(req, cache_len)
                prefill_tok += padded_plen(req)
                if logits is None:
                    logits = torch.zeros((num_slots,) + lg.shape[1:],
                                         dtype=lg.dtype, device=self.device)
                self._claim(caches, rc, logits, lg, slot)
                self._sync()
                prefill_s += time.perf_counter() - tp

            plan = self._current_plan()
            plan_arr = None if plan is None else plan.as_array()
            td = time.perf_counter()
            if self._stream is not None:
                d, _deg = self._run_chunk(logits, caches, chunk, plan_arr,
                                          sched.active_mask(), generator=gen)
            else:
                d = self.decode(logits, caches, chunk, plan=plan_arr,
                                generator=gen)
            logits = d.logits
            capture_s += d.capture_s
            toks = d.tokens.cpu().numpy()                # (S, chunk)
            lps = d.logprobs.cpu().numpy()
            tr = None if d.trace is None else d.trace.cpu().numpy()
            decode_s += time.perf_counter() - td
            chunks += 1
            if plan is not None:
                plans.append(plan.as_array())
            uid_map = sched.uid_by_slot()
            now = time.perf_counter() - t0
            # per-step times interpolate from the chunk's decode start, so
            # first-token stamps land on their step instead of quantizing
            # to the chunk boundary
            accepted = sched.record_chunk(toks, lps, tr, now,
                                          t_start=td - t0)  # (chunk, S)
            generated += int(accepted.sum())
            if tr is None:
                continue
            masked = np.where(accepted[:, None, :, None], tr,
                              -1).astype(tr.dtype)
            traces.append(masked)
            if self._stores:
                tm = time.perf_counter()
                before = sum(s.total_bytes for s in self._stores)
                ntok, slot_bytes = replay_decode_trace(
                    self._stores, masked, policy=self._offload_policy,
                    top_n=top_n if plan is None else plan.top_n,
                    rank_caps=None if plan is None else plan.rank_cap,
                    prefetcher=self._prefetcher)
                metered_tokens += ntok
                sched.add_slot_bytes(slot_bytes, uid_map)
                if self._stream is not None:
                    # staged copies the accepted routing never touched
                    # become wasted prefetch THIS chunk, so the
                    # controller's `moved` sees every byte the chunk put
                    # on the link
                    self._stream.flush_unclaimed()
                if self._controller is not None:
                    # chunk boundary: the chunk's wire bytes (demand +
                    # compensator + prefetch) close the control loop
                    moved = sum(s.total_bytes for s in self._stores) - before
                    self._controller.update(moved, ntok)
                meter_s += time.perf_counter() - tm

        total_s = time.perf_counter() - t0
        report = (offload_report(self._stores, self._prefetcher, snap,
                                 metered_tokens, self._offload_policy)
                  if snap is not None and traces else None)
        by_uid = {res.uid: res for res in sched.finished}
        return ServeStats(
            [by_uid[u] for u in order], num_slots, chunk, total_s,
            prefill_s, decode_s, chunks, generated,
            offload_report=report,
            router_trace=np.concatenate(traces) if traces else None,
            plan_trace=np.stack(plans) if plans else None,
            cache_hbm_bytes=cache_hbm, prefill_tokens=prefill_tok,
            meter_s=meter_s, capture_s=capture_s,
            stream_report=(self._stream.report()
                           if self._stream is not None else None))

    def generate_many(self, prompts: Sequence[np.ndarray],
                      max_new: int = 32, *,
                      eos_id: Optional[int] = None,
                      num_slots: Optional[int] = None,
                      chunk: Optional[int] = None,
                      seed: int = 0) -> ServeStats:
        """Serve a list of ragged prompts (all arriving at t=0) through the
        continuous-batching loop; results come back in submission order."""
        reqs = [Request(uid=i, tokens=np.asarray(p, np.int32).reshape(-1),
                        max_new=max_new, eos_id=eos_id)
                for i, p in enumerate(prompts)]
        return self.serve(reqs, num_slots=num_slots, chunk=chunk, seed=seed)

    @torch.no_grad()
    def score(self, tokens: np.ndarray) -> float:
        """Mean next-token NLL (perplexity proxy) under the serving path:
        one train-mode forward over (B, S) tokens."""
        ctx = ExecContext(mode="train", quantized=self.quantized,
                          exact_capacity=True, kernel_impl=self.kernel_impl)
        toks = torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)
        out = lm.forward(self.params, toks, self.cfg, ctx)
        logits = out.logits[:, :-1].float()
        sel = logits.gather(-1, toks[:, 1:].long()[..., None])[..., 0]
        return float(torch.mean(torch.logsumexp(logits, dim=-1) - sel))

"""Batched serving engine: bucketed prefill + a decode loop with sampling
on the device (port of the ``generate`` path of ``repro/serve/engine.py``).

Prompts right-pad to a power-of-two length and the padded cache slots
are invalidated afterwards (``mask_cache_padding``), so padded decode
matches unpadded decode; cache lengths round up to powers of two.  The
JAX package's ``lax.scan`` decode loop is a Python loop over
``decode_step`` here; tokens, log-probs and router traces stay on the
device until the loop ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import ModelConfig, ServeConfig
from ..models import model as lm
from ..models.transformer import (ExecContext, init_caches, layer_specs,
                                  mask_cache_padding)

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

    @property
    def decode_tokens_per_s(self) -> float:
        b = self.tokens.shape[0]
        return b * self.steps / self.decode_s if self.decode_s else 0.0


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
                 cache_dtype: Optional[torch.dtype] = None, device=None):
        """``params`` must live on ``device`` (default: the CUDA device;
        raises if there is none).  ``kernel_impl``: 'auto' | 'cuda' |
        'ref' (see ``kernels.ops``)."""
        self.device = resolve_device(device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(f"params are on {tok.device}, engine device "
                             f"is {self.device}")
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

    @torch.no_grad()
    def prefill(self, prompt_tokens: np.ndarray, max_new: int):
        """Prefill a prompt batch into fresh caches sized for ``max_new``
        more tokens.  Returns (last-real-token logits (B, V), caches)."""
        b, plen = prompt_tokens.shape
        padded = self._pad_prompt(np.asarray(prompt_tokens, np.int32))
        cache_len = bucket_len(padded.shape[1] + max_new + 1)
        caches = init_caches(self.cfg, b, cache_len, self.cache_dtype,
                             device=self.device)
        tokens = torch.as_tensor(padded, device=self.device)
        out = lm.forward(self.params, tokens, self.cfg, self._prefill_ctx,
                         caches=caches)
        plen_t = torch.full((b,), plen, dtype=torch.int32,
                            device=self.device)
        caches = mask_cache_padding(self.cfg, out.caches, plen_t)
        return out.logits[:, plen - 1], caches

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, caches) -> lm.LMOutput:
        """One decode step for (B,) tokens; logits come back as (B, V)."""
        out = lm.decode_step(self.params, tokens[:, None], caches, self.cfg,
                             self._step_ctx)
        return out._replace(logits=out.logits[:, 0])

    @torch.no_grad()
    def generate(self, prompt_tokens: np.ndarray, max_new: int = 32,
                 seed: int = 0) -> GenerationResult:
        t0 = time.perf_counter()
        logits, caches = self.prefill(prompt_tokens, max_new)
        self._sync()
        t_prefill = time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks, lps, traces = [], [], []
        t1 = time.perf_counter()
        for _ in range(max_new):
            nxt = sample(logits, gen, self.scfg.temperature)
            out = self.step(nxt, caches)
            lp = torch.log_softmax(logits.float(), dim=-1)
            lps.append(lp.gather(1, nxt.long()[:, None])[:, 0])
            toks.append(nxt)
            if self.collect_router_trace:
                traces.append(out.trace)          # (moe_layers, B, k)
            logits, caches = out.logits, out.caches
        self._sync()
        t_decode = time.perf_counter() - t1
        trace = (torch.stack(traces).cpu().numpy() if traces else None)
        return GenerationResult(
            torch.stack(toks, dim=1).cpu().numpy(),
            torch.stack(lps, dim=1).cpu().numpy(), t_prefill, t_decode,
            max_new, router_trace=trace)

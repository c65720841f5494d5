"""Top-level language model: embed -> layer stack -> head, with the
prefill ``forward`` and the one-token ``decode_step`` (port of
``repro/models/model.py``)."""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from ..config import ModelConfig
from .layers import in_dtype, rms_norm, softcap
from .transformer import ExecContext, apply_stack


class LMOutput(NamedTuple):
    logits: torch.Tensor
    aux: Dict[str, torch.Tensor]
    caches: Optional[Dict]
    # (moe_layers, T, k) router top-k ids when ctx.collect_trace
    trace: Optional[torch.Tensor] = None
    # (moe_layers, T, E) router probabilities when ctx.collect_trace
    router_probs: Optional[torch.Tensor] = None
    # (moe_layers, T, d) normed MoE-FFN inputs when ctx.collect_moe_inputs
    moe_inputs: Optional[torch.Tensor] = None


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    x = params["embed"]["tok"][tokens.long()]
    if cfg.scale_embed:
        # JAX multiplies by the weak-typed sqrt(d): rounded to x's dtype
        # first (in bf16 sqrt(1152) is 34.0, not 33.94)
        x = x * in_dtype(math.sqrt(cfg.d_model), x.dtype)
    return x


def lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["tok"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["head"]["w"])
    return softcap(logits, cfg.logit_softcap)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ExecContext, *, positions=None, caches=None,
            plan=None) -> LMOutput:
    """Full-sequence forward (prefill when ``ctx.mode == 'prefill'``)."""
    b, s = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens, cfg)
    x, aux, new_caches, trace, probs, moe_ins = apply_stack(
        params, x, cfg, ctx, positions, caches=caches, plan=plan)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return LMOutput(lm_head(params, x, cfg), aux, new_caches, trace, probs,
                    moe_ins)


def decode_step(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
                ctx: ExecContext, *, plan=None) -> LMOutput:
    """One-token serve step against the KV caches; tokens: (B, 1).  The
    caches are written in place and their ``pos`` (B,) advances by one,
    so the step reads and writes only fixed buffers (what a captured CUDA
    graph replays); ``LMOutput.caches`` is the same dict."""
    positions = caches["pos"][:, None]        # (B, 1) absolute position
    x = embed_tokens(params, tokens, cfg)
    x, aux, new_caches, trace, probs, moe_ins = apply_stack(
        params, x, cfg, ctx, positions, caches=caches, plan=plan)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return LMOutput(lm_head(params, x, cfg), aux, new_caches, trace, probs,
                    moe_ins)

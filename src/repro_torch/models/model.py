"""Top-level language model: embed -> layer stack -> head, with the
prefill ``forward``, the one-token ``decode_step`` and the training loss
``lm_loss`` (port of ``repro/models/model.py``)."""
from __future__ import annotations

import math
import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .layers import in_dtype, rms_norm, sinusoidal_positions, softcap
from .transformer import ExecContext, apply_encoder, apply_stack


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 positions=None) -> torch.Tensor:
    """Token ids -> embeddings; a floating-point input is precomputed
    frontend embeddings and passes through.  ``F.embedding`` gathers the
    same rows as indexing, and its backward sums repeated tokens without
    atomics, so a train step's gradient is the same on every run."""
    if tokens.dtype.is_floating_point:
        x = tokens
    else:
        x = F.embedding(tokens.long(), params["embed"]["tok"])
    if cfg.scale_embed:
        # JAX multiplies by the weak-typed sqrt(d): rounded to x's dtype
        # first (in bf16 sqrt(1152) is 34.0, not 33.94)
        x = x * in_dtype(math.sqrt(cfg.d_model), x.dtype)
    if cfg.abs_pos_embed and positions is not None:
        table = sinusoidal_positions(cfg.max_position, cfg.d_model, x.device)
        x = x + table[positions.long()].to(x.dtype)
    return x


def lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["tok"])
    else:
        logits = torch.einsum("bsd,dv->bsv", x, params["head"]["w"])
    return softcap(logits, cfg.logit_softcap)


def _encode(params, cfg: ModelConfig, ctx: ExecContext, enc_embeds):
    if cfg.encoder is None:
        return None
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass "
                         f"enc_embeds (B, {cfg.encoder.source_len}, "
                         f"{cfg.encoder.d_model})")
    return apply_encoder(params, enc_embeds, cfg, ctx)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            ctx: ExecContext, *, positions=None, caches=None,
            mrope_pos=None, enc_embeds=None, plan=None) -> LMOutput:
    """Full-sequence forward (prefill when ``ctx.mode == 'prefill'``).
    ``mrope_pos``: (3, B, S) M-RoPE positions (None: 1-D RoPE);
    ``enc_embeds``: an encoder-decoder model's frame embeddings."""
    b, s = tokens.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens, cfg, positions)
    enc_out = _encode(params, cfg, ctx, enc_embeds)
    x, aux, new_caches, trace, probs, moe_ins = apply_stack(
        params, x, cfg, ctx, positions, caches=caches, plan=plan,
        mrope_pos=mrope_pos, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return LMOutput(lm_head(params, x, cfg), aux, new_caches, trace, probs,
                    moe_ins)


def decode_step(params, tokens: torch.Tensor, caches, cfg: ModelConfig,
                ctx: ExecContext, *, mrope_pos=None, plan=None) -> LMOutput:
    """One-token serve step against the KV caches; tokens: (B, 1).  The
    caches are written in place and their ``pos`` (B,) advances by one,
    so the step reads and writes only fixed buffers (what a captured CUDA
    graph replays); ``LMOutput.caches`` is the same dict.  An
    encoder-decoder model reads the encoder's keys and values from the
    cache planes its prefill wrote."""
    positions = caches["pos"][:, None]        # (B, 1) absolute position
    x = embed_tokens(params, tokens, cfg, positions)
    x, aux, new_caches, trace, probs, moe_ins = apply_stack(
        params, x, cfg, ctx, positions, caches=caches, plan=plan,
        mrope_pos=mrope_pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return LMOutput(lm_head(params, x, cfg), aux, new_caches, trace, probs,
                    moe_ins)


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def _target_logit(logits: torch.Tensor, targets: torch.Tensor):
    return logits.gather(-1, targets.long()[..., None])[..., 0]


def _xent_terms_plain(params, x, targets, cfg: ModelConfig):
    """(lse, target-logit) for a chunk of hidden states (no full logits
    retained outside the chunk)."""
    logits = lm_head(params, x, cfg).float()
    return torch.logsumexp(logits, dim=-1), _target_logit(logits, targets)


class _FusedXent(torch.autograd.Function):
    """(lse, tgt) of ``x @ w.T`` with bf16 cotangents (the JAX package's
    ``_fused_xent`` custom VJP): the backward recomputes the chunk's
    logits in f32, forms ``d_logits = g_lse * softmax + g_tgt * onehot``
    in bf16, and returns ``d_x`` / ``d_w`` from bf16 products cast to the
    inputs' dtypes.  The one-hot term is added at each row's target (the
    same sum as the dense one-hot, without a (B, S, V) f32 buffer)."""

    @staticmethod
    def forward(ctx, w, x, targets):
        logits = torch.einsum("bsd,vd->bsv", x.float(), w.float())
        lse = torch.logsumexp(logits, dim=-1)
        tgt = _target_logit(logits, targets)
        ctx.save_for_backward(w, x, targets, lse)
        return lse, tgt

    @staticmethod
    def backward(ctx, g_lse, g_tgt):
        w, x, targets, lse = ctx.saved_tensors
        logits = torch.einsum("bsd,vd->bsv", x.float(), w.float())
        d = g_lse[..., None] * torch.exp(logits - lse[..., None])
        del logits
        d.scatter_add_(-1, targets.long()[..., None], g_tgt[..., None])
        d = d.to(torch.bfloat16)
        d_x = torch.einsum("bsv,vd->bsd", d, w.to(torch.bfloat16)).to(x.dtype)
        d_w = torch.einsum("bsv,bsd->vd", d, x.to(torch.bfloat16)).to(w.dtype)
        return d_w, d_x, None


def _xent_terms(params, x, targets, cfg: ModelConfig):
    """The fused path unless ``REPRO_XENT`` (read per call) asks for
    'plain' or the config soft-caps its logits."""
    fused = (os.environ.get("REPRO_XENT", "fused") == "fused"
             and cfg.logit_softcap == 0.0)
    if fused and cfg.tie_embeddings:
        return _FusedXent.apply(params["embed"]["tok"], x, targets)
    if fused:
        return _FusedXent.apply(params["head"]["w"].T, x, targets)
    return _xent_terms_plain(params, x, targets, cfg)


def lm_loss(params, batch, cfg: ModelConfig, ctx: ExecContext,
            z_loss: float = 1e-4, loss_chunk: int = 0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + router aux + z-loss.

    ``batch``: ``tokens`` (B, S), optional ``mask`` (B, S), ``mrope_pos``
    (3, B, S) and ``enc_embeds``.  ``loss_chunk`` > 0 computes the xent
    in sequence chunks (padded to a whole number, the pad masked) so the
    peak logits buffer is (B, chunk, V) instead of (B, S, V)."""
    tokens = batch["tokens"]
    b, s = tokens.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = embed_tokens(params, tokens, cfg, positions)
    enc_out = _encode(params, cfg, ctx, batch.get("enc_embeds"))
    x, aux, _, _, _, _ = apply_stack(params, x, cfg, ctx, positions,
                                     mrope_pos=batch.get("mrope_pos"),
                                     enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

    x = x[:, :-1]
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=tokens.device)
            if mask is None else mask[:, 1:].float())
    sl = s - 1
    if loss_chunk and sl > loss_chunk:
        pad = (-sl) % loss_chunk
        if pad:  # pad to a whole number of chunks; padded slots are masked
            x = F.pad(x, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad))
            mask = F.pad(mask, (0, pad))
        terms = [_xent_terms(params, x[:, c:c + loss_chunk],
                             targets[:, c:c + loss_chunk], cfg)
                 for c in range(0, sl + pad, loss_chunk)]
        lse = torch.cat([t[0] for t in terms], dim=1)
        tgt = torch.cat([t[1] for t in terms], dim=1)
    else:
        lse, tgt = _xent_terms(params, x, targets, cfg)
    nll = (lse - tgt) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    total = loss + zl + sum(aux.values())
    metrics = {"loss": loss, "z_loss": zl, **aux, "total_loss": total}
    return total, metrics

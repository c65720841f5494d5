"""GQA attention: prefill and step-mode decode (port of
``repro/models/attention.py``: ``attention`` and ``decode_attention``,
and the paged branch of the step-mode attention layer of
``repro/models/transformer.py``).

Prefill attention is plain PyTorch (the JAX package computes it outside
any Pallas kernel too).  Step-mode attention without softcap goes to the
flash-decode kernel wrapper for one query token per row, and for 2..8
query tokens per row with one position each (the verify pass of
speculative decoding: the kernel's multi-query mode, whose queries equal
single-query calls bit for bit; the JAX package computes that pass in
plain jnp).  Longer runs of query tokens (a suffix prefill), softcap and
``impl='ref'`` run the plain composition below, as the JAX package
computes them.  Over a paged cache (``paged_decode_attention``) the same
shapes go to the wrapper's block-table mode, which reads the page pool in
place; the other shapes gather each row's view first, as the JAX package
does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops
from ..kernels.decode_attention import (MAX_QUERIES, flash_decode_attention,
                                        flash_decode_attention_paged)
from .kvcache import paged_gather
from .layers import softcap

NEG_INF = -2.0 ** 30  # large-but-finite; keeps softmax NaN-free


def _kernel_queries(sq: int, cur_pos: torch.Tensor) -> int:
    """How many query positions per row the flash-decode wrapper takes
    for ``sq`` query tokens at ``cur_pos`` positions: 0 where the shape is
    not one of its modes, 1 for one query per row ((B,) or (B, 1)
    positions), ``sq`` for 2..MAX_QUERIES queries with (B, sq) positions."""
    if sq == 1 and (cur_pos.ndim == 1 or cur_pos.shape[1] == 1):
        return 1
    if 2 <= sq <= MAX_QUERIES and cur_pos.ndim == 2 and \
            cur_pos.shape[1] == sq:
        return sq
    return 0


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, KV, G, hd), k: (B, Skv, KV, hd) -> (B, KV, G, Sq, Skv)."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, KV, G, Sq, Skv), v: (B, Skv, KV, hd) -> (B, Sq, KV, G, hd)."""
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.to(p.dtype))


def _mask_bias(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(B, Sq) x (B, Skv) positions -> additive bias (B, Sq, Skv)."""
    valid = kv_pos[..., None, :] >= 0
    if causal:
        valid = valid & (kv_pos[..., None, :] <= q_pos[..., :, None])
    if window is not None and window > 0:
        valid = valid & (kv_pos[..., None, :] > (q_pos[..., :, None] - window))
    zero = torch.zeros((), dtype=torch.float32, device=kv_pos.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              attn_softcap: float = 0.0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Batched GQA attention in f32.  q: (B, Sq, H, hd); k/v: (B, Skv,
    KVH, hd); q_pos/kv_pos: (B, S*) absolute positions (-1 = empty).
    Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, g, hd).float() * scale
    s = softcap(_gqa_scores(qg, k.float()), attn_softcap)
    s = s + _mask_bias(q_pos, kv_pos, causal, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = _gqa_out(p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos: torch.Tensor,
                     cur_pos: torch.Tensor, *,
                     window: Optional[int] = None,
                     attn_softcap: float = 0.0,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Step-mode attention against a KV cache.

    q: (B, Sq, H, hd); caches: (B, Sc, KVH, hd); kv_pos: (B, Sc) with -1
    for unwritten slots; cur_pos: (B,) or (B, Sq) positions.  For an int8
    cache, k_scale/v_scale (B, Sc, KVH) fold into the scores and the
    softmax weights.
    """
    b, sq, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    impl = ops.resolve_impl(impl)
    nq = _kernel_queries(sq, cur_pos)
    if impl != "ref" and nq and not attn_softcap:
        qs = q.float() * scale
        out = flash_decode_attention(
            qs[:, 0] if nq == 1 else qs, k_cache, v_cache, kv_pos,
            cur_pos.reshape(b) if nq == 1 else cur_pos, k_scale, v_scale,
            window=window, require_kernel=(impl == "cuda"))
        return out.reshape(b, sq, h, hd).to(q.dtype)
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float() * scale
    s = _gqa_scores(qg, k_cache.float())
    if k_scale is not None:   # (B, Sc, KVH) -> (B, KVH, 1, 1, Sc)
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    s = softcap(s, attn_softcap)
    q_pos = cur_pos[:, None] if cur_pos.ndim == 1 else cur_pos
    s = s + _mask_bias(q_pos, kv_pos, True, window)[:, None, None]
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    out = _gqa_out(p, v_cache.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, cache, cur_pos: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Step-mode attention against a paged cache (``models/kvcache.py``:
    page pool, pool-shaped ``pos`` plane, (B, max_blocks) block table),
    after the step's writes.  One query token per row, and 2..8 with one
    position each, go to ``flash_decode_attention_paged`` (the kernel's
    block-table mode on the card); longer runs of query tokens, or
    ``impl='ref'``, gather each row's view (``paged_gather``) and run
    ``decode_attention``."""
    b, sq, h, hd = q.shape
    impl = ops.resolve_impl(impl)
    nq = _kernel_queries(sq, cur_pos)
    if impl != "ref" and nq:
        scale = scale if scale is not None else 1.0 / math.sqrt(hd)
        qs = q.float() * scale
        out = flash_decode_attention_paged(
            qs[:, 0] if nq == 1 else qs, cache["k"], cache["v"],
            cache["pos"], cache["block"],
            cur_pos.reshape(b) if nq == 1 else cur_pos,
            cache.get("k_scale"), cache.get("v_scale"), window=window,
            require_kernel=(impl == "cuda"))
        return out.reshape(b, sq, h, hd).to(q.dtype)
    k, v, pos, ks, vs = paged_gather(cache)
    return decode_attention(q, k, v, pos, cur_pos, window=window,
                            scale=scale, k_scale=ks, v_scale=vs, impl=impl)

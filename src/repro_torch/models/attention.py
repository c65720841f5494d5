"""GQA attention: prefill and step-mode decode (port of
``repro/models/attention.py``: ``attention`` and ``decode_attention``).

Prefill attention is plain PyTorch (the JAX package computes it outside
any Pallas kernel too).  Decode attention of one query token per row
without softcap goes to the flash-decode kernel wrapper; other step-mode
shapes (several query tokens, per-query positions, softcap) and
``impl='ref'`` run the plain composition below.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops
from ..kernels.decode_attention import flash_decode_attention
from .layers import softcap

NEG_INF = -2.0 ** 30  # large-but-finite; keeps softmax NaN-free


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
    one_pos = cur_pos.ndim == 1 or (cur_pos.ndim == 2
                                    and cur_pos.shape[1] == 1)
    if impl != "ref" and sq == 1 and not attn_softcap and one_pos:
        out = flash_decode_attention(
            q[:, 0].float() * scale, k_cache, v_cache, kv_pos,
            cur_pos.reshape(b), k_scale, v_scale, window=window,
            require_kernel=(impl == "cuda"))
        return out.reshape(b, 1, h, hd).to(q.dtype)
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

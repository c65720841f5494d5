"""Contiguous KV caches, with an optional int8 layout (port of the
contiguous part of ``repro/models/kvcache.py``).

A cache is a dict of tensors with a ``pos`` plane (absolute position per
slot, -1 = empty), so masking is position arithmetic.  Unlike the JAX
package, writes update the cache tensors in place (no second copy of the
cache per step) and return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch


def init_attn_cache(batch: int, length: int, kv_heads: int, head_dim: int,
                    dtype=torch.bfloat16, kv_bits: int = 16,
                    device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, length, kv_heads, head_dim)
    pos = torch.full((batch, length), -1, dtype=torch.int32, device=device)
    if kv_bits == 8:
        # int8 codes + per (token, head) absmax scale
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                   device=device),
            "pos": pos,
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": pos}


def reset_attn_cache(cache: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Put a cache back to its ``init_attn_cache`` state in place: K, V
    (and int8 scales) zero, every slot empty (pos -1)."""
    for name, t in cache.items():
        if name == "pos":
            t.fill_(-1)
        else:
            t.zero_()
    return cache


def _kv_quant(x: torch.Tensor):
    """(B, S, KV, hd) -> int8 codes + (B, S, KV) bf16 scales."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def update_attn_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                      v_new: torch.Tensor, pos: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Write S_new tokens at absolute positions ``pos`` (B, S_new), slot =
    pos % cache_len, in place."""
    length = cache["k"].shape[1]
    slot = (pos % length).long()
    b_idx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["pos"][b_idx, slot] = pos.to(torch.int32)
    if "k_scale" in cache:
        kq, ks = _kv_quant(k_new)
        vq, vs = _kv_quant(v_new)
        cache["k"][b_idx, slot] = kq
        cache["v"][b_idx, slot] = vq
        cache["k_scale"][b_idx, slot] = ks
        cache["v_scale"][b_idx, slot] = vs
        return cache
    cache["k"][b_idx, slot] = k_new.to(cache["k"].dtype)
    cache["v"][b_idx, slot] = v_new.to(cache["v"].dtype)
    return cache


def prefill_attn_cache(cache: Dict[str, torch.Tensor], k_all: torch.Tensor,
                       v_all: torch.Tensor, positions: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """Bulk cache write after prefill; a cache shorter than the prompt
    keeps the trailing ``length`` tokens."""
    length = cache["k"].shape[1]
    s = k_all.shape[1]
    if s > length:
        k_all, v_all = k_all[:, s - length:], v_all[:, s - length:]
        positions = positions[:, s - length:]
    return update_attn_cache(cache, k_all, v_all, positions)


def dequant_scales(cache: Dict[str, torch.Tensor]):
    """(k_scale, v_scale) if the cache is int8, else (None, None)."""
    return cache.get("k_scale"), cache.get("v_scale")

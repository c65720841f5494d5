"""KV caches, contiguous and paged, with an optional int8 layout, and the
recurrent states of the RG-LRU, mLSTM and sLSTM mixers (port of
``repro/models/kvcache.py``).

An attention cache is a dict of tensors with a ``pos`` plane (absolute
position per slot, -1 = empty), so masking is position arithmetic; a
recurrent state is a dict of f32 tensors with a leading batch axis.
Unlike the JAX package, writes update the cache tensors in place (no
second copy of the cache per step, and the tensors a captured decode
graph reads stay the same ones) and return the same dict.
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


def init_rglru_cache(batch: int, width: int, conv_width: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """RG-LRU state: the recurrence ``h`` (B, w) and the conv's last
    ``conv_width - 1`` inputs (B, cw - 1, w), f32."""
    return {"h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, width),
                                dtype=torch.float32, device=device)}


def init_mlstm_cache(batch: int, heads: int, head_dim: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """mLSTM state: matrix memory ``c`` (B, H, hd, hd), normaliser ``n``
    (B, H, hd) and stabiliser ``m`` (B, H) = -inf, f32."""
    return {"c": torch.zeros((batch, heads, head_dim, head_dim),
                             dtype=torch.float32, device=device),
            "n": torch.zeros((batch, heads, head_dim), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, heads), -float("inf"),
                            dtype=torch.float32, device=device)}


def init_slstm_cache(batch: int, heads: int, head_dim: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """sLSTM state: ``c``, ``n``, ``h`` zero and ``m`` -inf, each (B, H,
    hd) f32."""
    def z():
        return torch.zeros((batch, heads, head_dim), dtype=torch.float32,
                           device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, heads, head_dim), -float("inf"),
                            dtype=torch.float32, device=device)}


def slot_fill(name: str) -> float:
    """Empty-slot fill value per cache plane (the JAX package's
    ``_slot_fill``): position planes and block tables -1 (unwritten or
    unmapped), an xLSTM stabiliser ``m`` -inf (the identity of its max),
    everything else zero."""
    if name in ("pos", "block"):
        return -1
    if name == "m":
        return -float("inf")
    return 0


def reset_attn_cache(cache: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Put a layer's cache (contiguous or paged attention, or a recurrent
    state) back to its ``init_*`` state in place: every plane at its
    ``slot_fill`` value."""
    for name, t in cache.items():
        t.fill_(slot_fill(name))
    return cache


def claim_slot(cache: Dict[str, torch.Tensor],
               req_cache: Dict[str, torch.Tensor], slot: int
               ) -> Dict[str, torch.Tensor]:
    """Write a batch-1 per-request cache into row ``slot`` of a slotted
    cache, in place (every plane, ``pos`` included): the tensors a
    captured decode graph reads stay the same ones."""
    for name, t in cache.items():
        t[slot].copy_(req_cache[name][0])
    return cache


def reset_slot(cache: Dict[str, torch.Tensor], slot: int
               ) -> Dict[str, torch.Tensor]:
    """Clear row ``slot`` back to the empty-slot state in place, each
    plane at its ``slot_fill`` value (position planes -1: unwritten,
    masked by decode attention)."""
    for name, t in cache.items():
        t[slot].fill_(slot_fill(name))
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


# ---------------------------------------------------------------------------
# paged KV cache (block-table paging)
# ---------------------------------------------------------------------------
#
# A paged cache is a physical page pool (num_pages, page_size, ...) shared
# by every slot plus a per-slot block table (slots, max_blocks) of int32
# page ids (-1 = unmapped); its ``pos`` plane is pool-shaped (num_pages,
# page_size).  Physical page 0 is the write sink: writes of retired or
# empty slots (block entry -1, or a position past the mapped range) land
# there, and a read through an unmapped entry sees position -1.

TRASH_PAGE = 0


def is_paged(cache) -> bool:
    return isinstance(cache, dict) and "block" in cache


def init_paged_attn_cache(num_slots: int, num_pages: int, page_size: int,
                          max_blocks: int, kv_heads: int, head_dim: int,
                          dtype=torch.bfloat16, kv_bits: int = 16,
                          device=None) -> Dict[str, torch.Tensor]:
    """Page pool + block table.  ``num_pages`` INCLUDES the trash page."""
    shape = (num_pages, page_size, kv_heads, head_dim)
    out = {"block": torch.full((num_slots, max_blocks), -1,
                               dtype=torch.int32, device=device),
           "pos": torch.full((num_pages, page_size), -1, dtype=torch.int32,
                             device=device)}
    if kv_bits == 8:
        out["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        out["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        out["k_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                     device=device)
        out["v_scale"] = torch.zeros(shape[:3], dtype=torch.bfloat16,
                                     device=device)
    else:
        out["k"] = torch.zeros(shape, dtype=dtype, device=device)
        out["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return out


def _page_targets(cache: Dict[str, torch.Tensor], pos: torch.Tensor):
    """(page, offset) write targets for absolute positions ``pos`` (B, S)
    through the block table, unmapped or out-of-range positions routed to
    the trash page."""
    ps = cache["k"].shape[1]
    nb = cache["block"].shape[1]
    pos = pos.long()
    blk = torch.div(pos, ps, rounding_mode="floor")
    b_idx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    page = cache["block"][b_idx, blk.clamp(0, nb - 1)]
    page = torch.where((blk >= 0) & (blk < nb), page, -1)
    return page.clamp(min=TRASH_PAGE).long(), pos % ps


def paged_update_attn_cache(cache: Dict[str, torch.Tensor],
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            pos: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write S_new tokens at absolute positions ``pos`` (B, S_new) through
    the block table into the page pool, in place (the paged twin of
    ``update_attn_cache``; no ring wraparound)."""
    page, off = _page_targets(cache, pos)
    cache["pos"][page, off] = pos.to(torch.int32)
    if "k_scale" in cache:
        kq, ks = _kv_quant(k_new)
        vq, vs = _kv_quant(v_new)
        cache["k"][page, off] = kq
        cache["v"][page, off] = vq
        cache["k_scale"][page, off] = ks
        cache["v_scale"][page, off] = vs
        return cache
    cache["k"][page, off] = k_new.to(cache["k"].dtype)
    cache["v"][page, off] = v_new.to(cache["v"].dtype)
    return cache


def paged_gather(cache: Dict[str, torch.Tensor]):
    """Each slot's logical KV view materialised from the page pool:
    ``(k, v, kv_pos, k_scale, v_scale)`` with k/v (slots, max_blocks *
    page_size, KV, hd).  Positions under unmapped block entries come back
    -1.  The plain route of paged decode attention (and its test oracle):
    the decode path on the card reads the pool through the block table
    instead (``kernels.decode_attention.flash_decode_attention_paged``)."""
    bt = cache["block"]
    s, nb = bt.shape
    ps = cache["k"].shape[1]
    page = bt.clamp(min=0).long()

    def flat(plane):
        return plane[page].reshape((s, nb * ps) + tuple(plane.shape[2:]))

    kv_pos = torch.where(torch.repeat_interleave(bt < 0, ps, dim=1), -1,
                         flat(cache["pos"]))
    ks = flat(cache["k_scale"]) if "k_scale" in cache else None
    vs = flat(cache["v_scale"]) if "v_scale" in cache else None
    return flat(cache["k"]), flat(cache["v"]), kv_pos, ks, vs


def paged_claim(cache: Dict[str, torch.Tensor],
                req_cache: Dict[str, torch.Tensor], slot: int,
                pages: torch.Tensor, write_mask: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Map ``pages`` into row ``slot`` of the block table and write the
    request's contiguous prefilled planes into its freshly allocated
    pages, in place.

    ``req_cache`` planes are batch-1 contiguous of page-aligned length L;
    ``pages``: (max_blocks,) physical page ids (-1 past the request's
    allocation); ``write_mask``: (max_blocks,) True for pages whose
    content this claim owns (fresh prompt pages get the matching chunk,
    fresh decode pages the empty fill), False for prefix-shared pages
    (read-only) and -1 pads.  Masked-out writes land on the trash
    page."""
    ps = cache["k"].shape[1]
    nb = pages.shape[0]
    n_src = req_cache["k"].shape[1] // ps
    tgt = torch.where(write_mask, pages.clamp(min=0),
                      TRASH_PAGE).long()

    def chunks(plane, fill):
        src = plane[0].reshape((n_src, ps) + tuple(plane.shape[2:]))
        if nb > n_src:
            pad = torch.full((nb - n_src, ps) + tuple(plane.shape[2:]), fill,
                             dtype=src.dtype, device=src.device)
            src = torch.cat([src, pad], dim=0)
        return src[:nb]

    cache["block"][slot].copy_(pages)
    cache["pos"][tgt] = chunks(req_cache["pos"].to(torch.int32), -1)
    for name in (n for n in ("k", "v", "k_scale", "v_scale") if n in cache):
        cache[name][tgt] = chunks(req_cache[name].to(cache[name].dtype), 0)
    return cache


def paged_reset(cache: Dict[str, torch.Tensor], slot: int
                ) -> Dict[str, torch.Tensor]:
    """Unmap row ``slot`` of the block table in place (the allocator frees
    the pages; their contents are rewritten by the next claim)."""
    cache["block"][slot].fill_(-1)
    return cache


def paged_seed_prefix(req_cache: Dict[str, torch.Tensor],
                      cache: Dict[str, torch.Tensor], pages: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Copy the shared-prefix pages of ``pages`` (-1 past the prefix) into
    the leading span of a batch-1 contiguous request cache, in place, so
    a suffix-only prefill attends over the reused prefix KV without
    recomputing it."""
    ps = cache["k"].shape[1]
    m = req_cache["k"].shape[1] // ps
    pg = pages[:m]
    page = pg.clamp(min=0).long()

    def pull(plane):
        return plane[page].reshape((1, m * ps) + tuple(plane.shape[2:]))

    req_cache["pos"].copy_(torch.where(
        torch.repeat_interleave(pg < 0, ps)[None, :], -1,
        pull(cache["pos"])))
    for name in (n for n in ("k", "v", "k_scale", "v_scale")
                 if n in req_cache):
        req_cache[name].copy_(pull(cache[name]).to(req_cache[name].dtype))
    return req_cache

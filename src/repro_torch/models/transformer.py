"""Layer stack: parameter init, offline compression, caches and the
per-layer forward (port of the attention-layer subset of
``repro/models/transformer.py``).

Parameters are plain dicts of tensors with one dict per layer under
``params["layers"]`` (the JAX package's scanned segments become a Python
loop).  Only the layers the serving slices run are ported: a global or
local (sliding-window) attention mixer, with QKV biases and Gemma-style
post-norms where the config asks for them, followed by an MoE FFN or a
dense FFN.  A local layer's KV cache is a ring of ``window_size`` slots.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .. import resolve_device
from ..config import ModelConfig
from .attention import attention, decode_attention, paged_decode_attention
from .ffn import ffn_apply, ffn_apply_quantized
from .kvcache import (TRASH_PAGE, claim_slot, dequant_scales,
                      init_attn_cache, init_paged_attn_cache, is_paged,
                      paged_claim,
                      paged_reset, paged_seed_prefix,
                      paged_update_attn_cache, prefill_attn_cache,
                      reset_attn_cache, reset_slot, update_attn_cache)
from .layers import apply_rope, dense_init, embed_init, rms_norm
from .moe import RoutingInfo, moe_apply


class LayerSpec(NamedTuple):
    mixer: str          # global | local (sliding window)
    ffn: str            # moe | dense


@dataclasses.dataclass
class ExecContext:
    """Runtime knobs threaded through the forward pass."""
    mode: str = "train"              # train | prefill | step
    quantized: bool = False          # serve on compressed experts
    exact_capacity: bool = False     # drop-free MoE (C = T)
    # expert/attention kernel dispatch: 'auto' | 'cuda' | 'ref'
    kernel_impl: Optional[str] = None
    # return per-MoE-layer routing (top-k ids and router probs)
    collect_trace: bool = False
    # return per-MoE-layer normed FFN inputs (T, d): the offline
    # calibration pass (calib/stats.py) accumulates its statistics on them
    collect_moe_inputs: bool = False


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        mixer = cfg.layer_kind(i)
        moe = cfg.moe is not None and cfg.is_moe_layer(i) and not (
            i == 0 and cfg.first_layer_dense)
        if mixer not in ("global", "local"):
            raise NotImplementedError(
                f"layer {i} of {cfg.name} is ({mixer}, "
                f"{'moe' if moe else 'dense'}); the port runs global and "
                "local attention layers only (ROADMAP A12)")
        specs.append(LayerSpec(mixer, "moe" if moe else "dense"))
    return specs


def has_local(cfg: ModelConfig) -> bool:
    """Whether the plan has a sliding-window layer (whose ring cache can
    neither invalidate prompt padding nor roll back a rejected draft)."""
    return any(s.mixer == "local" for s in layer_specs(cfg))


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                device, dtype):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def di(shape, fan_in, dt=dtype):
        return dense_init(shape, fan_in, gen, device, dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    p = {
        "pre_norm": zeros((d,)),
        "attn": {"wq": di((d, h, hd), d), "wk": di((d, kv, hd), d),
                 "wv": di((d, kv, hd), d), "wo": di((h, hd, d), h * hd)},
        "ffn_norm": zeros((d,)),
    }
    if cfg.qkv_bias:
        # zeros, as the JAX package initialises them
        p["attn"].update(bq=zeros((h, hd)), bk=zeros((kv, hd)),
                         bv=zeros((kv, hd)))
    if cfg.post_attn_norm:
        p["post_norm"] = zeros((d,))
        p["post_ffn_norm"] = zeros((d,))
    if spec.ffn == "moe":
        fe, ne = cfg.moe.d_expert, cfg.moe.num_experts
        p["moe"] = {"router": di((d, ne), d, torch.float32),
                    "w1": di((ne, d, fe), d), "w3": di((ne, d, fe), d),
                    "w2": di((ne, fe, d), fe)}
        if cfg.moe.num_shared_experts:
            # the shared experts as one gated FFN of their summed width
            # (the layout of the JAX package's ``_init_moe``)
            fs = (cfg.moe.d_shared or fe) * cfg.moe.num_shared_experts
            p["moe"]["shared"] = {"w1": di((d, fs), d), "w3": di((d, fs), d),
                                  "w2": di((fs, d), fs)}
    else:
        ff = cfg.d_ff
        p["ffn"] = {"w1": di((d, ff), d), "w2": di((ff, d), ff)}
        if cfg.gated_ffn:
            p["ffn"]["w3"] = di((d, ff), d)
    return p


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default: the CUDA device; raises if there is none)."""
    dev = resolve_device(device)
    specs = layer_specs(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": {"tok": embed_init((cfg.vocab_size, cfg.d_model), gen, dev,
                                    dtype)},
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init((cfg.d_model, cfg.vocab_size),
                                          cfg.d_model, gen, dev, dtype)}
    params["layers"] = [_init_layer(gen, spec, cfg, dev, dtype)
                        for spec in specs]
    return params


@torch.no_grad()
def compress_moe_params(params, cfg: ModelConfig, qcfg=None, plan=None,
                        stats=None):
    """Compress every MoE layer's experts for quantized serving: w1/w3/w2
    become ``CompressedExpertStack``s under ``moe["stacks"]``.  Only the
    routed experts are compressed, as in the JAX package: shared experts
    and dense layers stay as they are.

    ``plan`` (a ``calib.CompressionPlan``) pins per-expert bits and
    per-projection ranks per MoE layer; ``stats`` (per-MoE-layer
    ``calib.LayerCalibStats``) whitens the compensator factorizations by
    the calibrated second moments.  Both None keeps the kurtosis-guided
    uniform-bit path.

    Runs on the device the weights live on.  Returns ``(qparams, cfg_q,
    stacks_by_layer)`` like the JAX package (``cfg_q`` has
    ``force_unroll_plan`` set); ``params`` itself is not modified."""
    from ..core.pipeline import compress_ffn_weights
    qcfg = qcfg or cfg.moe.quant
    layers, stacks_by_layer = [], []
    for lp in params["layers"]:
        lp = dict(lp)
        if "moe" not in lp:
            layers.append(lp)
            continue
        li = len(stacks_by_layer)
        mp = dict(lp["moe"])
        stacks, _ = compress_ffn_weights(
            mp.pop("w1"), mp.pop("w2"), mp.pop("w3"), qcfg,
            allocation=None if plan is None else plan.layers[li],
            stats=None if stats is None else stats[li])
        stacks_by_layer.append(stacks)
        mp["stacks"] = stacks
        lp["moe"] = mp
        layers.append(lp)
    qparams = dict(params)
    qparams["layers"] = layers
    return (qparams, dataclasses.replace(cfg, force_unroll_plan=True),
            stacks_by_layer)


def apply_compressed_stacks(params, cfg: ModelConfig, stacks_by_layer):
    """Swap precompressed stacks dicts into the MoE layers of a fresh
    parameter dict: the artifact boot path (``launch/serve.py
    --artifact``), no HQQ and no factorization.  Returns ``(qparams,
    cfg_q)`` in the layout ``compress_moe_params`` produces, so serving
    from an artifact equals serving from in-memory compression."""
    n_moe = sum(1 for s in layer_specs(cfg) if s.ffn == "moe")
    if n_moe != len(stacks_by_layer):
        raise ValueError(f"artifact has {len(stacks_by_layer)} MoE layers; "
                         f"config {cfg.name} has {n_moe}")
    layers, li = [], 0
    for lp in params["layers"]:
        lp = dict(lp)
        if "moe" in lp:
            mp = {k: v for k, v in lp["moe"].items()
                  if k not in ("w1", "w2", "w3")}
            mp["stacks"] = stacks_by_layer[li]
            lp["moe"] = mp
            li += 1
        layers.append(lp)
    qparams = dict(params)
    qparams["layers"] = layers
    return qparams, dataclasses.replace(cfg, force_unroll_plan=True)


@torch.no_grad()
def compress_dense_params(params, cfg: ModelConfig, qcfg=None):
    """Compress every dense FFN for quantized serving: the counterpart of
    ``compress_moe_params`` for dense layers, in the dense-degenerate form
    of DESIGN.md §5.  A dense FFN is one expert: each projection goes
    through ``compress_ffn_weights`` as a (1, K, N) view, and the E = 1
    stacks replace the weights under ``ffn["stacks"]`` (the layout of
    ``repro/launch/steps.py``'s abstract dense stacks).

    ``qcfg`` defaults to ``cfg.quant``.  Runs on the device the weights
    live on.  Returns ``(qparams, cfg_q)`` (``cfg_q`` has
    ``force_unroll_plan`` set); ``params`` itself is not modified."""
    from ..core.pipeline import compress_ffn_weights
    qcfg = qcfg or cfg.quant
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if "ffn" in lp:
            fp = lp["ffn"]
            w3 = fp.get("w3")
            stacks, _ = compress_ffn_weights(
                fp["w1"][None], fp["w2"][None],
                None if w3 is None else w3[None], qcfg)
            lp["ffn"] = {"stacks": stacks}
        layers.append(lp)
    qparams = dict(params)
    qparams["layers"] = layers
    return qparams, dataclasses.replace(cfg, force_unroll_plan=True)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> Dict:
    """Contiguous caches of ``max_len`` slots per row; a local layer's is a
    ring of ``min(window_size, max_len)`` slots (slot = position mod its
    length)."""
    return {"layers": [init_attn_cache(
                batch, min(cfg.window_size, max_len)
                if spec.mixer == "local" else max_len, cfg.num_kv_heads,
                cfg.head_dim, dtype, kv_bits=cfg.kv_bits, device=device)
                       for spec in layer_specs(cfg)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_caches(cfg: ModelConfig, num_slots: int, num_pages: int,
                      page_size: int, max_blocks: int,
                      dtype=torch.bfloat16, device=None) -> Dict:
    """Slotted serve caches with paged attention layers: each layer owns
    a (num_pages, page_size, ...) pool and a (num_slots, max_blocks)
    block table, all layers sharing one page-id space, so the host
    allocator hands out one page list per request.  A plan with a local
    layer raises: the JAX package keeps its rings contiguous beside the
    paged layers, a mixed plan the port does not have yet (ROADMAP
    A12)."""
    if has_local(cfg):
        raise NotImplementedError(
            f"{cfg.name}: a paged cache for a plan with local (ring) layers "
            "is not ported yet: ROADMAP A12")
    return {"layers": [init_paged_attn_cache(
                num_slots, num_pages, page_size, max_blocks,
                cfg.num_kv_heads, cfg.head_dim, dtype, kv_bits=cfg.kv_bits,
                device=device) for _ in layer_specs(cfg)],
            "pos": torch.zeros((num_slots,), dtype=torch.int32,
                               device=device)}


def reset_caches(caches: Dict) -> Dict:
    """Put caches (contiguous or paged) back to their ``init_caches`` /
    ``init_paged_caches`` state in place, so the tensors a captured
    decode graph reads stay the same ones."""
    for c in caches["layers"]:
        reset_attn_cache(c)
    caches["pos"].zero_()
    return caches


def cache_claim_slot(cfg: ModelConfig, caches: Dict, req_caches: Dict,
                     slot: int) -> Dict:
    """Write a batch-1 prefilled cache into batch row ``slot`` of a slotted
    cache (same cfg and cache length), in place; the slot's absolute
    position comes along from ``req_caches['pos']``.  Returns ``caches``."""
    for c, r in zip(caches["layers"], req_caches["layers"]):
        claim_slot(c, r, slot)
    caches["pos"][slot].copy_(req_caches["pos"][0])
    return caches


def cache_reset_slot(cfg: ModelConfig, caches: Dict, slot: int) -> Dict:
    """Clear batch row ``slot`` back to the empty state in place (pos
    planes -1, position 0).  Returns ``caches``."""
    for c in caches["layers"]:
        reset_slot(c, slot)
    caches["pos"][slot] = 0
    return caches


def cache_claim_slot_paged(cfg: ModelConfig, caches: Dict, req_caches: Dict,
                           slot: int, pages: torch.Tensor,
                           write_mask: torch.Tensor) -> Dict:
    """Paged twin of ``cache_claim_slot``, in place: each layer maps
    ``pages`` into its block-table row and writes the request's
    contiguous prefilled chunks into the pages ``write_mask`` marks as
    this claim's (``kvcache.paged_claim``).  Returns ``caches``."""
    for c, r in zip(caches["layers"], req_caches["layers"]):
        paged_claim(c, r, slot, pages, write_mask)
    caches["pos"][slot].copy_(req_caches["pos"][0])
    return caches


def cache_reset_slot_paged(cfg: ModelConfig, caches: Dict, slot: int
                           ) -> Dict:
    """Paged twin of ``cache_reset_slot``, in place: each layer only
    unmaps the slot's block-table row (page contents are rewritten on the
    next claim), and the slot's position returns to 0."""
    for c in caches["layers"]:
        paged_reset(c, slot)
    caches["pos"][slot] = 0
    return caches


def cache_seed_prefix(cfg: ModelConfig, req_caches: Dict, caches: Dict,
                      pages: torch.Tensor) -> Dict:
    """Seed a batch-1 contiguous request cache, in place, with the
    shared-prefix pages of a paged serve cache (``pages``: (max_blocks,)
    page ids, -1 past the shared span), so a suffix-only prefill attends
    over reused prefix KV without recomputing it.  Returns
    ``req_caches``."""
    for r, c in zip(req_caches["layers"], caches["layers"]):
        paged_seed_prefix(r, c, pages)
    return req_caches


def mask_cache_padding(cfg: ModelConfig, caches: Dict, plen: torch.Tensor
                       ) -> Dict:
    """Invalidate cache entries written by right-padded prefill tokens:
    position planes at positions >= plen become -1 and the per-row decode
    position is pinned to plen (in place).  A paged layer's pool-shaped
    ``pos`` plane is left alone."""
    lim = plen.to(torch.int32)[:, None]
    for c in caches["layers"]:
        if not is_paged(c):
            c["pos"].masked_fill_(c["pos"] >= lim, -1)
    caches["pos"].copy_(plen)
    return caches


def cache_rollback(cfg: ModelConfig, caches: Dict, new_len: torch.Tensor
                   ) -> Dict:
    """Roll a slotted cache back to ``new_len`` (B,) committed tokens, in
    place.

    Speculative decoding's verify pass appends KV for every drafted
    token; rejection keeps only a per-row accepted prefix.  Attention
    entries at absolute positions >= new_len are invalidated (pos -> -1)
    and their K/V payloads (and int8 scales) are zeroed: fresh cache
    planes are zero-filled and, with enough ring headroom, append-only,
    so the rolled-back cache is bit-identical to one that never saw the
    rejected suffix.  The per-row decode position becomes ``new_len``.

    Paged layers mask the pool through the block table: each page takes
    the minimum ``new_len`` over the slots whose block-table rows map it.
    Refcount-shared prefix pages hold only positions below every owner's
    prompt length (<= any new_len), so they are untouched; the trash page
    is exempt, so out-of-range verify writes parked there leak no limit
    onto it.  Every write goes into the tensors a captured graph reads.
    Returns ``caches``."""
    new_len = new_len.to(torch.int32)
    imax = torch.iinfo(torch.int32).max
    for c in caches["layers"]:
        if is_paged(c):
            blk = c["block"]
            lim = torch.full((c["pos"].shape[0],), imax, dtype=torch.int32,
                             device=blk.device)
            # unmapped entries (-1) land on the trash page, reset after (a
            # fill, not an indexed store of a host scalar: that would copy
            # it to the card and sync)
            lim.scatter_reduce_(0, blk.clamp(min=0).reshape(-1).long(),
                                new_len[:, None].expand_as(blk).reshape(-1),
                                "amin")
            lim.narrow(0, TRASH_PAGE, 1).fill_(imax)
            bad = c["pos"] >= lim[:, None]
        else:
            bad = c["pos"] >= new_len[:, None]
        c["pos"].masked_fill_(bad, -1)
        for name in ("k", "v"):
            c[name].masked_fill_(bad[..., None, None], 0)
        for name in ("k_scale", "v_scale"):
            if name in c:
                c[name].masked_fill_(bad[..., None], 0)
    caches["pos"].copy_(new_len)
    return caches


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _attn_layer(x, ap, cfg: ModelConfig, ctx: ExecContext, mixer: str,
                positions, cache):
    window = cfg.window_size if mixer == "local" else None
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"])
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    theta = (cfg.rope_local_theta if mixer == "local"
             and cfg.rope_local_theta else cfg.rope_theta)
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if ctx.mode == "step" and is_paged(cache):
        # paged: write through the block table, then read the pool through
        # it (block-table contents are data, so one captured decode graph
        # serves every length mix of its envelope)
        paged_update_attn_cache(cache, k, v, positions)
        out = paged_decode_attention(q, cache, positions,
                                     impl=ctx.kernel_impl)
    elif ctx.mode == "step":
        upd = update_attn_cache(cache, k, v, positions)
        ks, vs = dequant_scales(upd)
        out = decode_attention(q, upd["k"], upd["v"], upd["pos"], positions,
                               window=window, k_scale=ks, v_scale=vs,
                               impl=ctx.kernel_impl)
    else:
        out = attention(q, k, v, positions, positions, causal=True,
                        window=window)
        if ctx.mode == "prefill" and cache is not None:
            prefill_attn_cache(cache, k, v, positions)
    return torch.einsum("bshk,hkd->bsd", out, ap["wo"])


def apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, ctx: ExecContext,
                positions, cache, plan_row=None):
    """One transformer layer.  Returns (x, aux, routing info, MoE input);
    a dense layer gives no aux, no routing info and no MoE input.  The
    MoE input is the (T, d) f32 normed FFN input when
    ``ctx.collect_moe_inputs`` is set, else None."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    y = _attn_layer(h, p["attn"], cfg, ctx, spec.mixer, positions, cache)
    if cfg.post_attn_norm:
        y = rms_norm(y, p["post_norm"], cfg.norm_eps)
    x = x + y
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        fp = p["ffn"]
        if ctx.quantized and "stacks" in fp:
            y = ffn_apply_quantized(h, fp["stacks"], cfg.act, cfg.gated_ffn,
                                    impl=ctx.kernel_impl)
        else:
            y = ffn_apply(h, fp, cfg.act, cfg.gated_ffn)
        return x + _post_ffn(y, p, cfg), {}, None, None
    mp = p["moe"]
    b, s, d = h.shape
    y2, aux, info = moe_apply(
        h.reshape(-1, d), mp, cfg.moe, act=cfg.act,
        quantized=ctx.quantized and "stacks" in mp,
        exact_capacity=ctx.exact_capacity, impl=ctx.kernel_impl,
        plan=plan_row, with_aux=ctx.mode == "train")
    y = y2.reshape(b, s, d)
    moe_in = h.reshape(-1, d).float() if ctx.collect_moe_inputs else None
    if "shared" in mp:
        # shared experts: every token, uncompressed, on the same input
        y = y + ffn_apply(h, mp["shared"], cfg.act, True)
    return x + _post_ffn(y, p, cfg), aux, info, moe_in


def _post_ffn(y, p, cfg: ModelConfig):
    """Gemma-style norm of the FFN output before the residual add."""
    if cfg.post_attn_norm:
        return rms_norm(y, p["post_ffn_norm"], cfg.norm_eps)
    return y


def apply_stack(params, x, cfg: ModelConfig, ctx: ExecContext, positions,
                caches=None, plan=None):
    """Run every layer.  Returns (x, aux, caches, trace, probs,
    moe_inputs); with caches, their per-row decode position
    ``caches["pos"]`` advances in place past the last of ``positions``.

    ``trace`` is the stacked (moe_layers, T, k) int32 router top-k ids in
    layer order and ``probs`` the (moe_layers, T, E) router
    probabilities, both when ``ctx.collect_trace`` is set and the model
    has an MoE layer (else None).  ``moe_inputs`` is the stacked
    (moe_layers, T, d) f32 normed MoE-FFN inputs in the same order when
    ``ctx.collect_moe_inputs`` is set (the calibration pass).
    ``plan``: optional (moe_layers, 2) [top_n, rank_cap] rows."""
    use_cache = caches is not None and ctx.mode in ("prefill", "step")
    aux = {"load_balance": 0.0, "router_z": 0.0}
    infos: List[RoutingInfo] = []
    moe_ins: List[torch.Tensor] = []
    for li, (lp, spec) in enumerate(zip(params["layers"], layer_specs(cfg))):
        x, a, info, moe_in = apply_layer(
            x, lp, spec, cfg, ctx, positions,
            caches["layers"][li] if use_cache else None,
            plan_row=None if plan is None or spec.ffn != "moe"
            else plan[len(infos)])
        for key, val in a.items():
            aux[key] = aux[key] + val    # empty outside training
        if info is not None:
            infos.append(info)
        if moe_in is not None:
            moe_ins.append(moe_in)
    new_caches = None
    if use_cache:
        # in decode ``positions`` is a view of caches["pos"]: advance it
        # only after every layer has read it
        caches["pos"].copy_(positions[:, -1] + 1)
        new_caches = caches
    trace = probs = None
    if ctx.collect_trace and infos:
        trace = torch.stack([i.topk_idx.to(torch.int32) for i in infos])
        probs = torch.stack([i.probs for i in infos])
    moe_inputs = torch.stack(moe_ins) if moe_ins else None
    return x, aux, new_caches, trace, probs, moe_inputs

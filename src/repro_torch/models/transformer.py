"""Layer stack: parameter init, offline compression, caches and the
per-layer forward (port of the global-attention subset of
``repro/models/transformer.py``).

Parameters are plain dicts of tensors with one dict per layer under
``params["layers"]`` (the JAX package's scanned segments become a Python
loop).  Only the layers the serving slices run are ported: a
global-attention mixer followed by an MoE FFN or a dense FFN.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from .. import resolve_device
from ..config import ModelConfig
from .attention import attention, decode_attention
from .ffn import ffn_apply, ffn_apply_quantized
from .kvcache import (claim_slot, dequant_scales, init_attn_cache,
                      prefill_attn_cache, reset_attn_cache, reset_slot,
                      update_attn_cache)
from .layers import apply_rope, dense_init, embed_init, rms_norm
from .moe import RoutingInfo, moe_apply


class LayerSpec(NamedTuple):
    mixer: str          # global (the only mixer of this slice)
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
    if cfg.qkv_bias or cfg.post_attn_norm:
        raise NotImplementedError(
            f"{cfg.name}: qkv bias and post-attention norms are not ported")
    for i in range(cfg.num_layers):
        mixer = cfg.layer_kind(i)
        moe = cfg.moe is not None and cfg.is_moe_layer(i) and not (
            i == 0 and cfg.first_layer_dense)
        if mixer != "global":
            raise NotImplementedError(
                f"layer {i} of {cfg.name} is ({mixer}, "
                f"{'moe' if moe else 'dense'}); the port runs global "
                "attention layers only")
        specs.append(LayerSpec(mixer, "moe" if moe else "dense"))
    return specs


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig,
                device, dtype):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def di(shape, fan_in, dt=dtype):
        return dense_init(shape, fan_in, gen, device, dt)

    p = {
        "pre_norm": torch.zeros((d,), dtype=dtype, device=device),
        "attn": {"wq": di((d, h, hd), d), "wk": di((d, kv, hd), d),
                 "wv": di((d, kv, hd), d), "wo": di((h, hd, d), h * hd)},
        "ffn_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
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
    return {"layers": [init_attn_cache(batch, max_len, cfg.num_kv_heads,
                                       cfg.head_dim, dtype,
                                       kv_bits=cfg.kv_bits, device=device)
                       for _ in layer_specs(cfg)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def reset_caches(caches: Dict) -> Dict:
    """Put caches back to their ``init_caches`` state in place, so the
    tensors a captured decode graph reads stay the same ones."""
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


def mask_cache_padding(cfg: ModelConfig, caches: Dict, plen: torch.Tensor
                       ) -> Dict:
    """Invalidate cache entries written by right-padded prefill tokens:
    position planes at positions >= plen become -1 and the per-row decode
    position is pinned to plen (in place)."""
    lim = plen.to(torch.int32)[:, None]
    for c in caches["layers"]:
        c["pos"].masked_fill_(c["pos"] >= lim, -1)
    caches["pos"].copy_(plen)
    return caches


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------

def _attn_layer(x, ap, cfg: ModelConfig, ctx: ExecContext, positions, cache):
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if ctx.mode == "step":
        upd = update_attn_cache(cache, k, v, positions)
        ks, vs = dequant_scales(upd)
        out = decode_attention(q, upd["k"], upd["v"], upd["pos"], positions,
                               k_scale=ks, v_scale=vs, impl=ctx.kernel_impl)
    else:
        out = attention(q, k, v, positions, positions, causal=True)
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
    x = x + _attn_layer(h, p["attn"], cfg, ctx, positions, cache)
    h = rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        fp = p["ffn"]
        if ctx.quantized and "stacks" in fp:
            y = ffn_apply_quantized(h, fp["stacks"], cfg.act, cfg.gated_ffn,
                                    impl=ctx.kernel_impl)
        else:
            y = ffn_apply(h, fp, cfg.act, cfg.gated_ffn)
        return x + y, {}, None, None
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
    return x + y, aux, info, moe_in


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

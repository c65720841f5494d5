"""Layer stack: parameter init, offline compression, caches and the
per-layer forward (port of ``repro/models/transformer.py``).

Parameters are plain dicts of tensors with one dict per layer under
``params["layers"]`` (the JAX package's scanned segments become a Python
loop).  A layer's mixer is global or local (sliding-window) attention,
with QKV biases and Gemma-style post-norms where the config asks for
them, or a Griffin recurrent block (RG-LRU + conv1d), each followed by an
MoE FFN or a dense FFN; or a self-contained xLSTM block (mLSTM, or sLSTM
with its own gated FFN).  A local layer's KV cache is a ring of
``window_size`` slots; a recurrent or xLSTM layer's cache is its O(1)
state, written in place.  An encoder-decoder config (Whisper) adds a
bidirectional encoder tower (``apply_encoder``) and cross-attention in
every decoder layer, whose encoder keys and values are cache planes
written at prefill; an mrope config (Qwen2-VL) rotates by (t, h, w)
position streams when the caller passes them.  ``ExecContext.remat``
recomputes each decoder layer in the backward pass
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..config import ModelConfig
from .attention import attention, decode_attention, paged_decode_attention
from .ffn import ffn_apply, ffn_apply_quantized
from .kvcache import (TRASH_PAGE, claim_slot, dequant_scales,
                      init_attn_cache, init_mlstm_cache,
                      init_paged_attn_cache, init_rglru_cache,
                      init_slstm_cache, is_paged, paged_claim,
                      paged_reset, paged_seed_prefix,
                      paged_update_attn_cache, prefill_attn_cache,
                      reset_attn_cache, reset_slot, update_attn_cache)
from .layers import (apply_mrope, apply_rope, dense_init, embed_init,
                     rms_norm, silu)
from .moe import RoutingInfo, moe_apply
from .rglru import rglru_seq, rglru_step
from .xlstm import mlstm_chunkwise, mlstm_step, slstm_seq

MIXERS = ("global", "local", "recurrent", "mlstm", "slstm")


class LayerSpec(NamedTuple):
    mixer: str          # global | local | recurrent | mlstm | slstm
    ffn: str            # moe | dense | none
    cross: bool = False  # enc-dec decoder cross-attention


@dataclasses.dataclass
class ExecContext:
    """Runtime knobs threaded through the forward pass."""
    mode: str = "train"              # train | prefill | step
    quantized: bool = False          # serve on compressed experts
    # expert parallelism (``launch.steps.make_context(mesh=)``): 'a2a'
    # (prefill) | 'replicated' (decode) run the MoE block through
    # ``moe_ep_fn`` (``distributed.moe_parallel``) over the rank's local
    # slice of experts
    ep_mode: str = "none"            # none | a2a | replicated
    moe_ep_fn: Optional[Callable] = None
    exact_capacity: bool = False     # drop-free MoE (C = T)
    # expert/attention kernel dispatch: 'auto' | 'cuda' | 'ref'
    kernel_impl: Optional[str] = None
    # return per-MoE-layer routing (top-k ids and router probs)
    collect_trace: bool = False
    # return per-MoE-layer normed FFN inputs (T, d): the offline
    # calibration pass (calib/stats.py) accumulates its statistics on them
    collect_moe_inputs: bool = False
    # recompute each decoder layer in the backward pass; 'full' only (the
    # JAX package's 'dots' policy serves its dry run: ROADMAP A15,
    # tooling)
    remat: bool = False
    remat_policy: str = "full"       # full | dots


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    """Each layer's (mixer, ffn, cross); an xLSTM block carries no
    separate FFN, and every layer of an encoder-decoder config
    cross-attends."""
    cross = cfg.encoder is not None
    specs = []
    for i in range(cfg.num_layers):
        mixer = cfg.layer_kind(i)
        if mixer not in MIXERS:
            raise ValueError(f"layer {i} of {cfg.name}: unknown mixer "
                             f"{mixer!r}")
        if mixer in ("mlstm", "slstm"):
            ffn = "none"
        elif cfg.moe is not None and cfg.is_moe_layer(i) and not (
                i == 0 and cfg.first_layer_dense):
            ffn = "moe"
        else:
            ffn = "dense"
        specs.append(LayerSpec(mixer, ffn, cross))
    return specs


def all_global(cfg: ModelConfig) -> bool:
    """Whether every mixer is global attention: only such a plan's caches
    can invalidate right-padded prompt tokens, seed a prefix from shared
    pages or roll back a rejected draft (a ring or a recurrent state
    cannot)."""
    return all(s.mixer == "global" for s in layer_specs(cfg))


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

    p = {"pre_norm": zeros((d,))}
    if spec.mixer in ("mlstm", "slstm"):
        # self-contained blocks
        p[spec.mixer] = (_init_mlstm if spec.mixer == "mlstm"
                         else _init_slstm)(cfg, di, zeros, device)
        return p
    if spec.mixer == "recurrent":
        p["rglru"] = _init_rglru(cfg, di, device)
    else:
        p["attn"] = {"wq": di((d, h, hd), d), "wk": di((d, kv, hd), d),
                     "wv": di((d, kv, hd), d), "wo": di((h, hd, d), h * hd)}
        if cfg.qkv_bias:
            # zeros, as the JAX package initialises them
            p["attn"].update(bq=zeros((h, hd)), bk=zeros((kv, hd)),
                             bv=zeros((kv, hd)))
        if spec.cross:
            ed = cfg.encoder.d_model
            p["attn"].update(cross_wq=di((d, h, hd), d),
                             cross_wk=di((ed, h, hd), ed),
                             cross_wv=di((ed, h, hd), ed),
                             cross_wo=di((h, hd, d), h * hd),
                             cross_norm=zeros((d,)))
    p["ffn_norm"] = zeros((d,))
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


# the recurrent mixers' leaves: the JAX package's names, shapes and dtypes
# (its ``_init_rglru``, ``_init_mlstm``, ``_init_slstm``); ``di(shape,
# fan_in[, dtype])`` draws a fan-in init in the model's dtype by default

def _init_rglru(cfg: ModelConfig, di, device):
    d, w, f32 = cfg.d_model, cfg.lru_width or cfg.d_model, torch.float32

    def z():
        return torch.zeros((w,), dtype=f32, device=device)
    return {"wx": di((d, w), d), "wgate": di((d, w), d),
            "conv_w": di((cfg.conv1d_width, w), cfg.conv1d_width, f32),
            "conv_b": z(), "rg_wa": di((w, w), w, f32), "rg_ba": z(),
            "rg_wx": di((w, w), w, f32), "rg_bx": z(),
            # recurrence a^c in (0.9, 0.999): lam = softplus^-1(-log a)
            "lam": torch.full((w,), 0.65, dtype=f32, device=device),
            "wo": di((w, d), w)}


def _init_mlstm(cfg: ModelConfig, di, zeros, device):
    d, nh = cfg.d_model, cfg.num_heads
    e = 2 * d
    hd = e // nh
    b_if = torch.cat([torch.zeros((nh,), device=device),
                      torch.full((nh,), 3.0, device=device)])
    return {"w_up": di((d, 2 * e), d),                   # (u, z gate)
            "wq": di((e, nh, hd), e), "wk": di((e, nh, hd), e),
            "wv": di((e, nh, hd), e),
            "w_if": di((e, 2 * nh), e, torch.float32),
            "b_if": b_if,
            "w_down": di((e, d), e), "out_norm": zeros((e,))}


def _init_slstm(cfg: ModelConfig, di, zeros, device):
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    ff = int(d * 4 / 3 / 64 + 1) * 64
    f32 = torch.float32
    return {"w_zifo": di((d, 4, nh, hd), d),
            "b_zifo": torch.zeros((4, nh, hd), dtype=f32, device=device),
            **{r: di((nh, hd, hd), hd, f32) for r in ("rz", "ri", "rf",
                                                      "ro")},
            "out_norm": zeros((d,)),
            "ffn": {"w1": di((d, ff), d), "w3": di((d, ff), d),
                    "w2": di((ff, d), ff)},
            "ffn_norm": zeros((d,))}


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
    if cfg.encoder is not None:
        params["encoder"] = init_encoder_params(gen, cfg, dev, dtype)
    return params


def init_encoder_params(gen: torch.Generator, cfg: ModelConfig, device,
                        dtype) -> Dict:
    """The encoder tower: ``layers`` (one dict per layer: bidirectional
    attention and a plain gelu MLP) and ``final_norm``; the JAX package's
    leaves, unstacked."""
    e = cfg.encoder
    ed, nh = e.d_model, e.num_heads

    def di(shape, fan_in):
        return dense_init(shape, fan_in, gen, device, dtype)

    def zeros():
        return torch.zeros((ed,), dtype=dtype, device=device)

    layers = [{"pre_norm": zeros(),
               "attn": {"wq": di((ed, nh, ed // nh), ed),
                        "wk": di((ed, nh, ed // nh), ed),
                        "wv": di((ed, nh, ed // nh), ed),
                        "wo": di((nh, ed // nh, ed), ed)},
               "ffn_norm": zeros(),
               "ffn": {"w1": di((ed, e.d_ff), ed),
                       "w2": di((e.d_ff, ed), e.d_ff)}}
              for _ in range(e.num_layers)]
    return {"layers": layers, "final_norm": zeros()}


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

def _state_cache(spec: LayerSpec, cfg: ModelConfig, batch: int, device):
    """A recurrent or xLSTM layer's O(1) state for ``batch`` rows."""
    if spec.mixer == "recurrent":
        return init_rglru_cache(batch, cfg.lru_width or cfg.d_model,
                                cfg.conv1d_width, device=device)
    if spec.mixer == "mlstm":
        e = 2 * cfg.d_model
        return init_mlstm_cache(batch, cfg.num_heads, e // cfg.num_heads,
                                device=device)
    return init_slstm_cache(batch, cfg.num_heads,
                            cfg.d_model // cfg.num_heads, device=device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> Dict:
    """Contiguous caches of ``max_len`` slots per row; a local layer's is a
    ring of ``min(window_size, max_len)`` slots (slot = position mod its
    length); a recurrent or xLSTM layer's is its state."""
    def one(spec: LayerSpec):
        if spec.mixer in ("global", "local"):
            c = init_attn_cache(
                batch, min(cfg.window_size, max_len)
                if spec.mixer == "local" else max_len, cfg.num_kv_heads,
                cfg.head_dim, dtype, kv_bits=cfg.kv_bits, device=device)
            if spec.cross:
                # the encoder's keys and values, written at prefill
                shape = (batch, cfg.encoder.source_len, cfg.num_heads,
                         cfg.head_dim)
                c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
                c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
            return c
        return _state_cache(spec, cfg, batch, device)

    return {"layers": [one(spec) for spec in layer_specs(cfg)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_caches(cfg: ModelConfig, num_slots: int, num_pages: int,
                      page_size: int, max_blocks: int,
                      dtype=torch.bfloat16, device=None) -> Dict:
    """Slotted serve caches with paged global-attention layers: each
    global layer owns a (num_pages, page_size, ...) pool and a (num_slots,
    max_blocks) block table, all of them sharing one page-id space, so the
    host allocator hands out one page list per request.  Local rings of
    ``min(window_size, max_blocks * page_size)`` slots and recurrent /
    xLSTM states are window-bounded or O(1) already and stay slot-indexed
    beside the pools (the JAX package's mixed plans)."""
    def one(spec: LayerSpec):
        if spec.cross:
            raise NotImplementedError("paged cache with cross-attention")
        if spec.mixer == "global":
            return init_paged_attn_cache(
                num_slots, num_pages, page_size, max_blocks,
                cfg.num_kv_heads, cfg.head_dim, dtype, kv_bits=cfg.kv_bits,
                device=device)
        if spec.mixer == "local":
            return init_attn_cache(
                num_slots, min(cfg.window_size, max_blocks * page_size),
                cfg.num_kv_heads, cfg.head_dim, dtype, kv_bits=cfg.kv_bits,
                device=device)
        return _state_cache(spec, cfg, num_slots, device)

    return {"layers": [one(spec) for spec in layer_specs(cfg)],
            "pos": torch.zeros((num_slots,), dtype=torch.int32,
                               device=device)}


def reset_caches(caches: Dict) -> Dict:
    """Put caches (contiguous or paged, states included) back to their
    ``init_caches`` / ``init_paged_caches`` state in place, so the tensors
    a captured decode graph reads stay the same ones."""
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
    """Paged twin of ``cache_claim_slot``, in place: each paged layer maps
    ``pages`` into its block-table row and writes the request's
    contiguous prefilled chunks into the pages ``write_mask`` marks as
    this claim's (``kvcache.paged_claim``); a ring or a state (the same
    length in the request's cache) claims its slot row as before.
    Returns ``caches``."""
    for c, r in zip(caches["layers"], req_caches["layers"]):
        if is_paged(c):
            paged_claim(c, r, slot, pages, write_mask)
        else:
            claim_slot(c, r, slot)
    caches["pos"][slot].copy_(req_caches["pos"][0])
    return caches


def cache_reset_slot_paged(cfg: ModelConfig, caches: Dict, slot: int
                           ) -> Dict:
    """Paged twin of ``cache_reset_slot``, in place: each paged layer only
    unmaps the slot's block-table row (page contents are rewritten on the
    next claim), a ring or a state clears its row, and the slot's
    position returns to 0."""
    for c in caches["layers"]:
        if is_paged(c):
            paged_reset(c, slot)
        else:
            reset_slot(c, slot)
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
    ``pos`` plane is left alone, and a recurrent state has no position
    plane (only all-global plans are padded)."""
    lim = plen.to(torch.int32)[:, None]
    for c in caches["layers"]:
        if "pos" in c and not is_paged(c):
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

def _rope(q, k, cfg: ModelConfig, mixer: str, positions, mrope_pos):
    """RoPE of the config's kind; an mrope config without (3, B, S)
    ``mrope_pos`` (the text path) rotates by ``positions`` in 1-D."""
    if cfg.rope_kind == "none":
        return q, k
    theta = (cfg.rope_local_theta if mixer == "local"
             and cfg.rope_local_theta else cfg.rope_theta)
    if cfg.rope_kind == "mrope" and mrope_pos is not None:
        return (apply_mrope(q, mrope_pos, theta),
                apply_mrope(k, mrope_pos, theta))
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def _attn_layer(x, ap, cfg: ModelConfig, ctx: ExecContext, spec: LayerSpec,
                positions, cache, mrope_pos=None, enc_out=None):
    window = cfg.window_size if spec.mixer == "local" else None
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"])
    if "bq" in ap:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q, k = _rope(q, k, cfg, spec.mixer, positions, mrope_pos)
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
    y = torch.einsum("bshk,hkd->bsd", out, ap["wo"])
    if spec.cross:
        y = y + _cross_attn(x + y, ap, cfg, ctx, positions, cache, enc_out)
    return y


def _cross_attn(x, ap, cfg: ModelConfig, ctx: ExecContext, positions, cache,
                enc_out):
    """Decoder cross-attention over the encoder's output: its keys and
    values are projected from ``enc_out`` (and written into the cache at
    prefill) or read from the cache in decode.  Plain attention in every
    mode, as the JAX package computes it."""
    xc = rms_norm(x, ap["cross_norm"], cfg.norm_eps)
    qc = torch.einsum("bsd,dhk->bshk", xc, ap["cross_wq"])
    if ctx.mode == "step":
        ck, cv = cache["cross_k"], cache["cross_v"]
    else:
        ck = torch.einsum("bsd,dhk->bshk", enc_out, ap["cross_wk"])
        cv = torch.einsum("bsd,dhk->bshk", enc_out, ap["cross_wv"])
        if ctx.mode == "prefill" and cache is not None:
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
    b, src = ck.shape[0], ck.shape[1]
    src_pos = torch.arange(src, device=ck.device).expand(b, src)
    co = attention(qc, ck, cv, torch.zeros_like(positions) + src, src_pos,
                   causal=False)
    return torch.einsum("bshk,hkd->bsd", co, ap["cross_wo"])


def _keep_state(cache, new_state, ctx: ExecContext) -> None:
    """Write a recurrent mixer's new state into its cache in place (the
    tensors a captured decode graph reads stay the same ones)."""
    if cache is not None and ctx.mode in ("prefill", "step"):
        for name, t in new_state.items():
            cache[name].copy_(t)


def _recurrent(x, rp, ctx: ExecContext, cache):
    """The RG-LRU block on the normed input; the state carries in from
    the cache at prefill and decode."""
    if ctx.mode == "step":
        y, new_state = rglru_step(x, rp, cache)
    else:
        carry = ctx.mode == "prefill" and cache is not None
        y, new_state = rglru_seq(x, rp, h0=cache["h"] if carry else None,
                                 conv_state=cache["conv"] if carry
                                 else None)
    _keep_state(cache, new_state, ctx)
    return y


def _mlstm_block(x, p, cfg: ModelConfig, ctx: ExecContext, cache):
    mp = p["mlstm"]
    h_in = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    u, z = torch.chunk(torch.einsum("bsd,de->bse", h_in, mp["w_up"]), 2,
                       dim=-1)
    q = torch.einsum("bse,ehk->bshk", u, mp["wq"])
    k = torch.einsum("bse,ehk->bshk", u, mp["wk"])
    v = torch.einsum("bse,ehk->bshk", u, mp["wv"])
    gates = torch.einsum("bse,eg->bsg", u.float(), mp["w_if"]) + mp["b_if"]
    nh = cfg.num_heads
    log_i = gates[..., :nh]
    log_f = torch.nn.functional.logsigmoid(gates[..., nh:])
    if ctx.mode == "step":
        h, new_state = mlstm_step(q, k, v, log_i, log_f, cache)
    else:
        h, new_state = mlstm_chunkwise(
            q, k, v, log_i, log_f,
            cache if ctx.mode == "prefill" else None)
    _keep_state(cache, new_state, ctx)
    b, s = x.shape[0], x.shape[1]
    h = rms_norm(h.reshape(b, s, -1), mp["out_norm"], cfg.norm_eps) \
        * silu(z)
    return x + torch.einsum("bse,ed->bsd", h, mp["w_down"])


def _slstm_block(x, p, cfg: ModelConfig, ctx: ExecContext, cache):
    sp = p["slstm"]
    h_in = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    pre = torch.einsum("bsd,dghk->bsghk", h_in, sp["w_zifo"]) + sp["b_zifo"]
    state = cache if ctx.mode in ("prefill", "step") else None
    h, new_state = slstm_seq(pre, sp, state)
    _keep_state(cache, new_state, ctx)
    b, s = x.shape[0], x.shape[1]
    x = x + rms_norm(h.reshape(b, s, -1), sp["out_norm"], cfg.norm_eps)
    # the block's own gated FFN, uncompressed
    hf = rms_norm(x, sp["ffn_norm"], cfg.norm_eps)
    return x + ffn_apply(hf, sp["ffn"], cfg.act, True)


def apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, ctx: ExecContext,
                positions, cache, plan_row=None, mrope_pos=None,
                enc_out=None):
    """One transformer layer.  Returns (x, aux, routing info, MoE input);
    a dense, recurrent or xLSTM layer gives no aux, no routing info and no
    MoE input.  The MoE input is the (T, d) f32 normed FFN input when
    ``ctx.collect_moe_inputs`` is set, else None.  A recurrent or xLSTM
    layer writes its new state into ``cache`` in place."""
    if spec.mixer == "mlstm":
        return _mlstm_block(x, p, cfg, ctx, cache), {}, None, None
    if spec.mixer == "slstm":
        return _slstm_block(x, p, cfg, ctx, cache), {}, None, None
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if spec.mixer == "recurrent":
        y = _recurrent(h, p["rglru"], ctx, cache)
    else:
        y = _attn_layer(h, p["attn"], cfg, ctx, spec, positions, cache,
                        mrope_pos, enc_out)
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
    if ctx.moe_ep_fn is not None and ctx.ep_mode != "none":
        # the experts of this rank's slice; the plan row is data that
        # every rank applies alike
        y, aux, info = ctx.moe_ep_fn(h, mp, cfg, ctx, plan_row)
    else:
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


def _remat(fn, ctx: ExecContext):
    """``fn`` recomputed in the backward pass when ``ctx.remat`` (the
    activations inside it are not kept)."""
    if not ctx.remat:
        return fn
    if ctx.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy {ctx.remat_policy!r} is not ported yet: ROADMAP "
            f"A15 (tooling: only the dry run asks for it)")

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return run


def apply_stack(params, x, cfg: ModelConfig, ctx: ExecContext, positions,
                caches=None, plan=None, mrope_pos=None, enc_out=None):
    """Run every layer.  Returns (x, aux, caches, trace, probs,
    moe_inputs); with caches, their per-row decode position
    ``caches["pos"]`` advances in place past the last of ``positions``.

    ``trace`` is the stacked (moe_layers, T, k) int32 router top-k ids in
    layer order and ``probs`` the (moe_layers, T, E) router
    probabilities, both when ``ctx.collect_trace`` is set and the model
    has an MoE layer (else None).  ``moe_inputs`` is the stacked
    (moe_layers, T, d) f32 normed MoE-FFN inputs in the same order when
    ``ctx.collect_moe_inputs`` is set (the calibration pass).
    ``plan``: optional (moe_layers, 2) [top_n, rank_cap] rows;
    ``mrope_pos``: (3, B, S) M-RoPE positions; ``enc_out``: the encoder's
    output that cross-attention reads (prefill and train)."""
    use_cache = caches is not None and ctx.mode in ("prefill", "step")
    layer_fn = _remat(apply_layer, ctx)
    aux = {"load_balance": 0.0, "router_z": 0.0}
    infos: List[RoutingInfo] = []
    moe_ins: List[torch.Tensor] = []
    for li, (lp, spec) in enumerate(zip(params["layers"], layer_specs(cfg))):
        x, a, info, moe_in = layer_fn(
            x, lp, spec, cfg, ctx, positions,
            caches["layers"][li] if use_cache else None,
            plan_row=None if plan is None or spec.ffn != "moe"
            else plan[len(infos)], mrope_pos=mrope_pos, enc_out=enc_out)
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


def apply_encoder(params, embeds, cfg: ModelConfig, ctx: ExecContext):
    """Whisper-style bidirectional encoder over stub frame embeddings
    (B, source_len, d_enc); returns its final-normed output."""
    ep = params["encoder"]
    dtype = ep["layers"][0]["ffn"]["w1"].dtype
    x = embeds.to(dtype)
    b, src = x.shape[0], x.shape[1]
    pos = torch.arange(src, device=x.device).expand(b, src)
    for lp in ep["layers"]:
        ap = lp["attn"]
        h = rms_norm(x, lp["pre_norm"], cfg.norm_eps)
        q = torch.einsum("bsd,dhk->bshk", h, ap["wq"])
        k = torch.einsum("bsd,dhk->bshk", h, ap["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, ap["wv"])
        o = attention(q, k, v, pos, pos, causal=False)
        x = x + torch.einsum("bshk,hkd->bsd", o, ap["wo"])
        h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
        x = (x + ffn_apply(h, lp["ffn"], "gelu", False)).to(dtype)
    return rms_norm(x, ep["final_norm"], cfg.norm_eps)

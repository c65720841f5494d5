"""PyTorch port vs the JAX package on the sliding-window and QKV-bias part
of the model zoo at ``reduce_config`` sizes: Gemma3-1B and Gemma3-27B
(5 local : 1 global layers, window 16 here, ring caches, a local RoPE
theta, post-attention and post-FFN norms, gelu_tanh, scaled tied
embeddings), Qwen2-7B (QKV biases, set to seeded nonzero values: JAX
initialises them to zeros), and the MoE configs Mixtral-8x22B and
Llama-4-Scout (top-1 with a shared expert, unnormalised gates).

Dense models serve E = 1 quantize-then-compensate stacks built by the
JAX pipeline (as in ``test_torch_dense_model.py``), MoE models their
initialised experts; both cross through ``params_from_jax``.  Prompts
are longer than the window, so every ring wraps at prefill or in decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import compress_ffn_weights as j_compress_ffn
from repro.models import ExecContext as JCtx
from repro.models.kvcache import init_attn_cache as j_init_attn_cache
from repro.models.layers import activation as j_activation
from repro.models.model import embed_tokens as j_embed_tokens
from repro.models.transformer import LayerSpec as JLayerSpec
from repro.models.transformer import apply_layer as j_apply_layer
from repro.models.transformer import derive_plan as j_derive_plan
from repro.models.transformer import init_layer as j_init_layer
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import layer_specs as j_layer_specs
from repro.models.transformer import unstack_params as j_unstack
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax, tree_to_torch
from repro_torch.models.kvcache import init_attn_cache
from repro_torch.models.layers import activation
from repro_torch.models.model import embed_tokens
from repro_torch.models.transformer import (ExecContext, LayerSpec,
                                            apply_layer, init_caches,
                                            init_paged_caches, init_params,
                                            layer_specs)
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine, _graph_key
from repro_torch.serve.scheduler import Request

# f32 on both sides, sums in another order (test_torch_model.py's limit)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# one local layer alone, f32: no quantized matmul in between
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: two bf16 steps of a log-prob (test_torch_moe_zoo.py's limit), and
# a greedy choice is a near-tie when the other engine's token is within
# the same two steps of the argmax
BF16_TOL = dict(rtol=0.0, atol=0.0625)
TIE = 0.0625
NEW = 24
_CACHE = {}


def _bias(tree, seed: int):
    """``tree`` with every ``bq`` / ``bk`` / ``bv`` leaf replaced by seeded
    normal values of its shape and dtype."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
            return jnp.asarray(rng.standard_normal(leaf.shape) * 0.5,
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, tree)


def _jax_model(arch: str, dtype: str = "float32"):
    """(JAX cfg, params, quantized) of the reduced model, built once per
    process: a dense model's FFNs as E = 1 stacks at rank budget 16 (the
    reduced budget of 8 allocates rank 0 at E = 1); an MoE model's
    experts as initialised (their compressed path is the one
    ``test_torch_moe_zoo.py`` holds, and JAX's compression of them costs
    more than the rest of this file).  The bf16 model is the f32 one
    with every leaf outside the stacks cast to bf16 (the stacks' formats
    do not depend on the weights' dtype), which spares a second
    compression."""
    key = (arch, dtype)
    if key in _CACHE:
        return _CACHE[key]
    if dtype == "bfloat16":
        jcfg, jq, quantized = _jax_model(arch)

        def bf16(tree):
            return jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
        segs = tuple((dict(bf16({k: v for k, v in lp.items() if k != "ffn"}),
                           ffn=lp["ffn"]),) for (lp,) in jq["segments"])
        _CACHE[key] = (jcfg, dict(bf16({k: v for k, v in jq.items()
                                        if k != "segments"}),
                                  segments=segs), quantized)
        return _CACHE[key]
    if key not in _CACHE:
        jcfg = j_get_config(arch, reduced=True)
        jp = _bias(j_init_params(jax.random.key(3), jcfg, jnp.float32), 11)
        if jcfg.moe is not None:
            _CACHE[key] = (jcfg, jp, False)
            return _CACHE[key]
        qcfg = dataclasses.replace(jcfg.quant, rank_budget=16)
        up = j_unstack(jp, jcfg)
        segs = []
        for (lp,) in up["segments"]:
            f = lp["ffn"]
            stacks, _ = j_compress_ffn(f["w1"][None], f["w2"][None],
                                       f["w3"][None], qcfg)
            segs.append((dict(lp, ffn={"stacks": stacks}),))
        jq = dict(up, segments=tuple(segs))
        _CACHE[key] = (dataclasses.replace(jcfg, force_unroll_plan=True),
                       jq, True)
    return _CACHE[key]


def _port_engine(arch: str, dtype: str = "float32", impl: str = "auto"):
    jcfg, jparams, quantized = _jax_model(arch, dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              force_unroll_plan=jcfg.force_unroll_plan)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return ServeEngine(cfg, params, quantized=quantized, kernel_impl=impl,
                       device="cpu")


def _prompts():
    # 21 tokens: past the reduced window of 16, so the rings wrap at
    # prefill
    return np.random.default_rng(6).integers(2, 512, (2, 21)) \
        .astype(np.int32)


def _jax_generate(arch: str, dtype: str = "float32"):
    key = ("run", arch, dtype)
    if key not in _CACHE:
        jcfg, jparams, quantized = _jax_model(arch, dtype)
        _CACHE[key] = JServeEngine(jcfg, jparams, quantized=quantized,
                                   kernel_impl="ref").generate(_prompts(),
                                                               NEW)
    return _CACHE[key]


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma3-27b"])
def test_gemma3_layer_specs_match_jax(arch):
    """5 local : 1 global at published depth (62 = 10 periods + 2 local
    layers for 27B) and reduced, equal to JAX's plan layer for layer."""
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), j_get_config(arch, reduced)
        specs = layer_specs(cfg)
        assert [(s.mixer, s.ffn) for s in specs] == \
            [(s.mixer, s.ffn) for s in j_layer_specs(jcfg)]
        assert [s.mixer for s in specs[:6]] == ["local"] * 5 + ["global"]
    assert sum(s.mixer == "global" for s in
               layer_specs(get_config(arch))) == {"gemma3-1b": 4,
                                                  "gemma3-27b": 10}[arch]


def test_bridge_maps_gemma3_periods_layer_for_layer():
    """A 14-layer Gemma3 (two scanned 5 + 1 periods and a 2-layer local
    remainder, narrow widths) crosses the bridge in layer order: each
    port layer equals the JAX package's unrolled layer of that index,
    post-norms included."""
    jcfg = dataclasses.replace(j_get_config("gemma3-1b", reduced=True),
                               num_layers=14)
    jp = j_init_params(jax.random.key(2), jcfg, jnp.float32)
    assert [seg[1] for seg in j_derive_plan(jcfg)] == [2, 2]
    flat = jax.tree.map(np.asarray, j_unstack(jp, jcfg))["segments"]
    layers = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")["layers"]
    assert len(layers) == len(flat) == 14
    for lp, (jlp,) in zip(layers, flat):
        assert set(lp) == set(jlp) >= {"post_norm", "post_ffn_norm"}
        for name in ("wq", "wk", "wo"):
            np.testing.assert_array_equal(lp["attn"][name].numpy(),
                                          jlp["attn"][name])
        np.testing.assert_array_equal(lp["ffn"]["w2"].numpy(),
                                      jlp["ffn"]["w2"])


def test_local_layer_ring_matches_jax():
    """One local layer of reduced Gemma3-1B (QKV biases switched on, so
    they ride along too), dense FFN: a 20-token prefill into a ring of
    window 16 (it wraps at prefill), then 24 decode steps: every output
    and the ring's pos, K and V planes within 1e-5 of JAX's."""
    jcfg = dataclasses.replace(j_get_config("gemma3-1b", reduced=True),
                               qkv_bias=True)
    cfg = dataclasses.replace(get_config("gemma3-1b", reduced=True),
                              qkv_bias=True)
    jp = _bias(j_init_layer(jax.random.key(5), JLayerSpec("local", "dense"),
                            jcfg, jnp.float32), 12)
    tp = tree_to_torch(jax.tree.map(np.asarray, jp), "cpu")
    assert {"post_norm", "post_ffn_norm"} <= set(tp)
    assert set(tp["attn"]) >= {"bq", "bk", "bv"}
    b, s0, w = 2, 20, cfg.window_size
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    jc = j_init_attn_cache(b, w, kv, hd, jnp.float32)
    tc = init_attn_cache(b, w, kv, hd, torch.float32, device="cpu")
    x = np.random.default_rng(8).standard_normal(
        (b, s0 + NEW, cfg.d_model)).astype(np.float32)
    spec = LayerSpec("local", "dense")
    jfn = {mode: jax.jit(lambda x, p, pos, c, mode=mode: j_apply_layer(
        x, p, JLayerSpec("local", "dense"), jcfg, JCtx(mode=mode), pos,
        c)) for mode in ("prefill", "step")}
    for t0, t1, mode in [(0, s0, "prefill")] + [
            (t, t + 1, "step") for t in range(s0, s0 + NEW)]:
        pos = np.broadcast_to(np.arange(t0, t1, dtype=np.int32),
                              (b, t1 - t0))
        jy, _, jc, _, _ = jfn[mode](jnp.asarray(x[:, t0:t1]), jp,
                                    jnp.asarray(pos), jc)
        ty, _, _, _ = apply_layer(
            torch.from_numpy(x[:, t0:t1]), tp, spec, cfg,
            ExecContext(mode=mode), torch.from_numpy(pos.copy()), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), **LAYER_TOL)
    # the ring holds the last 16 positions, each at its position mod 16
    last = s0 + NEW - 1
    np.testing.assert_array_equal(
        np.sort(tc["pos"].numpy(), axis=1),
        np.broadcast_to(np.arange(last - w + 1, last + 1), (b, w)))


@pytest.mark.parametrize("arch,dtype", [
    ("gemma3-1b", "float32"), ("gemma3-1b", "bfloat16"),
    ("qwen2-7b", "float32")])
def test_greedy_generate_matches_jax(arch, dtype):
    """Greedy ``generate`` (21-token prompts, 24 new: the rings wrap at
    prefill and again in decode) on the JAX pipeline's E = 1 stacks
    (Gemma3-27B's reduced config differs from Gemma3-1B's only in its
    head counts, which the serve and layer tests do not need).  In
    f32 the tokens equal JAX's and the log-probs agree within 1e-4.  In
    bf16 the port also reads JAX's tokens (teacher-forced): log-probs
    within two bf16 steps and each JAX token the port's argmax or within
    TIE of it; its own tokens equal JAX's up to a row's first difference,
    which must be such a near-tie."""
    want = _jax_generate(arch, dtype)
    eng = _port_engine(arch, dtype)
    assert eng.params["embed"]["tok"].dtype == getattr(torch, dtype)
    res = eng.generate(_prompts(), NEW)
    assert res.router_trace is None
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens, want.tokens)
        np.testing.assert_allclose(res.logprobs, want.logprobs, **F32_TOL)
        return
    logits, caches = eng.prefill(_prompts(), NEW)
    lps, gaps = [], []
    for s in range(NEW):
        tok = torch.from_numpy(want.tokens[:, s].copy())
        lf = logits.float()
        lps.append(torch.log_softmax(lf, -1).gather(
            1, tok.long()[:, None])[:, 0].numpy())
        gaps.append((lf.max(-1).values - lf.gather(
            1, tok.long()[:, None])[:, 0]).numpy())
        out = eng.step(tok, caches)
        logits, caches = out.logits, out.caches
    lps, gaps = np.stack(lps, 1), np.stack(gaps, 1)
    np.testing.assert_allclose(lps, want.logprobs, **BF16_TOL)
    assert gaps.max() <= TIE, gaps
    for r in range(res.tokens.shape[0]):
        diff = np.nonzero(res.tokens[r] != want.tokens[r])[0]
        d = int(diff[0]) if diff.size else NEW
        np.testing.assert_array_equal(res.logprobs[r, :d], lps[r, :d])
        if d < NEW:
            assert gaps[r, d] > 0, (r, d)


def test_gemma3_serve_matches_jax_serve():
    """Reduced Gemma3-1B ``serve``: 5 requests with prompts of 11 and 27
    tokens (both sides of the window of 16; each prefilled at its exact
    length), 2 slots, chunks of 4, 10 new: tokens and log-probs equal
    JAX's ``serve``; the slot caches' local layers are rings of 16."""
    lens = (11, 27, 27, 11, 27)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, 512, (n,)).astype(np.int32) for n in lens]
    jcfg_q, jq, _ = _jax_model("gemma3-1b")
    want = JServeEngine(jcfg_q, jq, quantized=True, kernel_impl="ref").serve(
        [JRequest(uid=i, tokens=p, max_new=10) for i, p in
         enumerate(prompts)], num_slots=2, chunk=4, seed=0)
    eng = _port_engine("gemma3-1b")
    got = eng.serve([Request(uid=i, tokens=p, max_new=10)
                     for i, p in enumerate(prompts)],
                    num_slots=2, chunk=4, seed=0)
    assert [r.uid for r in got.results] == [r.uid for r in want.results]
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, **F32_TOL)
    assert got.prefill_tokens == want.prefill_tokens == sum(lens)
    slot_caches = next(c for (bsz, _), c in eng._caches.items() if bsz == 2)
    lengths = [c["k"].shape[1] for c in slot_caches["layers"]]
    assert lengths == [16] * 5 + [64]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-a16e"])
def test_moe_configs_generate_matches_jax(arch):
    """Reduced Mixtral-8x22B (top-2 of 8, normalised gates) and
    Llama-4-Scout (top-1 of 8 here, a shared expert, unnormalised gates):
    greedy tokens and router traces equal JAX's, log-probs within
    1e-4."""
    want = _jax_generate(arch)
    res = _port_engine(arch).generate(_prompts(), NEW)
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_array_equal(res.router_trace, want.router_trace)
    np.testing.assert_allclose(res.logprobs, want.logprobs, **F32_TOL)


def test_local_plan_raises_for_speculation_and_paging():
    """Speculation on a plan with ring layers raises JAX's ``ValueError``
    (a ring cannot roll back a rejected draft); paging raises
    ``NotImplementedError`` naming ROADMAP A12, from ``serve`` and from
    ``init_paged_caches``.  An all-global plan pages as before."""
    cfg = get_config("gemma3-1b", reduced=True)
    eng = ServeEngine(cfg, init_params(cfg, 0, torch.float32, "cpu"),
                      device="cpu")
    reqs = [Request(uid=0, tokens=np.arange(2, 22, dtype=np.int32),
                    max_new=4)]
    with pytest.raises(ValueError, match="local-ring states cannot roll"):
        eng.serve(reqs, spec_k=2, drafter="ngram")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        eng.serve(reqs, page_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        init_paged_caches(cfg, 2, 9, 16, 4, torch.float32, device="cpu")
    glob = dataclasses.replace(cfg, block_pattern=("global",))
    c = init_paged_caches(glob, 2, 9, 16, 4, torch.float32, device="cpu")
    assert len(c["layers"]) == glob.num_layers


def test_graph_key_tells_ring_buckets_apart():
    """Two cache buckets whose local rings are both capped at the window
    still get their own decode-graph keys (the global layers' lengths
    differ)."""
    cfg = get_config("gemma3-1b", reduced=True)
    a = init_caches(cfg, 2, 64, torch.float32, device="cpu")
    b = init_caches(cfg, 2, 128, torch.float32, device="cpu")
    assert a["layers"][0]["k"].shape[1] == b["layers"][0]["k"].shape[1] == 16
    assert _graph_key(a, None) == (2, 64, False)
    assert _graph_key(b, None) == (2, 128, False)


def test_bf16_gelu_tanh_and_embed_scale_round_as_jax():
    """In bf16 the port's gelu_tanh and Gemma's sqrt(d) embedding scale
    round as JAX's do: bit for bit on 100k values (``F.gelu`` and a
    multiply by the unrounded sqrt(1152) differ from JAX in ~40% and
    ~33% of them)."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(
        np.float32) * 3
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax.jit(j_activation("gelu_tanh"))(xj)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(
        activation("gelu_tanh")(xt).float().numpy(), want)
    np.testing.assert_allclose(
        activation("gelu_tanh")(torch.from_numpy(x)).numpy(),
        np.asarray(j_activation("gelu_tanh")(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    cfg, jcfg = get_config("gemma3-1b"), j_get_config("gemma3-1b")
    table = (np.random.default_rng(1).standard_normal((1000, 16)) * 0.02) \
        .astype(np.float32)
    toks = np.arange(1000, dtype=np.int32)
    want = jax.jit(lambda t: j_embed_tokens(
        {"embed": {"tok": jnp.asarray(table).astype(jnp.bfloat16)}}, t,
        jcfg))(jnp.asarray(toks))
    got = embed_tokens({"embed": {"tok": torch.from_numpy(table).to(
        torch.bfloat16)}}, torch.from_numpy(toks), cfg)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))

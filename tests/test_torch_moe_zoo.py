"""PyTorch port vs the JAX package on the rest of the main-path MoE zoo
at ``reduce_config`` sizes: DeepSeek-MoE-16B (a dense layer 0, shared
experts, unnormalised top-k gates), a 16-expert top-6 top-n-3 variant of
it (many small experts), and Qwen3-MoE-30B-A3B.

Both sides serve JAX-compressed parameters carried across by
``params_from_jax``: greedy ``ServeEngine.generate`` must give identical
tokens and router traces, and log-probs within the dtype's limit; prefill
and decode-step logits must agree; the port's own init and compression
must keep the JAX package's layout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ExecContext as JCtx
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params as j_compress
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.models.model import decode_step, forward
from repro_torch.models.transformer import (ExecContext, init_caches,
                                            init_params, layer_specs)
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

# f32 on both sides: sums in another order (the limit of test_torch_model.py)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: two bf16 steps of a log-prob of magnitude 4..8, with no relative
# part (the limit of tests/test_torch_engine.py)
BF16_TOL = dict(rtol=0.0, atol=0.0625)
# a greedy choice in bf16 is a near-tie when the other engine's token has
# a logit within this of the argmax: the same two bf16 steps.  The two
# engines' logits differ by a step or two in ~1% of elements (matmul sums
# in another order), and the reduced models' logits over 512 tokens sit
# within a step of each other often enough that such ties occur
TIE = 0.0625
# router choices in bf16 may differ only between experts whose router
# probabilities are within this share of the larger one (chip_smoke.py's
# NEAR_TIE_BF16): top-6 of 16 meets pairs 0.1-0.9% apart, which bf16
# steps of the router input swap
NEAR_TIE_BF16 = 0.1

# variant -> (arch, (num_experts, top_k) override or None)
_MODELS = {"deepseek": ("deepseek-moe-16b", None),
           "deepseek-16e-top6": ("deepseek-moe-16b", (16, 6)),
           "qwen3": ("qwen3-moe-30b-a3b", None)}
_CACHE = {}


def _cfg(get, variant: str):
    arch, over = _MODELS[variant]
    cfg = get(arch, reduced=True)
    if over is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=over[0], top_k=over[1]))
    return cfg


def _jax_compressed(variant: str, dtype: str):
    """(JAX compressed params, JAX cfg_q) for the reduced model,
    initialised and compressed in ``dtype``, built once per process."""
    key = ("jq", variant, dtype)
    if key not in _CACHE:
        jcfg = _cfg(j_get_config, variant)
        jp = j_init_params(jax.random.key(4), jcfg, getattr(jnp, dtype))
        jq, jcfg_q, _ = j_compress(jp, jcfg)
        _CACHE[key] = (jp, jq, jcfg_q)
    return _CACHE[key]


def _prompts():
    return np.random.default_rng(6).integers(2, 512, (2, 11)) \
        .astype(np.int32)


def _jax_run(variant: str, dtype: str):
    key = ("run", variant, dtype)
    if key not in _CACHE:
        _, jq, jcfg_q = _jax_compressed(variant, dtype)
        _CACHE[key] = JServeEngine(jcfg_q, jq, quantized=True,
                                   kernel_impl="ref").generate(_prompts(), 8)
    return _CACHE[key]


def _port_params(variant: str, dtype: str, compressed: bool = True):
    jp, jq, _ = _jax_compressed(variant, dtype)
    cfg = dataclasses.replace(_cfg(get_config, variant),
                              force_unroll_plan=compressed)
    tree = jq if compressed else jp
    return cfg, params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


_CASES = [("deepseek", "float32"), ("deepseek", "bfloat16"),
          ("deepseek-16e-top6", "float32"), ("deepseek-16e-top6", "bfloat16"),
          ("qwen3", "float32")]


def _teacher_forced(eng, prompts, tokens):
    """The port engine prefills ``prompts`` and then reads ``tokens``
    (B, steps) step by step.  Returns (log-probs of ``tokens`` (B, steps),
    the port's max logit less its logit of ``tokens`` (B, steps), the
    router trace (steps, moe_layers, B, k), the router probabilities
    (steps, moe_layers, B, E))."""
    logits, caches = eng.prefill(prompts, tokens.shape[1])
    lps, gaps, trace, probs = [], [], [], []
    for s in range(tokens.shape[1]):
        tok = torch.from_numpy(tokens[:, s].copy())
        lf = logits.float()
        mine = lf.gather(1, tok.long()[:, None])[:, 0]
        lps.append(torch.log_softmax(lf, -1).gather(
            1, tok.long()[:, None])[:, 0].numpy())
        gaps.append((lf.max(-1).values - mine).numpy())
        out = eng.step(tok, caches)
        logits, caches = out.logits, out.caches
        trace.append(out.trace.numpy())
        probs.append(out.router_probs.numpy())
    return (np.stack(lps, 1), np.stack(gaps, 1), np.stack(trace),
            np.stack(probs))


def _assert_trace_near_ties(trace, want, probs):
    """``trace`` equals ``want`` but where, at a differing top-k position,
    the two experts' router probabilities are within NEAR_TIE_BF16 of the
    larger."""
    for idx in zip(*np.nonzero(trace != want)):
        p = probs[idx[:3]]
        a, b = trace[idx], want[idx]
        assert abs(float(p[a] - p[b])) <= NEAR_TIE_BF16 * max(p[a], p[b]), \
            (idx, a, b, p[a], p[b])


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("variant,dtype", _CASES)
def test_greedy_generate_matches_jax(variant, dtype, impl):
    """Greedy tokens and router trace identical to the JAX engine's,
    log-probs within the dtype's limit.

    In bf16 the port also reads the JAX engine's tokens (teacher-forced):
    its router trace must equal the JAX trace at every step outside router
    near-ties, its log-probs of those tokens be within the limit, and each
    JAX token be its argmax or within TIE of it.  Its own greedy tokens
    must then equal the JAX tokens, with the teacher-forced trace and
    log-probs, up to a row's first difference, and that difference must
    be such a near-tie."""
    want = _jax_run(variant, dtype)
    cfg, params = _port_params(variant, dtype)
    assert params["embed"]["tok"].dtype == getattr(torch, dtype)
    eng = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu")
    res = eng.generate(_prompts(), 8)
    n_moe = sum(s.ffn == "moe" for s in layer_specs(cfg))
    assert res.router_trace.shape == (8, n_moe, 2, cfg.moe.top_k)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens, want.tokens)
        np.testing.assert_array_equal(res.router_trace, want.router_trace)
        np.testing.assert_allclose(res.logprobs, want.logprobs, **F32_TOL)
        return
    lps, gaps, trace, probs = _teacher_forced(eng, _prompts(), want.tokens)
    _assert_trace_near_ties(trace, want.router_trace, probs)
    np.testing.assert_allclose(lps, want.logprobs, **BF16_TOL)
    assert gaps.max() <= TIE, gaps
    for r in range(res.tokens.shape[0]):
        diff = np.nonzero(res.tokens[r] != want.tokens[r])[0]
        d = int(diff[0]) if diff.size else res.tokens.shape[1]
        np.testing.assert_array_equal(res.router_trace[:d, :, r],
                                      trace[:d, :, r])
        np.testing.assert_array_equal(res.logprobs[r, :d], lps[r, :d])
        if d < res.tokens.shape[1]:
            assert gaps[r, d] > 0, (r, d)      # not the port's argmax


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("variant", ["deepseek", "deepseek-16e-top6"])
def test_forward_and_decode_step_match_jax(variant, quantized):
    """Prefill and one decode step of reduced DeepSeek-MoE, dense experts
    and JAX-compressed ones: logits within the f32 limit, router traces
    and cache positions identical."""
    jp, jq, jcfg_q = _jax_compressed(variant, "float32")
    jcfg = jcfg_q if quantized else _cfg(j_get_config, variant)
    jparams = jq if quantized else jp
    cfg, params = _port_params(variant, "float32", compressed=quantized)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    kw = dict(quantized=quantized, exact_capacity=True, collect_trace=True)
    jpre = j_forward(jparams, jnp.asarray(toks[:, :8]), jcfg,
                     JCtx(mode="prefill", kernel_impl="ref", **kw),
                     caches=j_init_caches(jcfg, 2, 16, jnp.float32))
    jstep = j_decode_step(jparams, jnp.asarray(toks[:, 8:]), jpre.caches,
                          jcfg, JCtx(mode="step", kernel_impl="ref", **kw))
    tpre = forward(params, torch.from_numpy(toks[:, :8]), cfg,
                   ExecContext(mode="prefill", kernel_impl="auto", **kw),
                   caches=init_caches(cfg, 2, 16, torch.float32,
                                      device="cpu"))
    tstep = decode_step(params, torch.from_numpy(toks[:, 8:]), tpre.caches,
                        cfg, ExecContext(mode="step", kernel_impl="auto",
                                         **kw))
    for j, t in ((jpre, tpre), (jstep, tstep)):
        np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits),
                                   **F32_TOL)
        np.testing.assert_array_equal(t.trace.numpy(), np.asarray(j.trace))
    np.testing.assert_array_equal(tstep.caches["pos"].numpy(),
                                  np.asarray(jstep.caches["pos"]))


def test_unnormalised_gates_reach_the_output():
    """With ``router_norm_topk=False`` the top-k gates are the raw
    softmax probabilities: rescaling them as the normalised router does
    changes the port's output, so the flag is not ignored."""
    from repro_torch.models.moe import route
    cfg, params = _port_params("deepseek-16e-top6", "float32")
    mp = params["layers"][1]["moe"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (5, cfg.d_model)).astype(np.float32))
    info = route(x, mp["router"], cfg.moe)
    torch.testing.assert_close(info.gates, torch.topk(info.probs, 6).values)
    assert float(info.gates.sum(-1).max()) < 1.0
    norm = route(x, mp["router"], dataclasses.replace(
        cfg.moe, router_norm_topk=True))
    torch.testing.assert_close(norm.gates.sum(-1), torch.ones(5))


def test_init_and_compression_keep_the_jax_layout():
    """The port's ``init_params`` gives reduced DeepSeek-MoE the JAX
    package's shapes (dense layer 0 of width d_ff, shared experts as one
    FFN of width (d_shared or d_expert) x num_shared), and its
    ``compress_moe_params`` compresses the routed experts only: the dense
    layer and the shared experts come out untouched, one stack dict per
    MoE layer."""
    from repro_torch.models.transformer import compress_moe_params
    cfg = get_config("deepseek-moe-16b", reduced=True)
    jp, _, _ = _jax_compressed("deepseek", "float32")
    want = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    got = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(got) == shapes(want)
    assert [s.ffn for s in layer_specs(cfg)] == ["dense", "moe", "moe"]
    assert got["layers"][0]["ffn"]["w1"].shape == (cfg.d_model, cfg.d_ff)
    fs = cfg.moe.d_shared * cfg.moe.num_shared_experts
    assert got["layers"][1]["moe"]["shared"]["w2"].shape == (fs, cfg.d_model)

    qp, cfg_q, stacks = compress_moe_params(got, cfg)
    assert cfg_q.force_unroll_plan and len(stacks) == 2
    assert qp["layers"][0]["ffn"] is got["layers"][0]["ffn"]
    for lp, q, st in zip(got["layers"][1:], qp["layers"][1:], stacks):
        assert set(q["moe"]) == {"router", "shared", "stacks"}
        assert q["moe"]["shared"] is lp["moe"]["shared"]
        assert q["moe"]["stacks"] is st
        assert st["w1"].shape == (cfg.moe.num_experts, cfg.d_model,
                                  cfg.moe.d_expert)
        assert set(lp["moe"]) == {"router", "shared", "w1", "w2", "w3"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_matches_jax(dtype):
    """The port's SiLU against ``jax.nn.silu``: bit for bit in bf16 (both
    round after exp, add, divide and multiply), within an ulp in f32."""
    from repro_torch.models.layers import silu
    x = np.random.default_rng(9).standard_normal(20000).astype(np.float32)
    x = x * 4.0
    want = np.asarray(jax.nn.silu(jnp.asarray(x, getattr(jnp, dtype)))
                      .astype(jnp.float32))
    got = silu(torch.from_numpy(x).to(getattr(torch, dtype))).float()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-7)

"""PyTorch port vs the JAX package: greedy ``ServeEngine.generate`` on
reduced Mixtral-8x7B with JAX-compressed experts is token-identical, and
its router trace and log-probs agree, in f32 with a bf16 or an int8 KV
cache and with bf16 params."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params as j_compress
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import bucket_len as j_bucket_len
from repro_torch.bridge import params_from_jax
from repro_torch.serve.engine import ServeEngine, bucket_len

_CACHE = {}


def _jax_engine_run(prompts, max_new):
    if "run" not in _CACHE:
        jcfg = j_get_config("mixtral-8x7b", reduced=True)
        jp = j_init_params(jax.random.key(3), jcfg, jnp.float32)
        jq, jcfg_q, _ = j_compress(jp, jcfg)
        res = JServeEngine(jcfg_q, jq, quantized=True,
                           kernel_impl="ref").generate(prompts, max_new)
        _CACHE.update(run=res, jq=jq, jcfg_q=jcfg_q)
    return _CACHE


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_greedy_generate_token_identical(impl):
    from repro_torch.registry import get_config
    prompts = np.random.default_rng(5).integers(2, 512, (2, 11)) \
        .astype(np.int32)
    m = _jax_engine_run(prompts, 8)
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                              force_unroll_plan=True)
    params = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    res = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu").generate(prompts, 8)
    want = m["run"]
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_array_equal(res.router_trace, want.router_trace)
    np.testing.assert_allclose(res.logprobs, want.logprobs, rtol=1e-4,
                               atol=1e-4)
    assert res.steps == 8 and res.decode_tokens_per_s > 0


def _jax_bf16_compressed():
    """The reduced model initialised in bf16 (same key) and compressed by
    JAX: the weights differ from the f32 model's by bf16 rounding, so the
    f32 compression cannot be reused for it."""
    if "jq_bf16" not in _CACHE:
        jcfg = j_get_config("mixtral-8x7b", reduced=True)
        jp = j_init_params(jax.random.key(3), jcfg, jnp.bfloat16)
        _CACHE["jq_bf16"], _CACHE["jcfg_q_bf16"], _ = j_compress(jp, jcfg)
    return _CACHE["jq_bf16"], _CACHE["jcfg_q_bf16"]


# variant -> (kv_bits, params dtype, log-prob rtol, atol).  f32 keeps the
# limits of the default case.  In bf16 both engines round activations to 8
# bits of mantissa at different places (the port's plain kernels accumulate
# in f32 and round once; XLA rounds inside its fused ops), and a log-prob
# of magnitude 4..8 (log 512 = 6.2 for the reduced vocabulary) has bf16
# steps of 2^-5: the absolute limit 0.0625 is two of them (0.031 seen on
# this model), with no relative part on top.
_VARIANTS = {"kv8-f32": (8, "float32", 1e-4, 1e-4),
             "kv16-bf16": (16, "bfloat16", 0.0, 0.0625),
             "kv8-bf16": (8, "bfloat16", 0.0, 0.0625)}


@pytest.mark.parametrize("impl", ["auto", "ref"])
@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_greedy_generate_matches_jax_variants(variant, impl):
    """The int8 KV cache, in f32 (on the cached JAX compression) and in
    bf16, and bf16 params with a bf16 cache: tokens and router trace
    identical, log-probs within the variant's limit."""
    from repro_torch.registry import get_config
    kv_bits, dtype, rtol, atol = _VARIANTS[variant]
    prompts = np.random.default_rng(5).integers(2, 512, (2, 11)) \
        .astype(np.int32)
    if dtype == "bfloat16":
        jq, jcfg_q = _jax_bf16_compressed()
    else:
        m = _jax_engine_run(prompts, 8)
        jq, jcfg_q = m["jq"], m["jcfg_q"]
    key = f"run-{variant}"
    if key not in _CACHE:
        _CACHE[key] = JServeEngine(
            dataclasses.replace(jcfg_q, kv_bits=kv_bits), jq,
            quantized=True, kernel_impl="ref").generate(prompts, 8)
    want = _CACHE[key]
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                              force_unroll_plan=True, kv_bits=kv_bits)
    params = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    assert params["embed"]["tok"].dtype == getattr(torch, dtype)
    res = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_array_equal(res.router_trace, want.router_trace)
    np.testing.assert_allclose(res.logprobs, want.logprobs, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n", [1, 16, 17, 33, 300])
def test_bucket_len_matches_jax(n):
    assert bucket_len(n) == j_bucket_len(n)
    assert bucket_len(n, 16) == j_bucket_len(n, 16)


def _reduced_port_params(m):
    from repro_torch.registry import get_config
    cfg = dataclasses.replace(get_config("mixtral-8x7b", reduced=True),
                              force_unroll_plan=True)
    return cfg, params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_resident_caches_reset_between_generates_in_one_bucket(impl):
    """One port engine serves a 30-token and then a 17-token prompt batch:
    both pad to 32 and land in cache bucket 64, so the second prefill runs
    on the first's resident caches after their reset.  Each run is
    token-identical, with the same router trace, to the JAX engine and to
    a fresh port engine, and the reset leaves the caches as
    ``init_caches`` made them before the prefill writes."""
    from repro_torch.models.transformer import init_caches
    rng = np.random.default_rng(9)
    long_p = rng.integers(2, 512, (2, 30)).astype(np.int32)
    short_p = rng.integers(2, 512, (2, 17)).astype(np.int32)
    m = _jax_engine_run(np.random.default_rng(5).integers(2, 512, (2, 11))
                        .astype(np.int32), 8)
    if "bucket_runs" not in _CACHE:
        jeng = JServeEngine(m["jcfg_q"], m["jq"], quantized=True,
                            kernel_impl="ref")
        _CACHE["bucket_runs"] = [jeng.generate(p, 8)
                                 for p in (long_p, short_p)]
    cfg, params = _reduced_port_params(m)
    eng = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu")
    for prompts, want in zip((long_p, short_p), _CACHE["bucket_runs"]):
        res = eng.generate(prompts, 8)
        fresh = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                            device="cpu").generate(prompts, 8)
        for other in (want, fresh):
            np.testing.assert_array_equal(res.tokens, other.tokens)
            np.testing.assert_array_equal(res.router_trace,
                                          other.router_trace)
        np.testing.assert_allclose(res.logprobs, want.logprobs, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(res.logprobs, fresh.logprobs)
    assert list(eng._caches) == [(2, 64)]
    caches = eng._bucket_caches(2, 64)
    init = init_caches(cfg, 2, 64, torch.float32, device="cpu")
    for got, want in zip(caches["layers"] + [caches["pos"]],
                         init["layers"] + [init["pos"]]):
        if isinstance(got, dict):
            assert got.keys() == want.keys()
            for key in got:
                assert torch.equal(got[key], want[key]), key
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_reset_attn_cache_restores_init_state(kv_bits):
    from repro_torch.models.kvcache import (init_attn_cache,
                                            reset_attn_cache,
                                            update_attn_cache)
    cache = init_attn_cache(2, 8, 2, 4, torch.float32, kv_bits=kv_bits,
                            device="cpu")
    kv = torch.randn((2, 3, 2, 4), generator=torch.Generator()
                     .manual_seed(0))
    update_attn_cache(cache, kv, kv + 1, torch.tensor([[0, 1, 2]] * 2))
    assert (cache["pos"] >= 0).any() and cache["k"].abs().sum() > 0
    tensors = {k: t for k, t in cache.items()}
    want = init_attn_cache(2, 8, 2, 4, torch.float32, kv_bits=kv_bits,
                           device="cpu")
    assert reset_attn_cache(cache) is cache
    for key, t in cache.items():
        assert t is tensors[key]            # in place
        assert torch.equal(t, want[key]), key


@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (64, 1e4)])
def test_rope_freqs_bit_identical_cached_and_uncached(head_dim, theta):
    """The frequencies, computed at the first call and reused after, are
    bit-identical to the formula evaluated afresh on every call."""
    from repro_torch.models import layers
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    want = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    layers._ROPE_FREQS.pop((head_dim, theta, torch.device("cpu")), None)
    first = layers.rope_freqs(head_dim, theta, "cpu")
    again = layers.rope_freqs(head_dim, theta, torch.device("cpu"))
    assert again is first
    assert torch.equal(first, want) and torch.equal(again, want)


def test_decode_graph_on_cpu_engine_raises():
    from repro_torch.models.transformer import init_params
    from repro_torch.registry import get_config
    cfg = get_config("mixtral-8x7b", reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="decode_graph=True needs a CUDA"):
        ServeEngine(cfg, params, device="cpu", decode_graph=True)
    eng = ServeEngine(cfg, params, device="cpu")
    assert not eng.decode_graph and eng.num_graphs == 0


def test_generate_with_static_plan_matches_no_plan():
    """A plan holding the static restoration knobs ([top_n_restore,
    pad_rank] on every MoE layer) gives the no-plan result; a plan with
    no compensation (top_n 0) changes the log-probs."""
    m = _jax_engine_run(np.random.default_rng(5).integers(2, 512, (2, 11))
                        .astype(np.int32), 8)
    cfg, params = _reduced_port_params(m)
    prompts = np.random.default_rng(5).integers(2, 512, (2, 11)) \
        .astype(np.int32)
    eng = ServeEngine(cfg, params, quantized=True, device="cpu")
    moe_layers = [lp["moe"] for lp in params["layers"] if "moe" in lp]
    pad = moe_layers[0]["stacks"]["w1"].pad_rank
    static = [[cfg.moe.quant.top_n_restore, pad]] * len(moe_layers)
    base = eng.generate(prompts, 8)
    with_plan = eng.generate(prompts, 8, plan=static)
    np.testing.assert_array_equal(with_plan.tokens, base.tokens)
    np.testing.assert_array_equal(with_plan.router_trace, base.router_trace)
    np.testing.assert_array_equal(with_plan.logprobs, base.logprobs)
    off = eng.generate(prompts, 8, plan=[[0, pad]] * len(moe_layers))
    assert not np.array_equal(off.logprobs, base.logprobs)

"""PyTorch port vs the JAX package on reduced Llama-3.2-3B, the dense
model served through E = 1 quantize-then-compensate stacks: the bridge,
prefill and decode-step logits (dense and quantized), greedy
``ServeEngine.generate`` tokens, and the port's own ``compress_dense_params``
against the JAX pipeline.

JAX builds the E = 1 stacks the way its pipeline compresses a dense FFN
(DESIGN.md §5): ``compress_ffn_weights(w1[None], w2[None], w3[None])`` per
layer of the unrolled parameters.  The reduced config's rank budget (8)
allocates rank 0 at E = 1, so the stacks here are built at budget 16 to
exercise the compensation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import compress_ffn_weights as j_compress_ffn
from repro.models import ExecContext as JCtx
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_caches as j_init_caches
from repro.models import init_params as j_init_params
from repro.models.transformer import unstack_params as j_unstack
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_jax
from repro_torch.core.pipeline import CompressedExpertStack
from repro_torch.models.model import decode_step, forward
from repro_torch.models.transformer import (ExecContext,
                                            compress_dense_params,
                                            init_caches, init_params,
                                            layer_specs)
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine

ARCH = "llama3.2-3b"
# f32 on both sides; sums run in another order (einsum paths, the
# factored dequant of the kernel's plain version)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
_CACHE = {}


def _qcfg(cfg):
    return dataclasses.replace(cfg.quant, rank_budget=16)


def _models():
    """JAX reduced Llama: dense params, E = 1 compressed params and their
    configs, built once per test process."""
    if not _CACHE:
        jcfg = j_get_config(ARCH, reduced=True)
        jp = j_init_params(jax.random.key(0), jcfg, jnp.float32)
        up = j_unstack(jp, jcfg)
        segs = []
        for (lp,) in up["segments"]:
            lp = dict(lp)
            f = lp["ffn"]
            stacks, _ = j_compress_ffn(f["w1"][None], f["w2"][None],
                                       f["w3"][None], _qcfg(jcfg))
            lp["ffn"] = {"stacks": stacks}
            segs.append((lp,))
        jq = dict(up)
        jq["segments"] = tuple(segs)
        _CACHE.update(jcfg=jcfg, jp=jp, jq=jq,
                      jcfg_q=dataclasses.replace(jcfg,
                                                 force_unroll_plan=True))
    return _CACHE


def test_llama_layers_are_dense_global():
    cfg = get_config(ARCH)
    assert [s.ffn for s in layer_specs(cfg)] == ["dense"] * 28
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings) == \
        (3072, 24, 8, 128, 8192, 128_256, True)
    with pytest.raises(NotImplementedError, match="recurrent"):
        layer_specs(dataclasses.replace(cfg, block_pattern=("recurrent",)))


def test_bridge_carries_dense_ffn_and_e1_stacks():
    m = _models()
    tp = params_from_jax(jax.tree.map(np.asarray, m["jp"]), "cpu")
    w1 = np.asarray(m["jp"]["segments"][0][0]["ffn"]["w1"])   # (L, d, ff)
    assert len(tp["layers"]) == w1.shape[0] == 2
    for li, lp in enumerate(tp["layers"]):
        np.testing.assert_array_equal(lp["ffn"]["w1"].numpy(), w1[li])
        assert set(lp["ffn"]) == {"w1", "w2", "w3"}
    tq = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    for lp, (jlp,) in zip(tq["layers"], m["jq"]["segments"]):
        for name in ("w1", "w2", "w3"):
            st, js = lp["ffn"]["stacks"][name], jlp["ffn"]["stacks"][name]
            assert isinstance(st, CompressedExpertStack)
            assert st.shape == tuple(js.shape) and st.shape[0] == 1
            assert st.ranks == tuple(js.ranks) == (16,)
            for a, b in zip(st.planes + (st.scale, st.u, st.v_scale),
                            js.planes + (js.scale, js.u, js.v_scale)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _run_both(quantized: bool, impl: str):
    m = _models()
    jcfg = m["jcfg_q"] if quantized else m["jcfg"]
    jparams = m["jq"] if quantized else m["jp"]
    tcfg = dataclasses.replace(get_config(ARCH, reduced=True),
                               force_unroll_plan=quantized)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32)

    jc = j_init_caches(jcfg, 2, 16, jnp.float32)
    jpre = j_forward(jparams, jnp.asarray(toks[:, :8]), jcfg,
                     JCtx(mode="prefill", quantized=quantized,
                          kernel_impl="ref"), caches=jc)
    jstep = j_decode_step(jparams, jnp.asarray(toks[:, 8:]), jpre.caches,
                          jcfg, JCtx(mode="step", quantized=quantized,
                                     kernel_impl="ref"))
    tc = init_caches(tcfg, 2, 16, torch.float32, device="cpu")
    tpre = forward(tparams, torch.from_numpy(toks[:, :8]), tcfg,
                   ExecContext(mode="prefill", quantized=quantized,
                               kernel_impl=impl, collect_trace=True),
                   caches=tc)
    tstep = decode_step(tparams, torch.from_numpy(toks[:, 8:]), tpre.caches,
                        tcfg, ExecContext(mode="step", quantized=quantized,
                                          kernel_impl=impl,
                                          collect_trace=True))
    for j, t in ((jpre, tpre), (jstep, tstep)):
        np.testing.assert_allclose(t.logits.numpy(), np.asarray(j.logits),
                                   **LOGIT_TOL)
        assert t.trace is None and t.router_probs is None
    np.testing.assert_array_equal(tstep.caches["pos"].numpy(),
                                  np.asarray(jstep.caches["pos"]))


@pytest.mark.parametrize("quantized,impl", [(False, "auto"),
                                            (True, "auto"), (True, "ref")])
def test_llama_forward_and_decode_match_jax(quantized, impl):
    _run_both(quantized, impl)


@pytest.mark.parametrize("impl", ["auto", "ref"])
def test_llama_greedy_generate_token_identical(impl):
    m = _models()
    prompts = np.random.default_rng(5).integers(2, 512, (2, 11)) \
        .astype(np.int32)
    if "run" not in m:
        m["run"] = JServeEngine(m["jcfg_q"], m["jq"], quantized=True,
                                kernel_impl="ref").generate(prompts, 8)
    want = m["run"]
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              force_unroll_plan=True)
    params = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    res = ServeEngine(cfg, params, quantized=True, kernel_impl=impl,
                      device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_allclose(res.logprobs, want.logprobs, rtol=1e-4,
                               atol=1e-4)
    assert res.router_trace is None and want.router_trace is None
    assert res.request_trace(0) is None and want.request_trace(0) is None


def _errors(w, st):
    """(quantization, restoration) relative Frobenius errors of one E = 1
    stack against its dense weight."""
    w = torch.as_tensor(np.asarray(w)).float()
    deq = st.dequantize_all()[0]
    comp = st.compensation_all()[0]
    nw = torch.linalg.norm(w)
    return (float(torch.linalg.norm(w - deq) / nw),
            float(torch.linalg.norm(w - deq - comp) / nw))


def test_compress_dense_params_matches_jax_compression():
    """The port's compression of the same dense weights: the same
    quantization and restoration error as the JAX pipeline per
    projection (the factors may differ in sign and order), and a model
    that serves logits close to the JAX-compressed one."""
    m = _models()
    tcfg = get_config(ARCH, reduced=True)
    tp = params_from_jax(jax.tree.map(np.asarray, m["jp"]), "cpu")
    tq_own, tcfg_q = compress_dense_params(tp, tcfg, _qcfg(tcfg))
    assert tcfg_q.force_unroll_plan
    assert "w1" in tp["layers"][0]["ffn"]            # input left as it was
    tq_jax = params_from_jax(jax.tree.map(np.asarray, m["jq"]), "cpu")
    for li, (own, jx) in enumerate(zip(tq_own["layers"], tq_jax["layers"])):
        assert set(own["ffn"]) == {"stacks"}
        for name in ("w1", "w2", "w3"):
            w = tp["layers"][li]["ffn"][name]
            a = _errors(w, own["ffn"]["stacks"][name])
            b = _errors(w, jx["ffn"]["stacks"][name])
            assert a[1] < a[0]
            np.testing.assert_allclose(a, b, rtol=1e-3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 8)).astype(np.int32))
    ctx = ExecContext(mode="train", quantized=True)
    a = forward(tq_own, toks, tcfg_q, ctx).logits
    b = forward(tq_jax, toks, tcfg_q, ctx).logits
    assert float((a - b).abs().max()) < 0.02 * float(b.abs().max())


def test_dense_engine_on_port_initialized_params():
    """The port's own init + compression serves through both impls with
    identical greedy tokens and no router trace."""
    cfg = get_config(ARCH, reduced=True)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    qp, cfg_q = compress_dense_params(params, cfg, _qcfg(cfg))
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 9)) \
        .astype(np.int32)
    a = ServeEngine(cfg_q, qp, quantized=True, device="cpu").generate(
        prompts, 6)
    b = ServeEngine(cfg_q, qp, quantized=True, kernel_impl="ref",
                    device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=1e-4, atol=1e-4)
    assert a.router_trace is None

"""PyTorch port vs the JAX package on the stateful mixers of the model zoo:
RecurrentGemma-9B (Griffin's 2 recurrent : 1 local pattern, RG-LRU +
conv1d blocks, dense FFNs as E = 1 stacks) and xLSTM-125M (alternating
mLSTM and sLSTM blocks, unquantized), at ``reduce_config`` sizes (window
16, widths 128), and the paged cache's mixed plans (local rings and
recurrent states slot-indexed beside the page pools).

Seeds: JAX parameters from ``jax.random.key(3)`` (layers from key 5),
inputs from ``numpy.random.default_rng`` with the seed at each call.
Tolerances: f32 on both sides; the RG-LRU scan combines its pairs in
another order than JAX's ``associative_scan`` and the chunkwise mLSTM
sums its einsums in another order, so a mixer alone agrees within 1e-5
and a model's log-probs within 1e-4 (``test_torch_model.py``'s limit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import compress_ffn_weights as j_compress_ffn
from repro.models import kvcache as j_kv
from repro.models.rglru import rglru_seq as j_rglru_seq
from repro.models.rglru import rglru_step as j_rglru_step
from repro.models.transformer import LayerSpec as JLayerSpec
from repro.models.transformer import derive_plan as j_derive_plan
from repro.models.transformer import init_caches as j_init_caches
from repro.models.transformer import init_layer as j_init_layer
from repro.models.transformer import init_paged_caches as j_init_paged
from repro.models.transformer import init_params as j_init_params
from repro.models.transformer import layer_specs as j_layer_specs
from repro.models.transformer import unstack_params as j_unstack
from repro.models.xlstm import mlstm_chunkwise as j_mlstm_chunkwise
from repro.models.xlstm import mlstm_step as j_mlstm_step
from repro.models.xlstm import slstm_seq as j_slstm_seq
from repro.registry import get_config as j_get_config
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax, tree_to_torch
from repro_torch.models import kvcache as t_kv
from repro_torch.models.kvcache import is_paged
from repro_torch.models.rglru import rglru_seq, rglru_step
from repro_torch.models.transformer import (cache_claim_slot_paged,
                                            cache_reset_slot_paged,
                                            init_caches, init_paged_caches,
                                            init_params, layer_specs)
from repro_torch.models.xlstm import mlstm_chunkwise, mlstm_step, slstm_seq
from repro_torch.registry import get_config
from repro_torch.serve.engine import ServeEngine, _graph_key
from repro_torch.serve.scheduler import Request

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

# one mixer alone, f32, sums in another order
MIXER_TOL = dict(rtol=1e-5, atol=1e-5)
# a model's log-probs, f32 (test_torch_model.py's limit)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
NEW = 24
ARCHS = ("recurrentgemma-9b", "xlstm-125m")
_CACHE = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_model(arch: str):
    """(JAX cfg, params, quantized) of the reduced model, built once per
    process: RecurrentGemma's FFNs (recurrent and local layers alike) as
    E = 1 stacks at rank budget 16, xLSTM's blocks as initialised (JAX
    serves it unquantized)."""
    if arch in _CACHE:
        return _CACHE[arch]
    jcfg = j_get_config(arch, reduced=True)
    jp = j_init_params(jax.random.key(3), jcfg, jnp.float32)
    if arch == "xlstm-125m":
        _CACHE[arch] = (jcfg, jp, False)
        return _CACHE[arch]
    qcfg = dataclasses.replace(jcfg.quant, rank_budget=16)
    up = j_unstack(jp, jcfg)
    segs = []
    for (lp,) in up["segments"]:
        f = lp["ffn"]
        stacks, _ = j_compress_ffn(f["w1"][None], f["w2"][None],
                                   f["w3"][None], qcfg)
        segs.append((dict(lp, ffn={"stacks": stacks}),))
    _CACHE[arch] = (dataclasses.replace(jcfg, force_unroll_plan=True),
                    dict(up, segments=tuple(segs)), True)
    return _CACHE[arch]


def _port_engine(arch: str) -> ServeEngine:
    jcfg, jparams, quantized = _jax_model(arch)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              force_unroll_plan=jcfg.force_unroll_plan)
    return ServeEngine(cfg, params_from_jax(_np(jparams), "cpu"),
                       quantized=quantized, kernel_impl="ref", device="cpu")


def _prompts():
    # 21 tokens: past the reduced window of 16, so the local ring wraps
    # at prefill and again in decode
    return np.random.default_rng(6).integers(2, 512, (2, 21)) \
        .astype(np.int32)


def _jax_engine(arch: str) -> JServeEngine:
    key = ("engine", arch)
    if key not in _CACHE:
        jcfg, jparams, quantized = _jax_model(arch)
        _CACHE[key] = JServeEngine(jcfg, jparams, quantized=quantized,
                                   kernel_impl="ref")
    return _CACHE[key]


# ---------------------------------------------------------------------------
# the mixers alone
# ---------------------------------------------------------------------------

def test_rglru_seq_and_step_match_jax():
    """``rglru_seq`` over a 12-token and then a 2-token call (``h0`` and
    ``conv_state`` carried from the first into the second, the second
    shorter than the conv's 3 carried inputs), then 5 ``rglru_step``s
    from the state it leaves: outputs and states within 1e-5 of JAX's."""
    cfg = get_config("recurrentgemma-9b", reduced=True)
    jcfg = j_get_config("recurrentgemma-9b", reduced=True)
    jp = j_init_layer(jax.random.key(5), JLayerSpec("recurrent", "dense"),
                      jcfg, jnp.float32)["rglru"]
    tp = tree_to_torch(_np(jp), "cpu")
    x = np.random.default_rng(1).standard_normal(
        (2, 19, cfg.d_model)).astype(np.float32)
    j_seq, j_step = jax.jit(j_rglru_seq), jax.jit(j_rglru_step)
    jy, js = j_seq(jnp.asarray(x[:, :12]), jp)
    ty, ts = rglru_seq(_t(x[:, :12]), tp)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
    # JAX's carried conv state is the last cw - 1 inputs of the call: a
    # 2-token call keeps one carried row, here checked against JAX's
    # window built by hand
    jy2, js2 = j_seq(jnp.asarray(x[:, 12:14]), jp, js["h"], js["conv"])
    ty2, ts2 = rglru_seq(_t(x[:, 12:14]), tp, h0=ts["h"],
                         conv_state=ts["conv"])
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), **MIXER_TOL)
    np.testing.assert_allclose(ts2["h"].numpy(), np.asarray(js2["h"]),
                               **MIXER_TOL)
    want_conv = np.concatenate([np.asarray(js["conv"]),
                                np.asarray(js2["conv"])], axis=1)[:, -3:]
    np.testing.assert_allclose(ts2["conv"].numpy(), want_conv, **MIXER_TOL)
    jst = {"h": js2["h"], "conv": jnp.asarray(want_conv)}
    tst = ts2
    for t in range(14, 19):
        jy, jst = j_step(jnp.asarray(x[:, t:t + 1]), jp, jst)
        ty, tst = rglru_step(_t(x[:, t:t + 1]), tp, tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(tst[name].numpy(),
                                       np.asarray(jst[name]), **MIXER_TOL)


def _mlstm_inputs(seed: int, b=2, s=16, h=2, hd=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    log_i = rng.standard_normal((b, s, h)).astype(np.float32)
    log_f = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((b, s, h)).astype(np.float32) + 3.0))
    return q, k, v, log_i, log_f


@pytest.mark.parametrize("chunk", [4, 5])
def test_mlstm_chunkwise_matches_jax(chunk):
    """``mlstm_chunkwise`` over S 16 at chunk 4 (four chunks, the state
    carried between them) and chunk 5 (does not divide S: one chunk of
    16), from no state and then from the state the first call left (a
    second 16-token call): outputs and states within 1e-5 of JAX's."""
    a = _mlstm_inputs(2)
    jh, js = j_mlstm_chunkwise(*map(jnp.asarray, a), chunk=chunk)
    th, ts = mlstm_chunkwise(*map(_t, a), chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MIXER_TOL)
    a2 = _mlstm_inputs(3)
    jh, js = j_mlstm_chunkwise(*map(jnp.asarray, a2), state=js, chunk=chunk)
    th, ts = mlstm_chunkwise(*map(_t, a2), state=ts, chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MIXER_TOL)
    for name in ("c", "n", "m"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   **MIXER_TOL)


def test_mlstm_step_and_slstm_seq_from_fresh_state():
    """The first step from a fresh cache (``m`` = -inf): ``mlstm_step``
    (then 3 more) and ``slstm_seq`` over 6 tokens from the port's and
    JAX's initial caches agree within 1e-5 and make no NaN or inf; the
    mLSTM prefill from a fresh cache agrees too."""
    b, h, hd = 2, 2, 16
    tm = t_kv.init_mlstm_cache(b, h, hd, device="cpu")
    jm = j_kv.init_mlstm_cache(b, h, hd)
    assert torch.isneginf(tm["m"]).all()
    a = _mlstm_inputs(4, b=b, s=4, h=h, hd=hd)
    for t in range(4):
        sl = [x[:, t:t + 1] for x in a]
        jh, jm = j_mlstm_step(*map(jnp.asarray, sl), jm)
        th, tm = mlstm_step(*map(_t, sl), tm)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MIXER_TOL)
        for name in ("c", "n", "m"):
            assert torch.isfinite(tm[name]).all()
            np.testing.assert_allclose(tm[name].numpy(),
                                       np.asarray(jm[name]), **MIXER_TOL)
    jh, _ = j_mlstm_chunkwise(*map(jnp.asarray, a),
                              state=j_kv.init_mlstm_cache(b, h, hd))
    th, _ = mlstm_chunkwise(*map(_t, a),
                            state=t_kv.init_mlstm_cache(b, h, hd))
    assert torch.isfinite(th).all()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MIXER_TOL)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, 6, 4, h, hd)).astype(np.float32)
    rec = {r: (rng.standard_normal((h, hd, hd)) / 4).astype(np.float32)
           for r in ("rz", "ri", "rf", "ro")}
    jh, js = j_slstm_seq(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                          rec.items()},
                         j_kv.init_slstm_cache(b, h, hd))
    th, ts = slstm_seq(_t(x), {k: _t(v) for k, v in rec.items()},
                       t_kv.init_slstm_cache(b, h, hd, device="cpu"))
    assert torch.isfinite(th).all()
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MIXER_TOL)
    for name in ("c", "n", "h", "m"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   **MIXER_TOL)


def test_state_caches_and_slot_ops_match_jax():
    """The three state caches equal JAX's (shapes, f32, ``m`` -inf);
    ``claim_slot`` copies a request's state into its row and
    ``reset_slot`` puts the row back to JAX's slot fill (``m`` -inf, the
    rest zero)."""
    pairs = [(t_kv.init_rglru_cache(3, 8, 4, device="cpu"),
              j_kv.init_rglru_cache(3, 8, 4)),
             (t_kv.init_mlstm_cache(3, 2, 4, device="cpu"),
              j_kv.init_mlstm_cache(3, 2, 4)),
             (t_kv.init_slstm_cache(3, 2, 4, device="cpu"),
              j_kv.init_slstm_cache(3, 2, 4))]
    rng = np.random.default_rng(7)
    for tc, jc in pairs:
        assert set(tc) == set(jc)
        for name, t in tc.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(jc[name]))
        req = {n: torch.from_numpy(rng.standard_normal(
            (1,) + tuple(t.shape[1:])).astype(np.float32))
            for n, t in tc.items()}
        t_kv.claim_slot(tc, req, 1)
        jc = j_kv.claim_slot(jc, {n: jnp.asarray(v.numpy())
                                  for n, v in req.items()}, 1)
        for name in tc:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))
        t_kv.reset_slot(tc, 1)
        jc = j_kv.reset_slot(jc, 1)
        for name in tc:
            np.testing.assert_array_equal(tc[name].numpy(),
                                          np.asarray(jc[name]))


# ---------------------------------------------------------------------------
# plans, caches and the bridge
# ---------------------------------------------------------------------------

def _cache_shapes(layers):
    return [{n: (tuple(t.shape), str(t.dtype).split(".")[-1])
             for n, t in c.items()} for c in layers]


def _jax_cache_layers(jcfg, caches):
    """JAX's per-layer cache dicts in layer order (segments unstacked)."""
    out = []
    for seg, plan in zip(caches["segments"], j_derive_plan(jcfg)):
        for r in range(plan.repeat):
            for c in seg:
                out.append({n: (a[r] if plan.repeat > 1 else a)
                            for n, a in c.items()})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_stateful_plans_match_jax(arch):
    """Layer specs at published depth (38 = 12 periods + 2 recurrent
    layers; 12 alternating xLSTM blocks) and reduced equal JAX's; the
    reduced model's contiguous caches and its paged slot caches (page 8,
    4 blocks) equal JAX's layer for layer in names, shapes and dtypes."""
    for reduced in (False, True):
        cfg, jcfg = get_config(arch, reduced), j_get_config(arch, reduced)
        assert [(s.mixer, s.ffn) for s in layer_specs(cfg)] == \
            [(s.mixer, s.ffn) for s in j_layer_specs(jcfg)]
    full = layer_specs(get_config(arch))
    if arch == "recurrentgemma-9b":
        assert [s.mixer for s in full].count("local") == 12
        assert {s.ffn for s in full} == {"dense"}
    else:
        assert [s.mixer for s in full] == ["mlstm", "slstm"] * 6
        assert {s.ffn for s in full} == {"none"}
    cfg = dataclasses.replace(get_config(arch, True), num_layers=6)
    jcfg = dataclasses.replace(j_get_config(arch, True), num_layers=6)
    f32 = jnp.float32
    want = _jax_cache_layers(jcfg, j_init_caches(jcfg, 3, 40, f32))
    got = init_caches(cfg, 3, 40, torch.float32, device="cpu")["layers"]
    assert _cache_shapes(got) == [
        {n: (tuple(a.shape), str(a.dtype)) for n, a in c.items()}
        for c in want]
    want = _jax_cache_layers(jcfg, j_init_paged(jcfg, 3, 9, 8, 4, f32))
    got = init_paged_caches(cfg, 3, 9, 8, 4, torch.float32,
                            device="cpu")["layers"]
    assert _cache_shapes(got) == [
        {n: (tuple(a.shape), str(a.dtype)) for n, a in c.items()}
        for c in want]


def test_mixed_paged_plan_claims_and_resets_like_jax():
    """Reduced Gemma3-1B's paged slot caches (5 local rings of 16 beside
    1 paged global layer): a claim maps the pages into the global layer's
    block table and copies each ring row; a reset unmaps the table row
    and clears each ring row: every plane equals JAX's
    ``cache_claim_slot_paged`` / ``cache_reset_slot_paged``."""
    from repro.models.transformer import \
        cache_claim_slot_paged as j_claim, \
        cache_reset_slot_paged as j_reset
    cfg = dataclasses.replace(get_config("gemma3-1b", True),
                              force_unroll_plan=True)
    jcfg = dataclasses.replace(j_get_config("gemma3-1b", True),
                               force_unroll_plan=True)
    slots, n_pages, ps, mb = 2, 9, 8, 4
    tc = init_paged_caches(cfg, slots, n_pages, ps, mb, torch.float32,
                           device="cpu")
    jc = j_init_paged(jcfg, slots, n_pages, ps, mb, jnp.float32)
    rng = np.random.default_rng(8)
    req = init_caches(cfg, 1, 16, torch.float32, device="cpu")
    for c in req["layers"]:
        for n, t in c.items():
            t.copy_(torch.from_numpy(rng.integers(-1, 30, t.shape).astype(
                np.int32)) if n == "pos" else torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32)))
    req["pos"].fill_(13)
    jreq = {"segments": tuple((_np_to_jax(c),) for c in req["layers"]),
            "pos": jnp.asarray(req["pos"].numpy())}
    pages = np.array([3, 5, -1, -1], np.int32)
    mask = np.array([True, True, False, False])
    cache_claim_slot_paged(cfg, tc, req, 1, torch.from_numpy(pages),
                           torch.from_numpy(mask))
    jc = j_claim(jcfg, jc, jreq, 1, jnp.asarray(pages), jnp.asarray(mask))
    _assert_layers_equal(tc, jc)
    cache_reset_slot_paged(cfg, tc, 1)
    jc = j_reset(jcfg, jc, 1)
    _assert_layers_equal(tc, jc)


def _np_to_jax(c):
    return {n: jnp.asarray(t.numpy()) for n, t in c.items()}


def _assert_layers_equal(tc, jc):
    for c, (jl,) in zip(tc["layers"], jc["segments"]):
        assert set(c) == set(jl)
        for n, t in c.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jl[n]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_bridge_maps_recurrentgemma_periods_layer_for_layer():
    """A 6-layer RecurrentGemma (one scanned segment of two Griffin
    periods, narrow widths) and the reduced xLSTM cross the bridge in
    layer order: every leaf (the RG-LRU's f32 gates and conv, the sLSTM's
    recurrent blocks and its inner gated FFN) equals the JAX package's
    unrolled layer of that index, dtype included."""
    jcfg = dataclasses.replace(
        j_get_config("recurrentgemma-9b", reduced=True), num_layers=6)
    jp = jax.jit(j_init_params, static_argnums=(1, 2))(
        jax.random.key(2), jcfg, jnp.float32)
    assert [seg.repeat for seg in j_derive_plan(jcfg)] == [2]
    xcfg, xp, _ = _jax_model("xlstm-125m")
    for jcfg, jp, n in ((jcfg, jp, 6), (xcfg, xp, 2)):
        flat = _np(j_unstack(jp, jcfg))["segments"]
        layers = params_from_jax(_np(jp), "cpu")["layers"]
        assert len(layers) == len(flat) == n
        for lp, (jlp,) in zip(layers, flat):
            tl = jax.tree_util.tree_leaves_with_path(jlp)
            assert len(tl) == _n_leaves(lp)
            for path, leaf in tl:
                t = lp
                for k in path:
                    t = t[k.key]
                assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
                np.testing.assert_array_equal(t.numpy(), leaf)
    assert set(layers[1]["slstm"]["ffn"]) == {"w1", "w2", "w3"}
    assert layers[0]["mlstm"]["b_if"].dtype == torch.float32


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_jax(arch):
    """Greedy ``generate`` (21-token prompts, 24 new; RecurrentGemma's
    local ring of 16 wraps at prefill and in decode, on the JAX
    pipeline's E = 1 stacks; xLSTM unquantized): tokens equal JAX's and
    log-probs within 1e-4."""
    want = _jax_engine(arch).generate(_prompts(), NEW)
    res = _port_engine(arch).generate(_prompts(), NEW)
    assert res.router_trace is None
    np.testing.assert_array_equal(res.tokens, want.tokens)
    np.testing.assert_allclose(res.logprobs, want.logprobs, **F32_TOL)


def test_recurrentgemma_paged_serve_matches_jax_and_contiguous():
    """Reduced RecurrentGemma ``serve`` at page 8 (no global layer: the
    ring and the states stay slot-indexed): 5 requests of 11 and 27
    tokens (both sides of the window; each prefilled at its exact
    length), 2 slots, chunks of 4, 10 new: tokens equal JAX's paged serve
    and the port's contiguous serve, log-probs within 1e-4."""
    lens = (11, 27, 27, 11, 27)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, 512, (n,)).astype(np.int32) for n in lens]
    want = _jax_engine("recurrentgemma-9b").serve(
        [JRequest(uid=i, tokens=p, max_new=10) for i, p in
         enumerate(prompts)], num_slots=2, chunk=4, seed=0, page_size=8)
    eng = _port_engine("recurrentgemma-9b")

    def run(**kw):
        return eng.serve([Request(uid=i, tokens=p, max_new=10)
                          for i, p in enumerate(prompts)],
                         num_slots=2, chunk=4, seed=0, **kw)
    paged, contiguous = run(page_size=8), run()
    assert paged.page_report is not None
    for a, b, c in zip(paged.results, want.results, contiguous.results):
        assert a.uid == b.uid == c.uid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, c.tokens)
        np.testing.assert_allclose(a.logprobs, b.logprobs, **F32_TOL)
    assert paged.prefill_tokens == want.prefill_tokens == sum(lens)


@pytest.mark.parametrize("arch", ARCHS)
def test_stateful_plans_refuse_prefix_cache_and_speculation(arch):
    """A recurrent or xLSTM plan refuses prefix reuse and speculation
    with JAX's ``ValueError`` (a state can neither seed from shared pages
    nor roll back a rejected draft); JAX's engine refuses alike."""
    cfg = get_config(arch, reduced=True)
    eng = ServeEngine(cfg, init_params(cfg, 0, torch.float32, "cpu"),
                      device="cpu")
    reqs = [Request(uid=0, tokens=np.arange(2, 22, dtype=np.int32),
                    max_new=4)]
    with pytest.raises(ValueError, match="prefix_cache needs an all-global"):
        eng.serve(reqs, page_size=8, prefix_cache=True)
    with pytest.raises(ValueError, match="cannot roll back a rejected"):
        eng.serve(reqs, spec_k=2, drafter="ngram")
    jeng = _jax_engine(arch)
    jreqs = [JRequest(uid=0, tokens=np.arange(2, 22, dtype=np.int32),
                      max_new=4)]
    with pytest.raises(ValueError, match="prefix_cache needs an all-global"):
        jeng.serve(jreqs, page_size=8, prefix_cache=True)
    with pytest.raises(ValueError, match="cannot roll back a rejected"):
        jeng.serve(jreqs, spec_k=2, drafter="ngram")


@pytest.mark.parametrize("what", ["encoder", "mrope"])
def test_unported_mixers_raise_naming_a12(what):
    """The last mixers of ROADMAP A12 (part 3): an encoder-decoder config
    (cross-attention) and mrope build their plans, caches and parameters;
    an encoder config adds the encoder tower and each layer's cross
    planes, and its paged cache raises (JAX's refusal); mrope adds no
    leaf and no plane."""
    from repro_torch.config import EncoderConfig
    base = get_config("qwen2-7b", reduced=True)
    cfg = (dataclasses.replace(base, encoder=EncoderConfig(2, 128, 2, 192,
                                                           24))
           if what == "encoder" else
           dataclasses.replace(base, rope_kind="mrope"))
    enc = what == "encoder"
    assert [s.cross for s in layer_specs(cfg)] == [enc] * cfg.num_layers
    caches = init_caches(cfg, 1, 8, device="cpu")
    assert all(("cross_k" in c) == enc for c in caches["layers"])
    params = init_params(cfg, 0, torch.float32, "cpu")
    assert ("encoder" in params) == enc
    assert ("cross_wq" in params["layers"][0]["attn"]) == enc
    if enc:
        with pytest.raises(NotImplementedError, match="cross-attention"):
            init_paged_caches(cfg, 2, 8, 4, 2, device="cpu")


def test_graph_key_of_stateful_and_mixed_plans():
    """The decode-graph key is the resident cache set that the graph
    replays, whatever the plan holds: RecurrentGemma's (layer 0
    recurrent, no ``k``), xLSTM's (no attention layer) and a mixed paged
    Gemma3 plan's (layer 0 a local ring).  Two sets of one shape key
    apart, and a paged RecurrentGemma plan (no global layer) gets slot
    caches of its own, apart from the contiguous bucket's."""
    rg = get_config("recurrentgemma-9b", reduced=True)
    a = init_caches(rg, 2, 64, torch.float32, device="cpu")
    b = init_caches(rg, 2, 128, torch.float32, device="cpu")
    assert "k" not in a["layers"][0]
    assert _graph_key(a, None) == (id(a), False) != _graph_key(b, None)
    assert _graph_key(a, np.zeros(1)) == (id(a), True)
    xl = init_caches(get_config("xlstm-125m", reduced=True), 3, 64,
                     torch.float32, device="cpu")
    assert not any("k" in c for c in xl["layers"])
    assert _graph_key(xl, None) == (id(xl), False)
    gm = get_config("gemma3-1b", reduced=True)
    pc = init_paged_caches(gm, 2, 9, 8, 4, torch.float32, device="cpu")
    assert "block" not in pc["layers"][0] and "block" in pc["layers"][5]
    assert _graph_key(pc, None) == (id(pc), False)
    eng = ServeEngine(rg, init_params(rg, 0, torch.float32, "cpu"),
                      device="cpu")
    paged = eng._paged_bucket(2, 9, 8, 4)
    contiguous = eng._bucket_caches(2, 32)
    assert paged is not contiguous
    assert paged is eng._paged_bucket(2, 9, 8, 4)
    rings = [c["k"].shape[1] for c in paged["layers"] if "k" in c]
    assert rings and set(rings) == {min(rg.window_size, 32)}
    assert not any(is_paged(c) for c in paged["layers"])
"""The port's speculative decoding (``serve/speculative.py``, the engine's
verify round, ``cache_rollback``, the lookahead prefetcher and
``replay_spec_round``) against the JAX package's, on the CPU.

Both sides serve the ``spec-tier`` MoE of ``tests/test_speculative.py``
(2 layers, d 64, 8 experts top-2, INT2, top-n 1) in f32 from stacks JAX
compressed, carried into the port by ``bridge.py``; the JAX engine runs
``kernel_impl="ref"``, the port its main path (the kernels' plain
versions on the CPU).  Inputs are made from seeds with numpy.  Integers
(tokens, accepted masks, traces, bytes, counters) must be equal; floats
within 1e-6 (log-probs of a served run within 1e-4: f32 sums in another
order, as in ``tests/test_torch_serve.py``).  The port's own contract is
checked beside: greedy speculation is token-identical to its
autoregressive serve, contiguous and paged, and a rolled-back cache is
bit-identical to one that never saw the rejected suffix."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro.config import QuantConfig as JQuantConfig
from repro.config import ServeConfig as JServeConfig
from repro.models import init_params as j_init_params
from repro.models import kvcache as j_kv
from repro.models.transformer import cache_rollback as j_rollback
from repro.models.transformer import compress_moe_params as j_compress
from repro.offload import prefetch as j_prefetch
from repro.offload import store as j_store
from repro.serve import DraftModelDrafter as JDraftModelDrafter
from repro.serve import NGramDrafter as JNGramDrafter
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import accept_drafts as j_accept
from repro.serve import mask_banned as j_mask_banned
from repro_torch.bridge import params_from_jax
from repro_torch.config import (ModelConfig, MoEConfig, QuantConfig,
                                ServeConfig, StreamConfig)
from repro_torch.models import kvcache as t_kv
from repro_torch.models.transformer import cache_rollback
from repro_torch.offload import prefetch as t_prefetch
from repro_torch.offload import store as t_store
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.speculative import (DraftModelDrafter, NGramDrafter,
                                           accept_drafts, mask_banned,
                                           sample_uniform)

import torch_cpu  # noqa: F401  (one intra-op thread per worker)

E = 8
MAX_NEW = 8
LP_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg_kw():
    return dict(name="spec-tier", family="moe", num_layers=2, d_model=64,
                num_heads=2, num_kv_heads=1, head_dim=32, d_ff=0,
                vocab_size=128, block_pattern=("global",), max_position=512)


def _quant(cls):
    return cls(enabled=True, bits=2, rank_budget=16, top_n_restore=1,
               hqq_iters=2)


def j_cfg():
    return JModelConfig(**_cfg_kw(), moe=JMoEConfig(
        num_experts=E, top_k=2, d_expert=64, quant=_quant(JQuantConfig)))


def t_cfg():
    """``j_cfg()`` in the port's config classes, as compressed."""
    return ModelConfig(**_cfg_kw(), force_unroll_plan=True, moe=MoEConfig(
        num_experts=E, top_k=2, d_expert=64, quant=_quant(QuantConfig)))


@pytest.fixture(scope="module")
def m():
    """One compressed weight set, a JAX engine (``kernel_impl='ref'``)
    and a port engine over it, and the memo of served runs."""
    params = j_init_params(jax.random.key(0), j_cfg(), jnp.float32)
    qp, cq, jstacks = j_compress(params, j_cfg())
    tq = params_from_jax(jax.tree.map(np.asarray, qp), "cpu")
    tstacks = [lp["moe"]["stacks"] for lp in tq["layers"] if "moe" in lp]
    return {"jax": (JServeEngine(cq, qp, JServeConfig(temperature=0.0),
                                 quantized=True, kernel_impl="ref"),
                    jstacks, JRequest),
            "torch": (ServeEngine(t_cfg(), tq, ServeConfig(temperature=0.0),
                                  quantized=True, device="cpu"),
                      tstacks, Request),
            "runs": {}}


def _requests(req_cls):
    rng = np.random.default_rng(3)
    return [req_cls(uid=i, tokens=rng.integers(1, 128, (int(n),))
                    .astype(np.int32), max_new=MAX_NEW)
            for i, n in enumerate((4, 6, 5))]


def serve(m, side, cap=E, **kw):
    """``serve(**kw)`` of the test workload on the side's engine (fresh
    stores, LRU ``cap`` of 8), memoised per (side, cap, kw)."""
    key = (side, cap, tuple(sorted((k, v) for k, v in kw.items()
                                   if isinstance(v, (int, str)))))
    if key not in m["runs"] or not all(isinstance(v, (int, str))
                                       for v in kw.values()):
        eng, stacks, req_cls = m[side]
        eng.attach_offload(stacks, policy="ours", cache_capacity=cap)
        m["runs"][key] = eng.serve(_requests(req_cls), num_slots=2, chunk=4,
                                   **kw)
    return m["runs"][key]


def tokens(st):
    return [r.tokens.tolist() for r in st.results]


# ---------------------------------------------------------------------------
# acceptance math
# ---------------------------------------------------------------------------

def _logits_drafts(seed, rows=3, k=4, v=16):
    """Random (rows, k, v) logits and drafts, each draft the row's argmax
    with probability 0.7 (so acceptance runs of every length occur)."""
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((rows, k, v)).astype(np.float32)
    arg = lg.argmax(-1)
    other = (arg + rng.integers(1, v, arg.shape)) % v
    draft = np.where(rng.random(arg.shape) < 0.7, arg, other)
    return lg, draft.astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_accept_drafts_greedy_matches_jax(seed):
    lg, draft = _logits_drafts(seed)
    want = np.asarray(j_accept(jnp.asarray(lg), jnp.asarray(draft),
                               jax.random.key(0), 0.0))
    got = accept_drafts(torch.from_numpy(lg), torch.from_numpy(draft), None,
                        0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_accept_drafts_sampling_edges_match_jax():
    """temperature > 0: p_target(draft) = 1 accepts surely, p = 0 rejects
    surely, and a rejection truncates the round: the deterministic edges,
    equal on both sides whatever the draws."""
    v, k = 16, 3
    lg = np.full((3, k, v), -1e9, np.float32)
    lg[:, :, 5] = 0.0
    draft = np.asarray([[5, 5, 5], [6, 6, 6], [5, 6, 5]], np.int32)
    want = np.asarray(j_accept(jnp.asarray(lg), jnp.asarray(draft),
                               jax.random.key(1), 0.8))
    u = torch.from_numpy(np.random.default_rng(0).random((3, k))
                         .astype(np.float32))
    got = accept_drafts(torch.from_numpy(lg), torch.from_numpy(draft), u,
                        0.8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[True] * 3, [False] * 3, [True, False, False]]


def test_mask_banned_matches_jax():
    lg = np.random.default_rng(4).standard_normal((4, 10)).astype(np.float32)
    banned = np.asarray([3, -1, 0, 9], np.int32)
    want = np.asarray(j_mask_banned(jnp.asarray(lg), jnp.asarray(banned)))
    got = mask_banned(torch.from_numpy(lg), torch.from_numpy(banned))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_uniform_inverts_the_cdf():
    """The bonus sampler: argmax at temperature 0; at > 0 the token whose
    CDF interval holds the draw (a banned token, of probability 0, never),
    so equal draws give equal tokens and the frequencies follow the
    softmax."""
    lg = torch.tensor([[0.0, float("-inf"), 1.0, 0.5],
                       [2.0, 0.0, float("-inf"), 0.0]])
    assert sample_uniform(lg, None, 0.0).tolist() == [2, 0]
    u = torch.from_numpy(np.random.default_rng(5).random((20000, 1))
                         .astype(np.float32))
    for row in range(2):
        got = sample_uniform(lg[row:row + 1].expand(20000, 4).contiguous(),
                             u[:, 0], 0.7)
        freq = np.bincount(got.numpy(), minlength=4) / 20000
        p = torch.softmax(lg[row] / 0.7, dim=-1).numpy()
        assert freq[p == 0].sum() == 0
        np.testing.assert_allclose(freq, p, atol=0.02)


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_matches_jax():
    """Seeded streams with repeats (so every backoff level fires), reset,
    observe and propose on both sides; empty slots propose zeros."""
    rng = np.random.default_rng(6)
    j, t = JNGramDrafter(order=3), NGramDrafter(order=3)
    for slot in range(3):
        prompt = rng.integers(0, 6, (int(rng.integers(1, 9)),))
        for d in (j, t):
            d.reset_slot(slot, prompt)
    for _ in range(5):
        for slot in range(3):
            toks = rng.integers(0, 6, (int(rng.integers(1, 4)),))
            for d in (j, t):
                d.observe(slot, toks)
        for k in (1, 3):
            np.testing.assert_array_equal(t.propose_all(4, k),
                                          j.propose_all(4, k))


def test_draft_model_drafter_matches_jax(m):
    """JAX's 1-layer dense stand-in, its parameters bridged into the
    port's drafter, and the self-drafter on the served model: the same
    greedy proposals over ragged windows (full, partly filled, empty)."""
    jd = JDraftModelDrafter.from_target(j_cfg(), window=8, kernel_impl="ref")
    small = dataclasses.replace(
        t_cfg(), name="spec-tier-draft", family="dense", num_layers=1,
        moe=None, force_unroll_plan=False)
    td = DraftModelDrafter(small, params_from_jax(
        jax.tree.map(np.asarray, jd.params), "cpu"), window=8)
    tself = DraftModelDrafter.self_draft(
        m["torch"][0].cfg, m["torch"][0].params, window=8, quantized=True)
    jeng = m["jax"][0]
    jself = JDraftModelDrafter.self_draft(jeng.cfg, jeng.params, window=8,
                                          quantized=True, kernel_impl="ref")
    rng = np.random.default_rng(7)
    for a, b in ((jd, td), (jself, tself)):
        for slot, n in enumerate((12, 3)):
            prompt = rng.integers(1, 128, (n,))
            a.reset_slot(slot, prompt)
            b.reset_slot(slot, prompt)
        np.testing.assert_array_equal(b.propose_all(3, 3),
                                      a.propose_all(3, 3))


def test_from_target_builds_the_dense_stand_in():
    d = DraftModelDrafter.from_target(t_cfg(), window=4, device="cpu")
    assert d.cfg.num_layers == 1 and d.cfg.moe is None
    d.reset_slot(0, np.asarray([3, 4, 5], np.int32))
    out = d.propose_all(2, 3)
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert ((0 <= out) & (out < 128)).all()


# ---------------------------------------------------------------------------
# lookahead prefetcher + replay_spec_round
# ---------------------------------------------------------------------------

def test_replay_spec_round_matches_jax(m):
    """Rounds of seeded verify traces (dead slots -1, accepted prefixes
    of every length) into fresh stores at LRU 3 of 8, with the lookahead
    prefetcher: the same tokens, per-slot bytes, draft overhead, store
    counters, prefetcher scores and offload report."""
    rng = np.random.default_rng(8)
    sides = {}
    for name, mod, pf_mod, stacks in (
            ("jax", j_store, j_prefetch, m["jax"][1]),
            ("torch", t_store, t_prefetch, m["torch"][1])):
        stores = mod.make_expert_stores(stacks, cache_capacity=3)
        pf = pf_mod.LookaheadPrefetcher(len(stores), 2)
        sides[name] = (mod, stores, pf, mod.snapshot_offload(stores, pf))
    total = {"jax": 0, "torch": 0}
    for _ in range(6):
        steps, b = 4, 3
        tr = np.stack([rng.permutation(E)[:2] for _ in range(steps * 2 * b)]
                      ).reshape(steps, 2, b, 2)
        live = rng.random(b) < 0.8
        tr = np.where(live[None, None, :, None], tr, -1)
        acc_len = rng.integers(1, steps + 1, b)
        accepted = (np.arange(steps)[:, None] < acc_len[None]) & live
        out = {}
        for name, (mod, stores, pf, _) in sides.items():
            out[name] = mod.replay_spec_round(
                stores, tr, accepted, policy="ours", top_n=1,
                lookahead=pf)
            total[name] += out[name][0]
        assert out["jax"][0] == out["torch"][0]
        np.testing.assert_array_equal(out["jax"][1], out["torch"][1])
        assert out["jax"][2] == out["torch"][2]
    (jm, js, jpf, jsnap), (tm, ts, tpf, tsnap) = sides["jax"], sides["torch"]
    assert (jpf.bytes_issued, jpf.bytes_wasted) == \
        (tpf.bytes_issued, tpf.bytes_wasted)
    assert dataclasses.asdict(jpf.stats) == dataclasses.asdict(tpf.stats)
    assert jm.offload_report(js, jpf, jsnap, total["jax"], "ours") == \
        tm.offload_report(ts, tpf, tsnap, total["torch"], "ours")


# ---------------------------------------------------------------------------
# cache rollback: bit-identical to never having drafted, and to JAX
# ---------------------------------------------------------------------------

def _rollback_cfg(cls=ModelConfig):
    """One dense layer (JAX's ``_rollback_cfg``): one unscanned cache."""
    return cls(name="rollback", family="dense", num_layers=1, d_model=64,
               num_heads=2, num_kv_heads=1, head_dim=8, d_ff=64,
               vocab_size=32, block_pattern=("global",), max_position=64)


def _kv(rng, b, n):
    return tuple(rng.standard_normal((b, n, 1, 8)).astype(np.float32)
                 for _ in range(2))


def _t_write(fn, cache, k, v, pos):
    fn(cache, torch.from_numpy(k), torch.from_numpy(v),
       torch.from_numpy(np.asarray(pos, np.int32)))


def _j_write(fn, cache, k, v, pos):
    return dict(cache, **fn(cache, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(np.asarray(pos, np.int32))))


@pytest.mark.parametrize("kv_bits", (16, 8))
def test_cache_rollback_contiguous(kv_bits):
    """A 5-token prefix, a 3-token draft suffix, rolled back per row to 5,
    6 and 8 tokens: every plane (pos, K, V, int8 scales) equals a cache
    that never saw the rejected positions, bit for bit, and JAX's rolled-
    back cache (pos and int8 codes exact, the rest within 1e-6)."""
    rng = np.random.default_rng(0)
    pk, pv = _kv(rng, 3, 5)
    dk, dv = _kv(rng, 3, 3)
    new_len = np.asarray([5, 6, 8], np.int32)
    pre = np.broadcast_to(np.arange(5), (3, 5))
    dpos = np.broadcast_to(np.arange(5, 8), (3, 3))

    def port(drafted):
        c = t_kv.init_attn_cache(3, 16, 1, 8, torch.float32, kv_bits=kv_bits)
        _t_write(t_kv.update_attn_cache, c, pk, pv, pre)
        if drafted:
            _t_write(t_kv.update_attn_cache, c, dk, dv, dpos)
        else:     # only the kept positions, row by row
            for r in range(3):
                keep = new_len[r] - 5
                if keep:
                    sub = {n: t[r:r + 1] for n, t in c.items()}
                    _t_write(t_kv.update_attn_cache, sub, dk[r:r + 1, :keep],
                             dv[r:r + 1, :keep], dpos[r:r + 1, :keep])
        return c

    tst = port(True)
    caches = {"layers": [tst], "pos": torch.full((3,), 8, dtype=torch.int32)}
    ptrs = [t.data_ptr() for t in tst.values()]
    assert cache_rollback(_rollback_cfg(), caches,
                          torch.from_numpy(new_len)) is caches
    assert caches["pos"].tolist() == new_len.tolist()
    assert ptrs == [t.data_ptr() for t in tst.values()]
    ref = port(False)
    for plane in ref:
        assert torch.equal(tst[plane], ref[plane]), plane

    jc = j_kv.init_attn_cache(3, 16, 1, 8, jnp.float32, kv_bits=kv_bits)
    jc = _j_write(j_kv.update_attn_cache, jc, pk, pv, pre)
    jc = _j_write(j_kv.update_attn_cache, jc, dk, dv, dpos)
    jr = j_rollback(_rollback_cfg(JModelConfig),
                    {"segments": ((jc,),),
                     "pos": jnp.full((3,), 8, jnp.int32)},
                    jnp.asarray(new_len))["segments"][0][0]
    for plane in jr:
        want = np.asarray(jnp.asarray(jr[plane], jnp.float32)
                          if jr[plane].dtype == jnp.bfloat16 else jr[plane])
        got = tst[plane].float().numpy() if tst[plane].dtype == \
            torch.bfloat16 else tst[plane].numpy()
        if plane in ("pos", "k", "v") and kv_bits == 8 or plane == "pos":
            np.testing.assert_array_equal(got, want, err_msg=plane)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=plane)


@pytest.mark.parametrize("kv_bits", (16, 8))
def test_cache_rollback_paged(kv_bits):
    """Paged rollback masks the pool through the block table with
    per-page limits (rows rolled back to 5 and 7 tokens): outside the
    trash page the pool equals one that never saw the rejected positions
    (their writes parked on the trash page instead), bit for bit, and
    JAX's rolled-back pool."""
    rng = np.random.default_rng(1)
    ps = 4
    pk, pv = _kv(rng, 2, 5)
    dk, dv = _kv(rng, 2, 3)
    pre = np.broadcast_to(np.arange(5), (2, 5))
    dpos = np.broadcast_to(np.arange(5, 8), (2, 3))
    new_len = np.asarray([5, 7], np.int32)
    block = np.asarray([[1, 2], [3, 4]], np.int32)

    def port(draft_pos):
        c = t_kv.init_paged_attn_cache(2, 5, ps, 2, 1, 8, torch.float32,
                                       kv_bits=kv_bits)
        c["block"].copy_(torch.from_numpy(block))
        _t_write(t_kv.paged_update_attn_cache, c, pk, pv, pre)
        _t_write(t_kv.paged_update_attn_cache, c, dk, dv, draft_pos)
        return c

    tst = port(dpos)
    caches = {"layers": [tst], "pos": torch.full((2,), 8, dtype=torch.int32)}
    cache_rollback(_rollback_cfg(), caches, torch.from_numpy(new_len))
    ref = port(np.where(dpos < new_len[:, None], dpos, -1))
    for plane in ref:
        assert torch.equal(tst[plane][1:] if plane != "block"
                           else tst[plane],
                           ref[plane][1:] if plane != "block"
                           else ref[plane]), plane

    jc = j_kv.init_paged_attn_cache(2, 5, ps, max_blocks=2, kv_heads=1,
                                    head_dim=8, dtype=jnp.float32,
                                    kv_bits=kv_bits)
    jc = dict(jc, block=jnp.asarray(block))
    jc = _j_write(j_kv.paged_update_attn_cache, jc, pk, pv, pre)
    jc = _j_write(j_kv.paged_update_attn_cache, jc, dk, dv, dpos)
    jr = j_rollback(_rollback_cfg(JModelConfig),
                    {"segments": ((jc,),),
                     "pos": jnp.full((2,), 8, jnp.int32)},
                    jnp.asarray(new_len))["segments"][0][0]
    np.testing.assert_array_equal(tst["pos"][1:].numpy(),
                                  np.asarray(jr["pos"])[1:])
    for plane in ("k", "v") + (("k_scale", "v_scale") if kv_bits == 8
                               else ()):
        np.testing.assert_allclose(
            tst[plane][1:].float().numpy(),
            np.asarray(jnp.asarray(jr[plane], jnp.float32))[1:], atol=1e-6,
            err_msg=plane)


# ---------------------------------------------------------------------------
# serve(spec_k=...) against JAX and against the plain serve
# ---------------------------------------------------------------------------

SPEC_CASES = {"k1": dict(spec_k=1), "k3": dict(spec_k=3),
              "k3-page4": dict(spec_k=3, page_size=4),
              "k1-page4": dict(spec_k=1, page_size=4)}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_serve_matches_jax_and_plain(m, case):
    """Greedy speculation on both sides: tokens equal the port's plain
    serve (contiguous or paged) and JAX's speculative serve; masked traces
    (the accepted positions), rounds, metered bytes, per-request bytes and
    every ``spec_report`` number equal JAX's; log-probs within 1e-4."""
    kw = SPEC_CASES[case]
    plain_kw = {k: v for k, v in kw.items() if k != "spec_k"}
    a, b = serve(m, "jax", **kw), serve(m, "torch", **kw)
    assert tokens(b) == tokens(serve(m, "torch", **plain_kw))
    assert tokens(a) == tokens(b)
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_allclose(rb.logprobs, ra.logprobs, **LP_TOL)
        np.testing.assert_array_equal(ra.trace, rb.trace)
        assert ra.offload_bytes == rb.offload_bytes
        assert ra.finish_reason == rb.finish_reason
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    assert a.spec_report == b.spec_report
    for f in ("chunks", "chunk", "generated_tokens", "prefill_tokens",
              "cache_hbm_bytes"):
        assert getattr(a, f) == getattr(b, f), f
    assert b.spec_report["rounds"] == b.chunks
    assert b.draft_s <= b.decode_s


def test_spec_serve_defaults_from_serve_config(m):
    """``ServeConfig.spec`` gives ``serve``'s defaults, as in JAX."""
    eng = m["torch"][0]
    old = eng.scfg
    try:
        eng.scfg = dataclasses.replace(
            old, spec=dataclasses.replace(old.spec, k=3))
        st = serve(m, "torch", drafter="ngram", seed=0)
    finally:
        eng.scfg = old
    assert st.spec_report == serve(m, "torch", spec_k=3).spec_report


class NeverRight:
    """A drafter that always proposes one token the greedy stream never
    emits."""

    def __init__(self, token):
        self.token = token

    def reset_slot(self, slot, toks):
        pass

    def observe(self, slot, toks):
        pass

    def propose_all(self, num_slots, k):
        return np.full((num_slots, k), self.token, np.int32)


def test_acceptance_edges(m):
    """All rejected (acceptance exactly 0: the bonus token only) and all
    accepted (the self-drafter with a window over the whole stream:
    acceptance exactly 1); tokens equal the plain serve's, and the
    reports equal JAX's."""
    plain = tokens(serve(m, "torch"))
    tok = next(t for t in range(128) if all(t not in row for row in plain))
    never = {side: serve(m, side, spec_k=2, drafter=NeverRight(tok))
             for side in ("jax", "torch")}
    jeng, teng = m["jax"][0], m["torch"][0]
    selfd = {"jax": JDraftModelDrafter.self_draft(
                 jeng.cfg, jeng.params, window=32, quantized=True,
                 kernel_impl="ref"),
             "torch": DraftModelDrafter.self_draft(
                 teng.cfg, teng.params, window=32, quantized=True)}
    full = {side: serve(m, side, spec_k=2, drafter=selfd[side])
            for side in ("jax", "torch")}
    for runs, rate in ((never, 0.0), (full, 1.0)):
        assert tokens(runs["torch"]) == plain
        assert runs["torch"].spec_report["acceptance_rate"] == rate
        rj = dict(runs["jax"].spec_report, drafter=None)
        rt = dict(runs["torch"].spec_report, drafter=None)
        assert rj == rt
        assert runs["jax"].offload_report == runs["torch"].offload_report


def test_streamed_spec_serve_meters_every_byte(m):
    """Streamed 'block' speculation at LRU 3 of 8: every metered byte
    (demand and lookahead warms, wasted ones included) is an observed
    copy, and tokens and traces equal the resident speculative serve."""
    eng, stacks, _ = m["torch"]
    resident = serve(m, "torch", cap=3, spec_k=3)
    eng.attach_offload(stacks, policy="ours", cache_capacity=3)
    eng.attach_streaming(StreamConfig(enabled=True))
    try:
        st = eng.serve(_requests(Request), num_slots=2, chunk=4, spec_k=3)
    finally:
        eng._stream = None
        for lp, s in zip((lp for lp in eng.params["layers"] if "moe" in lp),
                         stacks):
            lp["moe"]["stacks"] = s
    assert tokens(st) == tokens(resident)
    np.testing.assert_array_equal(st.router_trace, resident.router_trace)
    for li, s in enumerate(eng._stores):
        assert s.total_bytes == s.observed_copy_bytes, li
    rep = st.offload_report
    assert rep["observed_copy_bytes"] == rep["total_bytes"] > 0
    sp = st.spec_report
    assert sp["lookahead_prefetch_bytes"] >= sp["draft_overhead_bytes"] > 0
    assert st.stream_report["degraded_tokens"] == 0


def test_sampling_spec_serves_and_reports(m):
    """temperature 0.8: rounds are distribution-preserving rather than
    token-identical; the run completes with full-length results and
    finite log-probs, the residual banning engages (some rejections), and
    the same seed repeats the run."""
    eng = m["torch"][0]
    old = eng.scfg
    try:
        eng.scfg = dataclasses.replace(old, temperature=0.8)
        runs = [serve(m, "torch", spec_k=2, seed=7, drafter=NGramDrafter())
                for _ in range(2)]
    finally:
        eng.scfg = old
    st = runs[0]
    assert sorted(r.uid for r in st.results) == [0, 1, 2]
    for r in st.results:
        assert r.tokens.shape[0] == MAX_NEW
        assert np.isfinite(r.logprobs).all()
    assert 0.0 <= st.spec_report["acceptance_rate"] < 1.0
    assert tokens(runs[1]) == tokens(st)

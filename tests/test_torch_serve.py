"""The port's continuous-batching ``ServeEngine.serve`` against the JAX
engine's, on the CPU: the scheduler (a copy, run through the same
admission, refill, EOS and arrival scripts), slot claim and reset of the
KV cache, per-request termination, results in submission order,
inactive-slot trace masking, and ``serve`` / ``generate`` /
``generate_many`` with byte-metered offload (``policy="ours"``) and the
bandwidth controller, on one weight set and one workload; plus ``score``.

Both engines serve the tiny MoE of ``tests/test_serve_scheduler.py``
(d 64, 2 layers, 4 experts top-2, INT2, top-n 1) in f32 from stacks JAX
compressed, carried into the port by ``bridge.py``.  Greedy tokens,
masked router traces, offload reports, per-request offload bytes and the
controller's plan trace must be bit-equal; log-probs agree within 1e-4
(f32 sums in another order) and ``score`` within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ControlConfig as JControlConfig
from repro.models import init_params as j_init_params
from repro.models.transformer import cache_claim_slot as j_claim
from repro.models.transformer import cache_reset_slot as j_reset
from repro.models.transformer import init_caches as j_init_caches
from repro.serve import ServeEngine as JServeEngine
from repro.serve import controller as j_controller
from repro.serve import scheduler as j_sched
from repro_torch.bridge import params_from_jax
from repro_torch.config import (ControlConfig, ModelConfig, MoEConfig,
                                QuantConfig, ServeConfig)
from repro_torch.models.transformer import (cache_claim_slot,
                                            cache_reset_slot, init_caches)
from repro_torch.serve import ServeEngine
from repro_torch.serve import controller as t_controller
from repro_torch.serve import scheduler as t_sched

from test_serve_scheduler import compress, moe_cfg
import torch_cpu  # noqa: F401  (one intra-op thread per worker)

LP_TOL = dict(rtol=1e-4, atol=1e-4)
SIDES = ("jax", "torch")


def port_moe_cfg() -> ModelConfig:
    """``moe_cfg()`` in the port's config classes, as compressed."""
    return ModelConfig(
        name="tiny-moe", family="moe", num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=0, vocab_size=128,
        block_pattern=("global",), max_position=512, force_unroll_plan=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=16,
                                        top_n_restore=1, hqq_iters=3)))


@pytest.fixture(scope="module")
def m():
    """One compressed weight set and one engine per side, for the module
    (each JAX serve shape compiles once)."""
    params = j_init_params(jax.random.key(4), moe_cfg(), jnp.float32)
    cfg_q, qparams, jstacks = compress(moe_cfg(), params)
    tq = params_from_jax(jax.tree.map(np.asarray, qparams), "cpu")
    return {
        "jax": (JServeEngine(cfg_q, qparams, quantized=True), jstacks,
                j_sched),
        "torch": (ServeEngine(port_moe_cfg(), tq, quantized=True,
                              device="cpu"),
                  [lp["moe"]["stacks"] for lp in tq["layers"]
                   if "moe" in lp], t_sched),
        "cfg_q": cfg_q, "tq": tq}


def _offload(eng, stacks, control=None, cap=2):
    """Fresh stores (cold LRU) and, when given, a fresh controller.  Both
    engines keep an earlier controller across ``attach_offload``
    (``test_attach_offload_keeps_controller_like_jax``), so a test's
    fresh start clears it on both sides alike."""
    eng.attach_offload(stacks, policy="ours", cache_capacity=cap)
    eng._controller = None
    if control is not None:
        eng.attach_controller(control)


def _no_offload(eng):
    eng._stores = eng._prefetcher = eng._controller = None


def _control(side, **kw):
    return (JControlConfig if side == "jax" else ControlConfig)(**kw)


def _workload(sched_mod, n=10, **kw):
    kw = dict(max_new=7, min_len=3, max_len=40, seed=1) | kw
    return sched_mod.synthetic_workload(n, 128, **kw)


def serve_both(m, make_reqs, *, offload=True, control=None, **serve_kw):
    """{side: ServeStats} of the same requests (``make_reqs(sched
    module)``) through both engines."""
    out = {}
    for side in SIDES:
        eng, stacks, sched_mod = m[side]
        if offload:
            _offload(eng, stacks,
                     None if control is None else _control(side, **control))
        else:
            _no_offload(eng)
        out[side] = eng.serve(make_reqs(sched_mod), **serve_kw)
    return out


def assert_same_serve(a, b):
    """Bit-equal tokens, traces, reports, per-request bytes and plans."""
    assert [r.uid for r in a.results] == [r.uid for r in b.results]
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        np.testing.assert_allclose(rb.logprobs, ra.logprobs, **LP_TOL)
        assert ra.finish_reason == rb.finish_reason
        assert ra.prompt_len == rb.prompt_len
        assert ra.offload_bytes == rb.offload_bytes
        if ra.trace is None:
            assert rb.trace is None
        else:
            np.testing.assert_array_equal(ra.trace, rb.trace)
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    for f in ("chunks", "generated_tokens", "prefill_tokens",
              "cache_hbm_bytes", "num_slots", "chunk",
              "cache_hbm_bytes_per_token"):
        assert getattr(a, f) == getattr(b, f), f
    # the wall-clock properties: JAX's definitions on the port's fields
    for f in ("cache_hbm_bytes_per_token", "busy_s",
              "goodput_tokens_per_s", "busy_frac"):
        assert getattr(type(a), f).fget(b) == getattr(b, f), f
    assert 0 < b.busy_frac <= 1
    if a.plan_trace is None:
        assert b.plan_trace is None
    else:
        np.testing.assert_array_equal(a.plan_trace, b.plan_trace)


# ---------------------------------------------------------------------------
# the scheduler (host copy) and the workload generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 5.0])
def test_synthetic_workload_matches_jax(rate):
    a = _workload(j_sched, n=9, rate=rate, seed=3)
    b = _workload(t_sched, n=9, rate=rate, seed=3)
    for ra, rb in zip(a, b):
        assert (ra.uid, ra.max_new, ra.arrival_s, ra.eos_id) == \
            (rb.uid, rb.max_new, rb.arrival_s, rb.eos_id)
        np.testing.assert_array_equal(ra.tokens, rb.tokens)


def _req(mod, uid, plen=4, max_new=3, eos=None, arrival=0.0):
    return mod.Request(uid=uid, tokens=np.zeros(plen, np.int32),
                       max_new=max_new, eos_id=eos, arrival_s=arrival)


def _admission_refill(mod):
    s = mod.Scheduler(2)
    for i in range(5):
        s.submit(_req(mod, i, max_new=2))
    log = [s.admit(0.0), s.admit(0.0)]
    toks = np.arange(6).reshape(2, 3)
    lps = np.zeros((2, 3), np.float32)
    log.append(s.record_chunk(toks, lps, None, now=1.0, t_start=0.5))
    log += [s.admit(1.0), s.record_chunk(toks, lps, None, now=2.0),
            s.admit(2.0), s.has_work(),
            s.record_chunk(toks[:1], lps[:1], None, now=3.0), s.has_work()]
    return log, s


def _zero_budget(mod):
    s = mod.Scheduler(1)
    s.submit(_req(mod, 0, max_new=0))
    log = [s.admit(0.0), s.record_chunk(np.zeros((1, 2), np.int64),
                                        np.zeros((1, 2), np.float32), None,
                                        1.0)]
    return log, s


def _eos_and_arrival(mod):
    s = mod.Scheduler(1)
    s.submit(_req(mod, 0, max_new=8, eos=7))
    s.submit(_req(mod, 1, max_new=8, arrival=100.0))
    log = [s.admit(0.0)]
    tr = np.arange(3 * 2 * 1 * 2).reshape(3, 2, 1, 2)
    log += [s.record_chunk(np.array([[3, 7, 5]]),
                           np.zeros((1, 3), np.float32), tr, 1.0),
            s.admit(1.0), s.next_arrival(), s.admit(100.5),
            s.uid_by_slot(), s.active_mask()]
    s.add_slot_bytes(np.array([11]), {0: 0})
    s.add_slot_bytes(np.array([5]), {0: 1})
    return log, s


def _norm(x):
    """A scheduler output in a comparable form: ``admit``'s (slot,
    request) pairs by uid, arrays as lists."""
    if isinstance(x, list):
        return [(i, r.uid) for i, r in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


@pytest.mark.parametrize("script", [_admission_refill, _zero_budget,
                                    _eos_and_arrival])
def test_scheduler_matches_jax(script):
    """The same admission / refill / EOS / arrival script through both
    schedulers: the same admissions, accepted masks and finished
    results (tokens, reasons, stamps, attributed bytes)."""
    (la, sa), (lb, sb) = script(j_sched), script(t_sched)
    assert [_norm(v) for v in la] == [_norm(v) for v in lb]
    assert len(sa.finished) == len(sb.finished) > 0
    for ra, rb in zip(sa.finished, sb.finished):
        da, db = dataclasses.asdict(ra), dataclasses.asdict(rb)
        for key in da:
            if isinstance(da[key], np.ndarray):
                np.testing.assert_array_equal(da[key], db[key])
            elif da[key] != da[key]:                  # NaN first-token
                assert db[key] != db[key]
            else:
                assert da[key] == db[key], key


# ---------------------------------------------------------------------------
# slot-indexed cache ops
# ---------------------------------------------------------------------------

def _jax_layers(caches):
    """A JAX cache tree's per-layer dicts in layer order (a scanned
    segment's leaves carry a leading repeat axis)."""
    out = []
    for seg in caches["segments"]:
        rep = seg[0]["pos"].shape[0] if seg[0]["pos"].ndim == 3 else 0
        for r in range(max(rep, 1)):
            out += [{k: np.array(v[r] if rep else v) for k, v in c.items()}
                    for c in seg]
    return out


def _assert_same_caches(jc, tc):
    for a, b in zip(_jax_layers(jc), tc["layers"]):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(b[key].numpy(), a[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_cache_claim_and_reset_slot_match_jax():
    """Claiming a random batch-1 request cache into slot 1 of three, then
    resetting it, gives JAX's caches; both happen in place."""
    cfg = moe_cfg()
    rng = np.random.default_rng(0)
    jreq = jax.tree.map(
        lambda x: jnp.asarray(rng.integers(0, 50, x.shape).astype(x.dtype)),
        j_init_caches(cfg, 1, max_len=32, dtype=jnp.float32))
    jc = j_init_caches(cfg, 3, max_len=32, dtype=jnp.float32)
    tc = init_caches(port_moe_cfg(), 3, 32, torch.float32, device="cpu")
    treq = init_caches(port_moe_cfg(), 1, 32, torch.float32, device="cpu")
    for dst, src in zip(treq["layers"], _jax_layers(jreq)):
        for key in dst:
            dst[key].copy_(torch.from_numpy(src[key]))
    treq["pos"].copy_(torch.from_numpy(np.asarray(jreq["pos"])))
    ptrs = [t.data_ptr() for c in tc["layers"] for t in c.values()]
    jc = j_claim(cfg, jc, jreq, 1)
    assert cache_claim_slot(port_moe_cfg(), tc, treq, 1) is tc
    _assert_same_caches(jc, tc)
    assert int(tc["pos"][1]) == int(treq["pos"][0]) > 0
    jc = j_reset(cfg, jc, 1)
    assert cache_reset_slot(port_moe_cfg(), tc, 1) is tc
    _assert_same_caches(jc, tc)
    assert (tc["layers"][0]["pos"][1] == -1).all()
    assert ptrs == [t.data_ptr() for c in tc["layers"] for t in c.values()]


# ---------------------------------------------------------------------------
# serve() against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,chunk", [(4, 3), (2, 4)])
def test_serve_with_offload_matches_jax(m, slots, chunk):
    """A ragged workload (10 requests, prompts of 3..40 tokens) with
    ``policy="ours"`` on a 2-expert LRU: tokens, masked router traces,
    the offload report and each request's bytes bit-equal to JAX's."""
    out = serve_both(m, _workload, num_slots=slots, chunk=chunk)
    assert_same_serve(out["jax"], out["torch"])
    rep = out["torch"].offload_report
    assert rep["total_bytes"] > 0 and rep["compensator_bytes"] > 0
    assert sum(r.offload_bytes for r in out["torch"].results) == \
        rep["demand_bytes"] + rep["compensator_bytes"]
    assert out["torch"].meter_s > 0


def test_serve_per_request_termination_matches_jax(m):
    """EOS on one request, a short budget on another: each stops where
    JAX's does (EOS included), and the rest run to their budget."""
    eng = m["torch"][0]
    _no_offload(eng)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, (6,), dtype=np.int32) for _ in range(3)]
    ref = eng.generate_many(prompts, max_new=6, num_slots=2, chunk=3)
    eos = int(ref.results[0].tokens[2])

    def reqs(mod):
        return [mod.Request(uid=0, tokens=prompts[0], max_new=6, eos_id=eos),
                mod.Request(uid=1, tokens=prompts[1], max_new=4),
                mod.Request(uid=2, tokens=prompts[2], max_new=6)]

    out = serve_both(m, reqs, offload=False, num_slots=2, chunk=3)
    assert_same_serve(out["jax"], out["torch"])
    r0, r1, r2 = out["torch"].results
    assert (r0.finish_reason, r0.gen_tokens, int(r0.tokens[-1])) == \
        ("eos", 3, eos)
    assert (r1.finish_reason, r1.gen_tokens) == ("length", 4)
    assert (r2.finish_reason, r2.gen_tokens) == ("length", 6)
    assert r0.trace.shape == (3, 2, 2)


def test_serve_results_in_submission_order(m):
    """Serving order follows arrivals (uid 11 at t 0, uid 10 at 0.3 s on
    one slot); results come back in submission order, as JAX's do."""
    def reqs(mod):
        return [mod.Request(uid=10, tokens=np.arange(9, dtype=np.int32),
                            max_new=2, arrival_s=0.3),
                mod.Request(uid=11, tokens=np.arange(4, dtype=np.int32),
                            max_new=3, arrival_s=0.0)]

    out = serve_both(m, reqs, offload=False, num_slots=1, chunk=2)
    a, b = out["jax"], out["torch"]
    assert [r.uid for r in b.results] == [10, 11]
    assert [r.prompt_len for r in b.results] == [9, 4]
    assert [r.gen_tokens for r in b.results] == [2, 3]
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert rb.admitted_s >= rb.arrival_s and rb.ttft_s >= 0
    assert b.results[0].admitted_s >= 0.3


def test_serve_inactive_slot_trace_masking_matches_jax(m):
    """A never-used slot and retired slots are -1 in the aggregate trace
    and excluded from the token count."""
    def reqs(mod):
        return [mod.Request(uid=0, tokens=np.zeros(4, np.int32), max_new=5),
                mod.Request(uid=1, tokens=np.zeros(6, np.int32), max_new=2)]

    out = serve_both(m, reqs, num_slots=3, chunk=4)
    assert_same_serve(out["jax"], out["torch"])
    tr = out["torch"].router_trace
    assert tr.shape[2] == 3 and (tr[:, :, 2, :] == -1).all()
    assert {int((tr[:, 0, i, 0] >= 0).sum()) for i in (0, 1)} == {5, 2}
    assert out["torch"].generated_tokens == 7
    assert out["torch"].offload_report["tokens"] == 7


def test_controller_plan_trace_matches_jax(m):
    """Under a bytes/token budget the per-chunk (top_n, rank_cap) plans,
    the tokens they decode and the bytes they meter are JAX's, and the
    plan moves."""
    static = serve_both(m, _workload, num_slots=4, chunk=3)["torch"]
    budget = 0.6 * static.offload_report["bytes_per_token"]
    out = serve_both(m, _workload, num_slots=4, chunk=3,
                     control=dict(enabled=True, bytes_per_token=budget))
    assert_same_serve(out["jax"], out["torch"])
    pt = out["torch"].plan_trace
    assert pt.shape == (out["torch"].chunks, 2, 2)
    assert len({p.tobytes() for p in pt}) > 1
    hist = m["torch"][0].controller.history
    assert [h.level for h in hist] == \
        [h.level for h in m["jax"][0].controller.history]


@pytest.mark.parametrize("control", [dict(enabled=False),
                                     dict(enabled=True),
                                     dict(enabled=False,
                                          bytes_per_token=100.0)])
def test_inactive_controller_bit_identical_to_none(m, control):
    """A controller that has no budget (or is off) pins the static plan:
    tokens, log-probs, traces and bytes equal to serving with none."""
    eng, stacks, _ = m["torch"]
    _offload(eng, stacks)
    base = eng.serve(_workload(t_sched), num_slots=4, chunk=3)
    _offload(eng, stacks, ControlConfig(**control))
    got = eng.serve(_workload(t_sched), num_slots=4, chunk=3)
    for ra, rb in zip(base.results, got.results):
        np.testing.assert_array_equal(ra.logprobs, rb.logprobs)
    got.plan_trace, base.plan_trace = None, None
    assert_same_serve(base, got)
    assert not eng.controller.active


def test_serve_config_control_attaches_controller(m):
    eng, stacks, _ = m["torch"]
    cc = ControlConfig(enabled=True, bytes_per_token=1000.0)
    auto = ServeEngine(eng.cfg, eng.params, ServeConfig(control=cc),
                       quantized=True, device="cpu")
    auto.attach_offload(stacks)
    assert auto.controller is not None and auto.controller.active
    assert auto.controller.ccfg == cc
    assert auto._stores[0].cache.capacity == ServeConfig().cache_experts


def test_attach_offload_keeps_controller_like_jax(m):
    """On both engines ``attach_offload`` renews the stores and (with
    ``prefetch``) the prefetcher, keeps an attached controller, and with
    ``prefetch=False`` keeps the prefetcher it had."""
    kept = {}
    for side in SIDES:
        eng, stacks, _ = m[side]
        _offload(eng, stacks, _control(side, enabled=True,
                                       bytes_per_token=500.0))
        ctrl, pf, stores = eng.controller, eng._prefetcher, eng._stores
        eng.attach_offload(stacks, policy="ours", cache_capacity=2)
        renewed = (eng._stores is not stores, eng._prefetcher is not pf)
        pf = eng._prefetcher
        eng.attach_offload(stacks, policy="ours", cache_capacity=2,
                           prefetch=False)
        kept[side] = (renewed, eng.controller is ctrl,
                      eng._prefetcher is pf)
        _no_offload(eng)
    assert kept["jax"] == kept["torch"] == ((True, True), True, True)


def test_serve_matches_fixed_batch_offload_report(m):
    """Four requests on four slots equal the same prompts as one fixed
    ``generate`` batch: tokens, trace and offload report byte for byte
    (the JAX package's ``test_serve_matches_fixed_batch_offload_report``
    case, inside the port)."""
    eng, stacks, _ = m["torch"]
    prompts = np.random.default_rng(5).integers(0, 128, (4, 6),
                                                dtype=np.int32)
    _offload(eng, stacks)
    ra = eng.generate(prompts, max_new=8)
    _offload(eng, stacks)
    sb = eng.generate_many(list(prompts), max_new=8, num_slots=4, chunk=4)
    np.testing.assert_array_equal(
        ra.tokens, np.stack([r.tokens for r in sb.results]))
    np.testing.assert_array_equal(ra.router_trace, sb.router_trace)
    assert ra.offload_report == sb.offload_report
    rep = sb.offload_report
    assert rep["total_bytes"] > 0
    assert sum(r.offload_bytes for r in sb.results) == \
        rep["demand_bytes"] + rep["compensator_bytes"]


def test_generate_offload_and_controller_match_jax(m):
    """``generate`` with stores and a budgeted controller: JAX's tokens,
    trace and offload report, and the same controller step after it."""
    prompts = np.random.default_rng(8).integers(0, 128, (3, 7),
                                                dtype=np.int32)
    got = {}
    for side in SIDES:
        eng, stacks, _ = m[side]
        _offload(eng, stacks, _control(side, enabled=True,
                                       bytes_per_token=5000.0))
        got[side] = eng.generate(prompts, max_new=6)
        got[side + "_level"] = eng.controller.level
    a, b = got["jax"], got["torch"]
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    for row in range(3):
        assert b.request_trace(row).shape == (6, 2, 2)
        np.testing.assert_array_equal(a.request_trace(row),
                                      b.request_trace(row))
    np.testing.assert_allclose(b.logprobs, a.logprobs, **LP_TOL)
    assert a.offload_report == b.offload_report
    assert got["jax_level"] == got["torch_level"]


def test_generate_many_matches_jax(m):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, (int(n),), dtype=np.int32)
               for n in (4, 7, 9, 12, 5)]
    out = {}
    for side in SIDES:
        eng = m[side][0]
        _no_offload(eng)
        out[side] = eng.generate_many(prompts, max_new=5, num_slots=2,
                                      chunk=4)
    assert_same_serve(out["jax"], out["torch"])
    assert [r.gen_tokens for r in out["torch"].results] == [5] * 5


def test_score_matches_jax(m):
    tokens = np.random.default_rng(2).integers(0, 128, (3, 20),
                                               dtype=np.int32)
    a = m["jax"][0].score(tokens)
    b = m["torch"][0].score(tokens)
    assert abs(a - b) <= 1e-5 * max(abs(a), 1.0)


# ---------------------------------------------------------------------------
# the controller (host copy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(bytes_per_token=900.0),
    dict(bytes_per_token=300.0, max_top_n=1, rank_fracs=(0.5, 1.0)),
    dict(tokens_per_s=1e6, link_bw=2e9, deadband=0.0)])
def test_controller_copy_matches_jax(kw):
    """The same metered byte sequence gives the same levels and plans."""
    rng = np.random.default_rng(4)
    feed = [(int(rng.integers(0, 40000)), int(rng.integers(1, 40)))
            for _ in range(25)]
    plans = []
    for mod, cc in ((j_controller, JControlConfig),
                    (t_controller, ControlConfig)):
        c = mod.BandwidthController([16, 32, 8], 2, cc(enabled=True, **kw),
                                    static_top_n=1)
        seq = [c.plan().as_array().tolist()]
        for nbytes, ntok in feed:
            seq.append(c.update(nbytes, ntok).as_array().tolist())
        plans.append((seq, [h.level for h in c.history], c.max_level,
                      mod.static_plan([16, 32], 1).as_array().tolist()))
    assert plans[0] == plans[1]
    assert len({str(p) for p in plans[1][0]}) > 1

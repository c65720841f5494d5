"""The port's paged KV cache against the JAX package's, on the CPU: the
host page allocator (``PagePool``, ``prefix_page_hashes``) on seeded
random operation sequences, each paged cache function of
``models/kvcache.py`` on the same numpy inputs (f32 and int8 planes),
the paged flash-decode wrapper's plain route, and ``ServeEngine.serve``
with ``page_size`` / ``prefix_cache`` / ``pool_pages`` (JAX's ragged mix,
int8 KV, shared-prefix reuse, parking and reviving prefix pages, and
expert streaming under 'block'); plus the port's own contract that paged
serving is token-identical to the contiguous cache and leaks no page.

Both engines serve the tiny MoE of ``tests/test_serve_scheduler.py``
(d 64, 2 layers, 4 experts top-2, INT2, top-n 1) in f32 from stacks JAX
compressed, carried into the port by ``bridge.py``.  Tokens, masked
router traces, page reports, prefill tokens, cache bytes, offload
reports and per-request offload bytes must be bit-equal; log-probs agree
within 1e-4 (f32 sums in another order).  Cache planes are compared bit
for bit outside the trash page: several writes of one call may land on
that write sink, and neither framework defines which of them wins."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import StreamConfig as JStreamConfig
from repro.models import init_params as j_init_params
from repro.models import kvcache as j_kv
from repro.models.attention import decode_attention as j_decode_attention
from repro.serve import ServeEngine as JServeEngine
from repro.serve import paging as j_paging
from repro.serve.scheduler import Request as JRequest
from repro_torch.bridge import params_from_jax
from repro_torch.config import StreamConfig
from repro_torch.kernels import decode_attention as t_fd
from repro_torch.models import kvcache as t_kv
from repro_torch.serve import ServeEngine
from repro_torch.serve import paging as t_paging
from repro_torch.serve.scheduler import Request

from test_serve_scheduler import compress, moe_cfg
from test_torch_serve import port_moe_cfg
import torch_cpu  # noqa: F401  (one intra-op thread per worker)

LP_TOL = dict(rtol=1e-4, atol=1e-4)
SIDES = ("jax", "torch")
RAGGED = ((5, 7), (19, 4), (33, 9), (9, 3), (12, 6), (24, 5))


# ---------------------------------------------------------------------------
# the page allocator
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (list(pool.refcount), sorted(pool._free), list(pool._parked),
            dict(pool._page_of_hash), pool.report())


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_random_ops_match_jax(seed):
    """One seeded sequence of alloc / retain / release / lookup /
    register on both pools: equal page ids, refcounts, free lists,
    parked pages, registrations and reports after every operation (and
    equal raises where an operation is refused)."""
    rng = np.random.default_rng(seed)
    pools = [j_paging.PagePool(13, 4), t_paging.PagePool(13, 4)]
    prefixes = [rng.integers(0, 50, (24,)).tolist() for _ in range(3)]
    held = []                      # page lists holding one reference each
    for _ in range(200):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 5))
            args = ("alloc", n)
        elif op == 1 and held:
            args = ("retain", held[int(rng.integers(len(held)))])
        elif op == 2 and held:
            args = ("release", held.pop(int(rng.integers(len(held)))))
        elif op == 3:
            toks = prefixes[int(rng.integers(3))][:int(rng.integers(4, 25))]
            args = ("lookup", j_paging.prefix_page_hashes(toks, 4))
        elif op == 4 and held:
            pages = held[int(rng.integers(len(held)))]
            toks = prefixes[int(rng.integers(3))]
            hashes = j_paging.prefix_page_hashes(toks, 4)
            args = ("register", pages[0], hashes[int(rng.integers(6))])
        else:
            continue
        outs = []
        for pool in pools:
            try:
                outs.append(getattr(pool, args[0])(*args[1:]))
            except RuntimeError as e:
                outs.append(("raised", str(e)))
        assert outs[0] == outs[1], args
        if args[0] == "alloc" and not isinstance(outs[0], tuple):
            held.append(outs[0])
        elif args[0] == "retain":
            held.append(args[1])
        elif args[0] == "lookup" and outs[0]:
            for pool in pools:
                pool.retain(outs[0])
            held.append(outs[0])
        assert _pool_state(pools[0]) == _pool_state(pools[1])
    for pages in held:
        for pool in pools:
            pool.release(pages)
    for pool in pools:
        pool.check_leaks()
    assert _pool_state(pools[0]) == _pool_state(pools[1])


@pytest.mark.parametrize("ps", [1, 4, 8])
def test_prefix_page_hashes_match_jax(ps):
    toks = np.random.default_rng(ps).integers(0, 1000, (37,)).tolist()
    assert t_paging.prefix_page_hashes(toks, ps) == \
        j_paging.prefix_page_hashes(toks, ps)


# ---------------------------------------------------------------------------
# the paged cache functions
# ---------------------------------------------------------------------------

P, PS, NB, B, KVH, HD = 9, 4, 5, 3, 2, 8


def _pool(kv_bits, seed=0):
    """Random pool planes (numpy), a block table with pages in random
    order, one page mapped by two rows, -1 entries and a row of -1s."""
    rng = np.random.default_rng(seed)
    shape = (P, PS, KVH, HD)
    planes = {"pos": rng.integers(-1, 40, (P, PS)).astype(np.int32)}
    if kv_bits == 8:
        planes["k"] = rng.integers(-127, 128, shape).astype(np.int8)
        planes["v"] = rng.integers(-127, 128, shape).astype(np.int8)
        # absmax / 127 of unit-scale rows, as ``_kv_quant`` makes them
        for n in ("k_scale", "v_scale"):
            planes[n] = (rng.random(shape[:3]) * 0.02 + 0.005).astype(
                np.float32)
    else:
        planes["k"] = rng.standard_normal(shape).astype(np.float32)
        planes["v"] = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, P)).astype(np.int32)
    block = np.full((B, NB), -1, np.int32)
    block[0, :4] = perm[:4]
    block[1, :3] = [perm[4], perm[0], perm[5]]      # perm[0] shared
    # row 2: every entry unmapped
    planes["block"] = block
    return planes


def _to_jax(planes):
    out = {}
    for n, a in planes.items():
        out[n] = jnp.asarray(a, jnp.bfloat16 if "scale" in n else None)
    return out


def _to_torch(planes):
    out = {}
    for n, a in planes.items():
        t = torch.from_numpy(np.array(a))
        out[n] = t.to(torch.bfloat16) if "scale" in n else t
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_planes(j, t, skip_trash=False):
    assert set(j) == set(t)
    for n in j:
        a, b = _np(j[n]), _np(t[n])
        if skip_trash and n != "block":
            a, b = a[1:], b[1:]
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_init_paged_attn_cache_matches_jax(kv_bits):
    j = j_kv.init_paged_attn_cache(B, P, PS, NB, KVH, HD, jnp.float32,
                                   kv_bits=kv_bits)
    t = t_kv.init_paged_attn_cache(B, P, PS, NB, KVH, HD, torch.float32,
                                   kv_bits=kv_bits)
    assert_planes(j, t)
    assert t_kv.is_paged(t) and not t_kv.is_paged({"k": 0})
    assert_planes(j, t_kv.reset_attn_cache(_to_torch(_pool(kv_bits))))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_update_and_gather_match_jax(kv_bits):
    planes = _pool(kv_bits)
    rng = np.random.default_rng(1)
    # positions inside the mapped range, past it and through -1 entries
    pos = np.array([[3, 14], [9, 11], [2, 30]], np.int32)
    kn = rng.standard_normal((B, 2, KVH, HD)).astype(np.float32)
    vn = rng.standard_normal((B, 2, KVH, HD)).astype(np.float32)
    jp, jo = j_kv._page_targets(_to_jax(planes), jnp.asarray(pos))
    tp, to = t_kv._page_targets(_to_torch(planes), torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    j = j_kv.paged_update_attn_cache(_to_jax(planes), jnp.asarray(kn),
                                     jnp.asarray(vn), jnp.asarray(pos))
    t = t_kv.paged_update_attn_cache(_to_torch(planes),
                                     torch.from_numpy(kn),
                                     torch.from_numpy(vn),
                                     torch.from_numpy(pos))
    assert_planes(j, t, skip_trash=True)
    for a, b in zip(j_kv.paged_gather(_to_jax(planes)),
                    t_kv.paged_gather(_to_torch(planes))):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_claim_reset_seed_match_jax(kv_bits):
    planes = _pool(kv_bits)
    rng = np.random.default_rng(2)
    L = 3 * PS                      # a batch-1 request cache of 3 pages
    req = {"pos": np.where(np.arange(L) < 10, np.arange(L), -1)
           .astype(np.int32)[None]}
    kind = np.int8 if kv_bits == 8 else np.float32
    for n in ("k", "v"):
        req[n] = (rng.integers(-127, 128, (1, L, KVH, HD)) if kv_bits == 8
                  else rng.standard_normal((1, L, KVH, HD))).astype(kind)
    if kv_bits == 8:
        for n in ("k_scale", "v_scale"):
            req[n] = rng.random((1, L, KVH)).astype(np.float32)
    pages = np.array([5, 2, 7, 1, -1], np.int32)
    mask = np.array([False, True, True, True, False])   # page 5 shared
    j = j_kv.paged_claim(_to_jax(planes), _to_jax(req), 2,
                         jnp.asarray(pages), jnp.asarray(mask))
    t = t_kv.paged_claim(_to_torch(planes), _to_torch(req), 2,
                         torch.from_numpy(pages), torch.from_numpy(mask))
    assert_planes(j, t, skip_trash=True)
    assert_planes(j_kv.paged_reset(j, 0), t_kv.paged_reset(t, 0),
                  skip_trash=True)
    seed = np.array([5, 2, -1, -1, -1], np.int32)
    req2 = {n: np.zeros_like(a) for n, a in req.items()}
    js = j_kv.paged_seed_prefix(_to_jax(req2), j, jnp.asarray(seed))
    ts = t_kv.paged_seed_prefix(_to_torch(req2), t, torch.from_numpy(seed))
    assert_planes(js, ts)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_flash_decode_plain_matches_jax(kv_bits):
    """The wrapper's CPU route (gather, then the contiguous plain
    version) against JAX's paged decode (gather, then
    ``decode_attention``), rows at their own positions, one row with
    every block entry unmapped."""
    planes = _pool(kv_bits)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 1, 2 * KVH, HD)).astype(np.float32)
    cur = np.array([13, 9, 4], np.int32)
    jc = _to_jax(planes)
    kf, vf, pf, ksf, vsf = j_kv.paged_gather(jc)
    want = j_decode_attention(jnp.asarray(q), kf, vf, pf, jnp.asarray(cur),
                              k_scale=ksf, v_scale=vsf)
    tc = _to_torch(planes)
    got = t_fd.flash_decode_attention_paged(
        torch.from_numpy(q[:, 0]) / np.sqrt(HD), tc["k"], tc["v"],
        tc["pos"], tc["block"], torch.from_numpy(cur), tc.get("k_scale"),
        tc.get("v_scale"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        t_fd.flash_decode_attention_paged(
            torch.from_numpy(q[:, 0]), tc["k"], tc["v"], tc["pos"],
            tc["block"], torch.from_numpy(cur), tc.get("k_scale"),
            tc.get("v_scale"), require_kernel=True)


# ---------------------------------------------------------------------------
# paged serving, port vs JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def m():
    """One compressed weight set and, per side, an f32 engine and an
    int8-KV engine over it."""
    params = j_init_params(jax.random.key(4), moe_cfg(), jnp.float32)
    cfg_q, qparams, jstacks = compress(moe_cfg(), params)
    tq = params_from_jax(jax.tree.map(np.asarray, qparams), "cpu")
    tstacks = [lp["moe"]["stacks"] for lp in tq["layers"] if "moe" in lp]
    tcfg = port_moe_cfg()
    return {
        "jax": {16: JServeEngine(cfg_q, qparams, quantized=True),
                8: JServeEngine(dataclasses.replace(cfg_q, kv_bits=8),
                                qparams, quantized=True),
                "stacks": jstacks, "req": JRequest},
        "torch": {16: ServeEngine(tcfg, tq, quantized=True, device="cpu"),
                  8: ServeEngine(dataclasses.replace(tcfg, kv_bits=8), tq,
                                 quantized=True, device="cpu"),
                  "stacks": tstacks, "req": Request}}


def _reqs(req_cls, mix=RAGGED, prefix=0, seed=0, vocab=128):
    """JAX's ``tests/test_paged_cache.py`` workload: ragged prompts, with
    an optional shared system prompt of ``prefix`` tokens."""
    rng = np.random.default_rng(seed)
    sysp = (np.arange(1, prefix + 1, dtype=np.int32) % vocab)
    out = []
    for i, (plen, max_new) in enumerate(mix):
        toks = rng.integers(1, vocab, (plen,), dtype=np.int32)
        if prefix:
            toks = np.concatenate([sysp, toks])
        out.append(req_cls(uid=i, tokens=toks, max_new=max_new))
    return out


def _serve(m, side, *, kv_bits=16, offload=True, cap=3, **kw):
    eng = m[side][kv_bits]
    if offload:
        eng.attach_offload(m[side]["stacks"], policy="ours",
                           cache_capacity=cap)
    else:
        eng._stores = eng._prefetcher = None
    eng._controller = None
    eng._stream = None
    st = eng.serve(_reqs(m[side]["req"], **kw.pop("workload", {})), **kw)
    return eng, st


def assert_same(a, b):
    assert [r.uid for r in a.results] == [r.uid for r in b.results]
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        np.testing.assert_allclose(rb.logprobs, ra.logprobs, **LP_TOL)
        assert ra.offload_bytes == rb.offload_bytes
        assert ra.finish_reason == rb.finish_reason
        np.testing.assert_array_equal(ra.trace, rb.trace)
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    assert a.page_report == b.page_report
    for f in ("chunks", "generated_tokens", "prefill_tokens",
              "cache_hbm_bytes", "cache_hbm_bytes_per_token"):
        assert getattr(a, f) == getattr(b, f), f


SERVE_CASES = {
    "ragged": dict(num_slots=3, chunk=4, page_size=8),
    "int8-kv": dict(kv_bits=8, num_slots=2, chunk=4, page_size=8,
                    workload=dict(mix=((6, 6), (25, 7), (14, 4)), seed=4)),
    "prefix": dict(num_slots=3, chunk=4, page_size=8, prefix_cache=True,
                   workload=dict(prefix=24, seed=1)),
    "park-revive": dict(num_slots=1, chunk=4, page_size=8,
                        prefix_cache=True, pool_pages=12,
                        workload=dict(mix=((9, 3), (11, 3), (7, 3)),
                                      prefix=16, seed=5)),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_paged_serve_matches_jax(m, case):
    out = {side: _serve(m, side, **dict(SERVE_CASES[case]))
           for side in SIDES}
    (je, a), (te, b) = out["jax"], out["torch"]
    assert_same(a, b)
    te._page_pool.check_leaks()
    assert all(r == 0 for r in te._page_pool.refcount)
    rep = b.page_report
    if case == "prefix":
        assert rep["peak_shared_ref"] >= 2 and rep["prefix_hits"] > 0
    if case == "park-revive":
        assert rep["prefix_hits"] > 0 and rep["evictions"] == 0
        assert rep["num_pages"] == 12


@pytest.mark.parametrize("case", ["ragged", "int8-kv", "prefix"])
def test_paged_serve_token_identical_to_contiguous(m, case):
    """Within the port: paging changes where the K/V rows live, not what
    attention computes; the paged pool holds fewer bytes than the
    contiguous buckets, and prefix reuse prefills fewer tokens."""
    kw = dict(SERVE_CASES[case])
    kw.pop("page_size"), kw.pop("prefix_cache", None)
    _, base = _serve(m, "torch", **kw)
    eng, paged = _serve(m, "torch", page_size=8, **kw)
    eng._page_pool.check_leaks()
    assert [r.tokens.tolist() for r in base.results] == \
        [r.tokens.tolist() for r in paged.results]
    for x, y in zip(base.results, paged.results):
        np.testing.assert_allclose(y.logprobs, x.logprobs, **LP_TOL)
    assert base.offload_report == paged.offload_report
    assert paged.cache_hbm_bytes < base.cache_hbm_bytes
    if case == "prefix":
        _, pre = _serve(m, "torch", page_size=8, prefix_cache=True, **kw)
        assert [r.tokens.tolist() for r in pre.results] == \
            [r.tokens.tolist() for r in paged.results]
        assert pre.prefill_tokens < paged.prefill_tokens
        assert pre.page_report["peak_shared_ref"] >= 2


def test_serve_config_page_size_and_prefix_cache(m):
    """``ServeConfig.page_size`` / ``prefix_cache`` are the defaults of
    ``serve``'s arguments, as in JAX."""
    eng = m["torch"][16]
    old = eng.scfg
    try:
        eng.scfg = dataclasses.replace(old, page_size=8, prefix_cache=True)
        _, st = _serve(m, "torch", num_slots=3, chunk=4,
                       workload=dict(prefix=24, seed=1))
    finally:
        eng.scfg = old
    _, want = _serve(m, "torch", **dict(SERVE_CASES["prefix"]))
    assert st.page_report == want.page_report
    assert st.prefill_tokens == want.prefill_tokens


def _moe_params(eng, side):
    layers = (eng.params["layers"] if side == "torch" else
              [lp for seg in eng.params["segments"] for lp in seg])
    return [lp["moe"] for lp in layers
            if isinstance(lp, dict) and isinstance(lp.get("moe"), dict)
            and "stacks" in lp["moe"]]


def _streamed_serve(m, side, **kw):
    """``serve(**kw)`` on the side's engine under expert streaming
    ('block', LRU 3 of 4), its true stacks put back afterwards."""
    eng, stacks = m[side][16], m[side]["stacks"]
    eng.attach_offload(stacks, policy="ours", cache_capacity=3)
    eng._controller = None
    eng.attach_streaming((JStreamConfig if side == "jax"
                          else StreamConfig)(enabled=True))
    try:
        return eng.serve(_reqs(m[side]["req"]), num_slots=3, chunk=4, **kw)
    finally:
        eng._stream = None
        for mp, s in zip(_moe_params(eng, side), stacks):
            mp["stacks"] = s


def test_paged_serve_raises_like_jax(m):
    """A page size that is no power of two, and prefix reuse under
    expert streaming, raise ``ValueError`` on both sides."""
    for side in SIDES:
        eng = m[side][16]
        eng._stream = None
        with pytest.raises(ValueError, match="power of two"):
            eng.serve(_reqs(m[side]["req"]), num_slots=2, chunk=4,
                      page_size=6)
        with pytest.raises(ValueError, match="streaming"):
            _streamed_serve(m, side, page_size=8, prefix_cache=True)


def test_paged_streamed_serve_matches_jax(m):
    """Paged serving under expert streaming ('block', LRU 3 of 4): the
    same tokens, traces, page report and offload and stream counters as
    JAX, and as the resident paged serve."""
    det = ("issued_copies", "issued_bytes", "observed_copies",
           "observed_copy_bytes", "metered_bytes", "reruns",
           "degraded_tokens", "in_flight")
    out = {side: _streamed_serve(m, side, page_size=8) for side in SIDES}
    a, b = out["jax"], out["torch"]
    assert_same(a, b)
    assert {k: a.stream_report[k] for k in det} == \
        {k: b.stream_report[k] for k in det}
    assert b.stream_report["degraded_tokens"] == 0
    _, resident = _serve(m, "torch", num_slots=3, chunk=4, page_size=8)
    assert [r.tokens.tolist() for r in resident.results] == \
        [r.tokens.tolist() for r in b.results]
    np.testing.assert_array_equal(resident.router_trace, b.router_trace)

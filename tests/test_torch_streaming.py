"""The port's async expert streaming against the JAX package's, on the CPU:
the host image and the low-bit fallback, the staging ring, and
``ServeEngine.attach_streaming`` under ``generate_many`` and ``generate``
(cache 8 and 3, miss policies block and degrade, a bandwidth controller
whose plan changes stage raised-cap factor deltas, a stalled expert under
each policy), plus the port's own streaming contract (tokens equal the
all-resident path, metered bytes == observed copies per store, a warm
serve copies nothing, the JAX ``ValueError``s).

Both engines serve the tiny MoE of ``tests/test_streaming_oracle.py``
(d 64, 2 layers, 8 experts top-2, INT2, top-n 1) in f32 from stacks JAX
compressed, carried into the port by ``bridge.py``; the JAX side runs
``kernel_impl="ref"``.  One engine per side serves every case: before
each case the test puts the true stacks back into the engine's params
(``attach_streaming`` replaced them with its containers), so each case
starts from fresh stores and fresh containers.  Tokens, masked router
traces, offload reports, plan traces, per-store metered and observed
bytes and copies, and every deterministic ``stream_report`` key must be
equal; the host image and the fallback stacks bit-equal.

The fault cases use a delay/stall backend on each side whose ``copy``
returns only once the copy has landed, so that whether a copy is ready
is a function of the injected clock and the stall predicate alone."""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ControlConfig as JControlConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import StreamConfig as JStreamConfig
from repro.core.pipeline import compress_expert_stack as j_compress_stack
from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params
from repro.offload import hostmem as j_hostmem
from repro.offload import staging as j_staging
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_jax, stack_to_torch
from repro_torch.config import (ControlConfig, ModelConfig, MoEConfig,
                                QuantConfig, ServeConfig, StreamConfig)
from repro_torch.offload import hostmem as t_hostmem
from repro_torch.offload import staging as t_staging
from repro_torch.serve import ServeEngine

from test_streaming_oracle import moe_cfg, prompts

E = 8
MAX_NEW = 6
SIDES = ("jax", "torch")
# the stream_report keys that do not depend on the wall clock
DET_KEYS = ("enabled", "miss_policy", "ring_slots", "fallback_bits",
            "issued_copies", "issued_bytes", "observed_copies",
            "observed_copy_bytes", "metered_bytes", "reruns",
            "degraded_tokens", "abandoned_copies", "flushed_bytes",
            "in_flight", "host_nbytes")


def port_moe_cfg() -> ModelConfig:
    """``moe_cfg()`` in the port's config classes, as compressed."""
    return ModelConfig(
        name="stream-oracle", family="moe", num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=0, vocab_size=128,
        block_pattern=("global",), max_position=512, force_unroll_plan=True,
        moe=MoEConfig(num_experts=E, top_k=2, d_expert=64,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=16,
                                        top_n_restore=1, hqq_iters=2)))


class _Clock:
    """An injected clock: every reading advances it by ``step``."""

    def __init__(self, step: float = 1e-3):
        self.t, self.step = 0.0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


class JLandedFake(j_staging.FakeTransferBackend):
    """JAX's delay/stall backend, its copy returning once landed."""

    def copy(self, host_tree, tag=None):
        h = super().copy(host_tree, tag)
        jax.block_until_ready(h.dev)
        return h


class TLandedFake(t_staging.FakeTransferBackend):
    """The port's twin (a CPU copy has landed when ``copy`` returns)."""

    def copy(self, payload, tag=None, staging=None):
        h = super().copy(payload, tag, staging)
        assert super(t_staging.FakeTransferBackend, self).is_ready(h.dev)
        return h


@pytest.fixture(scope="module")
def m():
    """One compression, and one engine per side over it; ``reset``
    puts the true stacks back into an engine's params."""
    cfg = moe_cfg()
    params = j_init_params(jax.random.key(0), cfg, jnp.float32)
    qp, cq, jstacks = compress_moe_params(params, cfg)
    tq = params_from_jax(jax.tree.map(np.asarray, qp), "cpu")
    tstacks = [lp["moe"]["stacks"] for lp in tq["layers"] if "moe" in lp]
    jeng = JServeEngine(cq, qp, JServeConfig(temperature=0.0),
                        quantized=True, kernel_impl="ref")
    teng = ServeEngine(port_moe_cfg(), tq, ServeConfig(temperature=0.0),
                       quantized=True, device="cpu")
    return {"jax": (jeng, jstacks), "torch": (teng, tstacks)}


def _moe_params(eng, side):
    layers = (eng.params["layers"] if side == "torch" else
              [lp for seg in eng.params["segments"] for lp in seg])
    return [lp["moe"] for lp in layers
            if isinstance(lp, dict) and isinstance(lp.get("moe"), dict)
            and "stacks" in lp["moe"]]


def setup(m, side, *, cap=E, stream=None, control=None, fault=None,
          streaming=True):
    """The side's engine with its true stacks back, fresh stores (LRU
    ``cap``), the controller ``control`` (a dict of ControlConfig
    fields) or none, and streaming under ``stream`` (a dict of
    StreamConfig fields) through ``fault`` (a dict of fake-backend
    fields) or the real backend."""
    eng, stacks = m[side]
    for mp, st in zip(_moe_params(eng, side), stacks):
        mp["stacks"] = st
    eng.attach_offload(stacks, policy="ours", cache_capacity=cap)
    eng._controller = None
    if control is not None:
        eng.attach_controller((JControlConfig if side == "jax"
                               else ControlConfig)(**control))
    eng._stream = None
    if streaming:
        scfg = (JStreamConfig if side == "jax" else StreamConfig)(
            enabled=True, **(stream or {}))
        backend = None
        if fault is not None:
            kw = dict(fault, clock=_Clock())
            backend = (JLandedFake(**kw) if side == "jax"
                       else TLandedFake(device="cpu", **kw))
        eng.attach_streaming(scfg, backend=backend)
    return eng


def serve(eng):
    return eng.generate_many(prompts(), max_new=MAX_NEW, num_slots=2,
                             chunk=4)


def batch():
    return np.stack([p[:4] for p in prompts()])


def store_cols(eng):
    return [(s.total_bytes, s.observed_copy_bytes, s.observed_copies)
            for s in eng._stores]


def assert_oracle(eng):
    for li, s in enumerate(eng._stores):
        assert s.total_bytes == s.observed_copy_bytes, (li, s.total_bytes,
                                                        s.observed_copy_bytes)


def det(rep):
    return {k: rep[k] for k in DET_KEYS}


# ---------------------------------------------------------------------------
# the engine, port vs JAX
# ---------------------------------------------------------------------------

CASES = {
    "cache8-block": dict(),
    "cache3-block": dict(cap=3),
    "cache8-degrade": dict(stream=dict(miss_policy="degrade")),
    "cache3-degrade": dict(cap=3, stream=dict(miss_policy="degrade")),
    # a budget under which the plan lowers the rank caps, then raises
    # them again
    "controller": dict(cap=3, control=dict(enabled=True,
                                           bytes_per_token=15000.0)),
    # experts the decode routes to in both layers
    "stall-block": dict(stream=dict(stall_timeout_s=0.05, max_reruns=2),
                        fault=dict(stall=(7,))),
    "stall-degrade": dict(stream=dict(miss_policy="degrade",
                                      stall_timeout_s=0.05),
                          fault=dict(stall=(5,))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streamed_serve_and_generate_match_jax(m, case):
    kw = CASES[case]
    out = {}
    for side in SIDES:
        eng = setup(m, side, **kw)
        sv = serve(eng)
        gen = eng.generate(batch(), max_new=MAX_NEW)
        out[side] = (sv, gen, store_cols(eng))
        assert_oracle(eng)
    (a, ga, ca), (b, gb, cb) = out["jax"], out["torch"]
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert ra.offload_bytes == rb.offload_bytes
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    if a.plan_trace is None:
        assert b.plan_trace is None
    else:
        np.testing.assert_array_equal(a.plan_trace, b.plan_trace)
    assert det(a.stream_report) == det(b.stream_report)
    np.testing.assert_array_equal(ga.tokens, gb.tokens)
    np.testing.assert_array_equal(ga.router_trace, gb.router_trace)
    assert ga.offload_report == gb.offload_report
    assert det(ga.stream_report) == det(gb.stream_report)
    assert ca == cb
    sr = b.stream_report
    if "stall" in case:
        assert sr["degraded_tokens"] > 0
        assert sr["abandoned_copies"] > 0 or sr["in_flight"] > 0
    elif "block" in case:
        assert sr["degraded_tokens"] == 0 and sr["reruns"] > 0
    if case == "controller":
        assert len({p.tobytes() for p in b.plan_trace}) >= 2


def test_controller_case_stages_raised_cap_deltas(m, monkeypatch):
    """The controller case's plan changes raise rank caps on experts
    whose lower-cap rows are already staged: the port copies only the
    missing rows (a window starting above rank 0)."""
    windows = []
    orig = t_staging.ExpertStreamEngine._apply_factors

    def spy(self, L, e, w, dev, cap):
        windows.extend(w.values())
        return orig(self, L, e, w, dev, cap)

    monkeypatch.setattr(t_staging.ExpertStreamEngine, "_apply_factors", spy)
    eng = setup(m, "torch", **CASES["controller"])
    serve(eng)
    eng.generate(batch(), max_new=MAX_NEW)
    assert any(lo > 0 for lo, _hi in windows), windows


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resident(m):
    eng = setup(m, "torch", streaming=False)
    return ([r.tokens.tolist() for r in serve(eng).results],
            eng.generate(batch(), max_new=MAX_NEW).tokens)


@pytest.mark.parametrize("cap", (E, 3))
def test_block_tokens_equal_resident(m, resident, cap):
    eng = setup(m, "torch", cap=cap)
    st = serve(eng)
    assert [r.tokens.tolist() for r in st.results] == resident[0]
    assert_oracle(eng)
    rep = st.offload_report
    assert rep["observed_copy_bytes"] == rep["total_bytes"] > 0
    if cap == E:
        # no eviction: every staged copy is claimed by one metering event
        assert st.stream_report["issued_copies"] == sum(
            s.observed_copies for s in eng._stores)
    np.testing.assert_array_equal(
        eng.generate(batch(), max_new=MAX_NEW).tokens, resident[1])
    assert_oracle(eng)


def test_warm_second_serve_moves_nothing(m, resident):
    eng = setup(m, "torch")
    serve(eng)
    copies0, reruns0 = eng.stream.issued_copies, eng.stream.reruns
    st = serve(eng)
    assert [r.tokens.tolist() for r in st.results] == resident[0]
    assert eng.stream.issued_copies == copies0
    assert eng.stream.reruns == reruns0
    assert_oracle(eng)
    assert st.offload_report["observed_copy_bytes"] == \
        st.offload_report["total_bytes"] == 0


@pytest.mark.parametrize("fault", ("no-offload", "trace-off", "fp16",
                                   "not-live"))
def test_attach_streaming_raises_like_jax(m, fault):
    eng, stacks = m["torch"]
    for mp, st in zip(_moe_params(eng, "torch"), stacks):
        mp["stacks"] = st
    if fault == "no-offload":
        eng = ServeEngine(eng.cfg, eng.params, quantized=True, device="cpu")
        match = "attach_offload"
    elif fault == "trace-off":
        eng = ServeEngine(eng.cfg, eng.params, quantized=True, device="cpu",
                          collect_router_trace=False)
        eng.attach_offload(stacks)
        match = "collect_router_trace"
    elif fault == "fp16":
        eng.attach_offload(stacks, policy="fp16")
        match = "fp16"
    else:
        eng.attach_offload([dict(s) for s in stacks])
        match = "not the live serving stacks"
    with pytest.raises(ValueError, match=match):
        eng.attach_streaming(StreamConfig(enabled=True))


# ---------------------------------------------------------------------------
# host image and fallback, port vs JAX
# ---------------------------------------------------------------------------

def _eq(t, a):
    a = np.asarray(a)
    got = t.view(torch.int16).numpy().view(a.dtype) \
        if t.dtype == torch.bfloat16 else t.numpy()
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)


def _eq_tree(t, j):
    assert set(t) == set(j)
    for proj in j:
        assert set(t[proj]) == set(j[proj])
        for k, v in j[proj].items():
            if k == "planes":
                assert len(t[proj][k]) == len(v)
                for x, y in zip(t[proj][k], v):
                    _eq(x, y)
            else:
                _eq(t[proj][k], v)


@pytest.fixture(scope="module")
def images(m):
    (_, jstacks), (_, tstacks) = m["jax"], m["torch"]
    return ([j_hostmem.HostExpertImage(s) for s in jstacks],
            [t_hostmem.HostExpertImage(s) for s in tstacks])


def test_host_image_payloads_bit_equal(images):
    """Weight payloads of every expert, and factor payloads for the full
    window, a raised-cap delta window (lo > 0 where the rank is) and one
    projection alone."""
    assert any(r > 1 for ji in images[0] for s in ji.meta.values()
               for r in s.ranks)
    for ji, ti in zip(*images):
        assert ti.host_nbytes == ji.host_nbytes
        for e in range(E):
            _eq_tree(ti.weight_payload(e).tree(), ji.weight_payload(e))
            full = {n: (0, s.ranks[e]) for n, s in ji.meta.items()}
            delta = {n: (s.ranks[e] // 2, s.ranks[e])
                     for n, s in ji.meta.items()}
            for win in (full, delta, {"w2": full["w2"]}):
                _eq_tree(ti.factor_payload(e, win).tree(),
                         ji.factor_payload(e, win))


@functools.lru_cache(maxsize=None)
def _hetero_stacks(bits):
    """One (8, 64, 64) projection compressed at per-expert widths in a
    ``max(bits)`` container, in JAX and carried into the port."""
    from repro.config import QuantConfig as JQuantConfig
    w = np.random.default_rng(5).normal(size=(8, 64, 64)).astype(np.float32)
    js, _ = j_compress_stack(jnp.asarray(w), JQuantConfig(
        enabled=True, bits=max(bits), group_size=64, rank_budget=16,
        hqq_iters=2), bits=np.asarray(bits))
    return js, stack_to_torch(jax.tree.map(np.asarray, js), "cpu")


@pytest.mark.parametrize("bits,fallback", list(itertools.product(
    ((2,) * 8, (2, 4) * 4, (4,) * 8), (2, 4))))
def test_fallback_stack_bit_equal(bits, fallback):
    js, ts = _hetero_stacks(bits)
    jf = j_hostmem.build_fallback_stack(js, fallback)
    tf = t_hostmem.build_fallback_stack(ts, fallback)
    assert (tf.bits, tf.group_size, tuple(tf.shape), tf.ranks, tf.pad_rank,
            tf.expert_bits) == (jf.bits, jf.group_size, tuple(jf.shape),
                                jf.ranks, jf.pad_rank, jf.expert_bits)
    for a, b in zip(tf.planes, jf.planes):
        _eq(a, b)
    for f in ("scale", "zero", "u", "v", "u_scale", "v_scale"):
        _eq(getattr(tf, f), getattr(jf, f))
    assert not any(getattr(tf, f).any() for f in ("u", "v", "u_scale",
                                                   "v_scale"))


def test_fallback_too_low_width_raises_like_jax():
    js, ts = _hetero_stacks((2,) * 8)
    with pytest.raises(ValueError) as je:
        j_hostmem.build_fallback_stack(js, 0)
    with pytest.raises(ValueError) as te:
        t_hostmem.build_fallback_stack(ts, 0)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# staging ring, port vs JAX
# ---------------------------------------------------------------------------

def _payload(side):
    if side == "jax":
        return np.zeros((2,), np.float32)
    return t_hostmem.Payload(torch.zeros((8,), dtype=torch.uint8), ())


def _rings(cap, stall, clock=None):
    clock = clock or (lambda: 0.0)
    out = {}
    for side, mod in (("jax", j_staging), ("torch", t_staging)):
        kw = {} if side == "jax" else {"device": "cpu"}
        backend = mod.FakeTransferBackend(stall=stall, clock=clock, **kw)
        out[side] = mod.StagingRing(cap, backend, clock=clock, tag=0)
    return out


def _slots(ring):
    return [(s.index, s.state, s.expert, s.kind, s.wire_bytes, s.generation)
            for s in ring.slots]


@pytest.mark.parametrize("seed", range(8))
def test_seeded_ring_interleavings_match_jax(seed):
    """``tests/test_staging_ring.py``'s seeded interleavings (issue,
    complete-and-release, abandon, poll) through both rings: every slot
    state equal after every operation."""
    rng = np.random.default_rng(seed)
    blocked = set()
    rings = _rings(int(rng.integers(1, 5)), lambda tag: tag in blocked)
    nxt = 0
    for _ in range(120):
        op = rng.integers(0, 5)
        inflight = [s.index for s in rings["jax"].slots
                    if s.state == j_staging.IN_FLIGHT]
        if op == 0 or not inflight:
            kind = "w" if rng.integers(2) else "f"
            blocked.add((0, nxt, kind))
            got = {side: r.try_issue(nxt, _payload(side), 16, kind=kind)
                   for side, r in rings.items()}
            assert (got["jax"] is None) == (got["torch"] is None)
            if got["jax"] is None:
                blocked.discard((0, nxt, kind))
            nxt += 1
        elif op == 1:
            idx = int(rng.choice(inflight))
            s = rings["jax"].slots[idx]
            blocked.discard((0, s.expert, s.kind))
            for r in rings.values():
                r.poll()
                r.release(r.slots[idx])
        elif op == 2:
            idx = int(rng.choice(inflight))
            for r in rings.values():
                r.abandon(r.slots[idx])
        else:
            for r in rings.values():
                r.poll()
        assert _slots(rings["jax"]) == _slots(rings["torch"])
        assert rings["jax"].occupancy == rings["torch"].occupancy


def test_ring_edges_match_jax():
    """Capacity-1 decline, a stall and its timeout, the release and
    abandon state errors, and ``find``, on both rings alike."""
    import time
    for side, r in _rings(1, None).items():
        s0 = r.try_issue(0, _payload(side), 8)
        assert s0 is not None and r.try_issue(1, _payload(side), 8) is None
        r.poll()
        assert s0.state == "ready"
        r.release(s0)
        assert r.try_issue(1, _payload(side), 8) is not None
    for side, r in _rings(2, lambda tag: True, time.monotonic).items():
        slot = r.try_issue(5, _payload(side), 8)
        assert not r.wait(slot, timeout_s=0.02)
        assert slot.state == "in_flight"
        with pytest.raises(AssertionError):
            r.release(slot)
        r.abandon(slot)
        assert slot.state == "free" and r.occupancy == 0
        with pytest.raises(AssertionError):
            r.abandon(slot)
    for side, r in _rings(2, None).items():
        r.try_issue(4, _payload(side), 8, kind="w")
        r.try_issue(4, _payload(side), 8, kind="f")
        assert r.find(4, "w").kind == "w" and r.find(4, "f").kind == "f"
        assert r.find(9, "w") is None
    with pytest.raises(ValueError, match="capacity"):
        t_staging.StagingRing(0, t_staging.DeviceTransferBackend("cpu"))

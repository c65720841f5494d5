"""The port's offload metering against the JAX package's, host side: the
byte-metered ``ExpertStore`` and its LRU, ``replay_decode_trace`` /
``meter_decode_trace`` under every fetch policy, per-layer plans and
two LRU capacities, the layer-ahead prefetcher, and
``CompressedExpertStack.fp16_wire_bytes``.

Both sides meter the same JAX-compressed stacks (the tiny MoE of
``tests/test_serve_scheduler.py``, carried into the port by ``bridge.py``)
on the same random traces, made from numpy seeds; every report, counter
and per-slot byte vector must be equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import init_params as j_init_params
from repro.offload import prefetch as j_prefetch
from repro.offload import store as j_store
from repro_torch.bridge import params_from_jax
from repro_torch.offload import prefetch as t_prefetch
from repro_torch.offload import store as t_store

from test_serve_scheduler import compress, moe_cfg
import torch_cpu  # noqa: F401  (one intra-op thread per worker)


@pytest.fixture(scope="module")
def stacks():
    """(JAX stacks_by_layer, port stacks_by_layer) of the tiny MoE, one
    compression per module, on 8 experts so that eviction happens."""
    import dataclasses
    cfg = moe_cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8))
    params = j_init_params(jax.random.key(7), cfg, jnp.float32)
    _, qparams, jstacks = compress(cfg, params)
    tq = params_from_jax(jax.tree.map(np.asarray, qparams), "cpu")
    tstacks = [lp["moe"]["stacks"] for lp in tq["layers"] if "moe" in lp]
    return jstacks, tstacks


def random_trace(seed, steps=12, layers=2, b=3, k=2, e=8, dead=0.25):
    """(steps, layers, B, k) routed ids, distinct per row, with whole
    (step, row) pairs masked to -1 at rate ``dead`` (inactive slots)."""
    rng = np.random.default_rng(seed)
    tr = np.stack([rng.permutation(e)[:k]
                   for _ in range(steps * layers * b)])
    tr = tr.reshape(steps, layers, b, k).astype(np.int32)
    off = rng.random((steps, b)) < dead
    tr[np.broadcast_to(off[:, None, :, None], tr.shape)] = -1
    return tr


def test_fp16_wire_bytes_matches_jax(stacks):
    jstacks, tstacks = stacks
    for js, ts in zip(jstacks, tstacks):
        for name in js:
            assert ts[name].fp16_wire_bytes == js[name].fp16_wire_bytes
            for e in range(ts[name].shape[0]):
                for comp in (False, True):
                    assert ts[name].expert_wire_bytes(e, comp) == \
                        js[name].expert_wire_bytes(e, comp)


@pytest.mark.parametrize("policy", ["fp16", "quant", "ours"])
@pytest.mark.parametrize("cap", [2, 3])
@pytest.mark.parametrize("plan", ["static", "per_layer"])
def test_meter_decode_trace_matches_jax(stacks, policy, cap, plan):
    """Two traces metered one after the other (the stores stay warm
    between them) give JAX's reports, byte for byte, with the
    layer-ahead prefetcher, on LRUs of ``cap`` of 8 experts, under the
    static knobs or a per-layer (top_n, rank_cap) plan."""
    jstacks, tstacks = stacks
    knobs = (dict(top_n=1) if plan == "static"
             else dict(top_n=[2, 0], rank_caps=[4, 0]))
    sides = []
    for mod, pf_mod, st in ((j_store, j_prefetch, jstacks),
                            (t_store, t_prefetch, tstacks)):
        stores = mod.make_expert_stores(st, cache_capacity=cap)
        pf = pf_mod.LayerAheadPrefetcher(len(st), 2)
        reps = [mod.meter_decode_trace(stores, random_trace(s),
                                       policy=policy, prefetcher=pf,
                                       **knobs)
                for s in (1, 2)]
        sides.append((reps, [s.total_bytes for s in stores],
                      pf.stats.issued, pf.stats.useful))
    assert sides[0] == sides[1]
    assert sides[1][0][0]["total_bytes"] > 0


def test_replay_slot_bytes_match_jax(stacks):
    """Per-slot byte attribution and the active-token count of
    ``replay_decode_trace`` (what ``serve`` bills each request with)."""
    jstacks, tstacks = stacks
    tr = random_trace(3, steps=20, b=4, dead=0.4)
    got = []
    for mod, st in ((j_store, jstacks), (t_store, tstacks)):
        stores = mod.make_expert_stores(st, cache_capacity=2)
        ntok, slot_bytes = mod.replay_decode_trace(
            stores, tr, policy="ours", top_n=[1, 2], rank_caps=[8, 16])
        got.append((ntok, slot_bytes.tolist()))
    assert got[0] == got[1]
    assert got[1][0] == int((tr[:, 0, :, 0] >= 0).sum())


def test_store_rank_cap_raise_fetches_delta_like_jax(stacks):
    """A raised rank cap fetches only the missing factor rows; an
    eviction drops the expert's factors with it."""
    jstacks, tstacks = stacks
    seq = [([0, 1], 4), ([0, 2], 8), ([0, 1], None), ([3, 4], 8),
           ([5, 6], 8), ([7, 0], 2), ([0, 1], 16)]
    got = []
    for mod, st in ((j_store, jstacks), (t_store, tstacks)):
        s = mod.ExpertStore(st[0], cache_capacity=3)
        moved = [s.access_token(np.asarray(e), top_n=1, policy="ours",
                                rank_cap=cap) for e, cap in seq]
        got.append((moved, s.comp_bytes_moved, s.cache.stats.hits,
                    s.cache.stats.misses, sorted(s._comp_resident.items(),
                                                 key=str)))
    assert got[0] == got[1]


def test_prefetcher_observe_matches_jax():
    rng = np.random.default_rng(0)
    steps = [rng.integers(-1, 8, (3, 2)) for _ in range(30)]
    steps[5][:] = -1                         # a fully masked step
    got = []
    for mod in (j_prefetch, t_prefetch):
        pf = mod.LayerAheadPrefetcher(2, 2)
        preds = []
        for i, ex in enumerate(steps):
            pf.observe(i % 2, ex)
            p = pf.predict(i % 2)
            preds.append(None if p is None else p.tolist())
        got.append((preds, pf.stats.issued, pf.stats.useful,
                    pf.stats.wasted, pf.stats.accuracy))
    assert got[0] == got[1]

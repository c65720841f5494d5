"""The port's offline pipeline (``repro_torch.calib``, the calibrated
half of ``core/pipeline.py``, the artifact codec) against the JAX
package's, on the CPU.

Both packages calibrate, allocate and compress the tiny MoE of
``tests/test_calib.py`` (d 64, 2 layers, 8 experts top-2, INT2, 2 HQQ
iterations) from one weight set: JAX initializes it and ``bridge.py``
carries it into the port.  What must agree, and how closely:

- synthetic calibration batches: bit-equal;
- calibration stats: counts and token totals equal; gate mass within
  1e-6 and moments within 1e-5 relative (f32 softmax and products summed
  in another order, accumulated in f64 on both sides);
- allocator tables: at 2, 3 and 4 bits every tail norm within 1e-6 of
  that table's total (the two HQQ scales differ in the last bits, since
  the frameworks sum the weight std in another order); at 8 bits within
  1e-2, since at 256 levels those last bits flip a few codes;
- plans: every layer's bits and ranks, the spent bytes and the budget
  equal (``to_json`` equal but ``predicted_err``, which is within 1e-6
  relative), at budget fractions 0.6 and 0.9 and on a finer rank ladder
  that buys ranks;
- stacks compressed from JAX's plan and stats: codes, ranks, bits and
  padding equal; scales and zeros within 1e-6 relative (HQQ as above);
  compensators restore as much as JAX's (``test_torch_quantize.py``);
- artifacts: either package loads the other's, every tensor bit-equal
  (bf16 factors included), and re-saving gives the same checksum;
- ``config_fingerprint``: JAX's hash for every registered config;
- serving from an artifact: the same tokens, traces and offload report
  as serving from the in-memory stacks.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import calib as jcalib
from repro.calib import allocate as jalloc
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.data.synthetic import SyntheticLMConfig as JSyntheticLMConfig
from repro.models import init_params as j_init_params
from repro.models.transformer import compress_moe_params as j_compress
from repro.registry import get_config as j_get_config
from repro_torch import calib as tcalib
from repro_torch.bridge import params_from_jax
from repro_torch.calib import allocate as talloc
from repro_torch.config import ModelConfig, MoEConfig, QuantConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.launch import serve as serve_cli
from repro_torch.models.transformer import (apply_compressed_stacks,
                                            compress_moe_params)
from repro_torch.registry import REGISTRY, get_config
from repro_torch.serve import ServeEngine, synthetic_workload

from test_calib import tiny_moe_cfg
import torch_cpu  # noqa: F401  (one intra-op thread per worker)

BITS = (2, 3, 4, 8)
FINE_RANKS = (0, 4, 8, 16)


def port_tiny_cfg(**quant) -> ModelConfig:
    """``tiny_moe_cfg()`` in the port's config classes."""
    return ModelConfig(
        name="calib-test-8e", family="moe", num_layers=2, d_model=64,
        num_heads=2, num_kv_heads=1, head_dim=32, d_ff=0, vocab_size=128,
        block_pattern=("global",), max_position=512,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64,
                      quant=QuantConfig(**(dict(
                          enabled=True, bits=2, rank_budget=8,
                          top_n_restore=1, hqq_iters=2) | quant))))


def j_tiny_cfg(**quant):
    cfg = tiny_moe_cfg()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, quant=dataclasses.replace(cfg.moe.quant, **quant)))


def port_stats(js):
    return [tcalib.LayerCalibStats(s.counts, s.gate_mass, s.in_moment,
                                   s.hid_moment, s.tokens) for s in js]


@pytest.fixture(scope="module")
def cs():
    """One weight set, both packages' stats and weights, and JAX's
    uniform reference bytes."""
    jcfg, tcfg = tiny_moe_cfg(), port_tiny_cfg()
    jp = j_init_params(jax.random.key(0), jcfg, jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(batches=2, batch_size=4, seq_len=32)
    js = jcalib.collect_calibration_stats(jcfg, jp, **kw)
    ts = tcalib.collect_calibration_stats(tcfg, tp, **kw)
    jw = jcalib.moe_weights_by_layer(jp, jcfg)
    tw = tcalib.moe_weights_by_layer(tp, tcfg)
    q = jcfg.moe.quant
    ref = jcalib.uniform_plan(jw, q, bits=q.bits, rank=q.rank_budget)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, js=js, ts=ts, jw=jw,
                tw=tw, ref_bytes=ref.spent_bytes)


@pytest.fixture(scope="module")
def plans(cs):
    """JAX's 0.9 plan and the stacks both packages compress from it and
    JAX's stats."""
    plan = jcalib.allocate_budget(cs["jw"], cs["jcfg"].moe.quant,
                                  0.9 * cs["ref_bytes"], stats=cs["js"])
    _, _, jst = j_compress(cs["jp"], cs["jcfg"], plan=plan, stats=cs["js"])
    _, _, tst = compress_moe_params(
        cs["tp"], cs["tcfg"],
        plan=tcalib.CompressionPlan.from_json(plan.to_json()),
        stats=port_stats(cs["js"]))
    return dict(plan=plan, jst=jst, tst=tst)


# ---------------------------------------------------------------------------
# data, stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=128, batch_size=4, seq_len=32, seed=0),
    dict(vocab_size=512, seed=3, markov_states=7),
    dict(vocab_size=151_936, batch_size=2, seq_len=8, seed=1),
])
def test_synthetic_batches_bit_equal(kw):
    t, j = SyntheticLM(SyntheticLMConfig(**kw)), \
        JSyntheticLM(JSyntheticLMConfig(**kw))
    for step in (0, 1, 7):
        a, b = t.batch(step)["tokens"], j.batch(step)["tokens"]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_calibration_stats_match_jax(cs):
    assert len(cs["ts"]) == len(cs["js"]) == 2
    for t, j in zip(cs["ts"], cs["js"]):
        assert t.tokens == j.tokens == 256
        np.testing.assert_array_equal(t.counts, j.counts)
        np.testing.assert_allclose(t.gate_mass, j.gate_mass, rtol=1e-6)
        np.testing.assert_allclose(t.in_moment, j.in_moment, rtol=1e-5)
        np.testing.assert_allclose(t.hid_moment, j.hid_moment, rtol=1e-5)
        np.testing.assert_allclose(t.importance(), j.importance(),
                                   rtol=1e-6)
    assert tcalib.stats_summary(cs["ts"])["freq"] == \
        jcalib.stats_summary(cs["js"])["freq"]


def test_moe_inputs_are_the_normed_ffn_inputs(cs):
    """``LMOutput.moe_inputs`` carries JAX's collected inputs."""
    from repro.launch.steps import make_context
    from repro.models import model as jlm
    from repro_torch.models import model as tlm
    from repro_torch.models.transformer import ExecContext
    toks = np.asarray(SyntheticLM(SyntheticLMConfig(
        vocab_size=128, batch_size=2, seq_len=16)).batch(0)["tokens"])
    jctx = make_context(cs["jcfg"], "train", exact_capacity=True,
                        collect_moe_inputs=True)
    j = jlm.forward(cs["jp"], jnp.asarray(toks), cs["jcfg"], jctx)
    t = tlm.forward(cs["tp"], torch.from_numpy(toks), cs["tcfg"],
                    ExecContext(mode="train", exact_capacity=True,
                                collect_moe_inputs=True))
    assert t.moe_inputs.shape == (2, 32, 64)
    np.testing.assert_allclose(t.moe_inputs.numpy(),
                               np.asarray(j.moe_inputs), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------

def test_allocator_tails_match_jax(cs):
    q_j, q_t = cs["jcfg"].moe.quant, cs["tcfg"].moe.quant
    for li in range(2):
        for proj in ("w1", "w2", "w3"):
            tabs = talloc._projection_tables(
                cs["tw"][li][proj], q_t, BITS, cs["ts"][li].moment_for(proj))
            mom = cs["js"][li].moment_for(proj)
            for e, tt in enumerate(tabs):
                jt = jalloc._expert_table(cs["jw"][li][proj][e], q_j, BITS,
                                          mom[e])
                assert (tt.k, tt.n) == (jt.k, jt.n)
                for bits, a, b in zip(BITS, tt.tails, jt.tails):
                    assert a.shape == b.shape == (65,)
                    tol = (1e-2 if bits == 8 else 1e-6) * b[0]
                    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("bits", BITS)
def test_allocator_error_model_is_the_compression(cs, bits):
    """The allocator's rank-0 tail at a width is the relative quant
    residual ``compress_expert_stack`` leaves at that width (both quantize
    through ``hqq_quantize_stack``): within 1e-6 relative, f64 Gram trace
    against an f32 norm."""
    from repro_torch.core.pipeline import compress_expert_stack
    q_t = cs["tcfg"].moe.quant
    for proj in ("w1", "w2"):
        w = cs["tw"][0][proj]
        tabs = talloc._projection_tables(w, q_t, (bits,), None)
        _, rep = compress_expert_stack(w, q_t,
                                       bits=np.full(w.shape[0], bits))
        np.testing.assert_allclose([t.tails[0][0] for t in tabs],
                                   rep["rel_err_quant"], rtol=1e-6)


@pytest.mark.parametrize("frac,buckets", [(0.6, None), (0.9, None),
                                          (0.9, FINE_RANKS),
                                          (1.2, FINE_RANKS)])
def test_plans_equal_jax(cs, frac, buckets):
    kw = {} if buckets is None else {"rank_buckets": buckets}
    q_j = dataclasses.replace(cs["jcfg"].moe.quant, **kw)
    q_t = dataclasses.replace(cs["tcfg"].moe.quant, **kw)
    budget = frac * cs["ref_bytes"]
    jp = jcalib.allocate_budget(cs["jw"], q_j, budget, stats=cs["js"])
    tp = tcalib.allocate_budget(cs["tw"], q_t, budget, stats=cs["ts"])
    a, b = tp.to_json(), jp.to_json()
    np.testing.assert_allclose(a.pop("predicted_err"),
                               b.pop("predicted_err"), rtol=1e-6)
    assert a == b
    if buckets is not None:
        assert tp.summary()["mean_rank"] > 0       # ranks were bought
    assert tcalib.plan_wire_bytes(tp.layers, q_t, cs["tw"]) == \
        jcalib.plan_wire_bytes(jp.layers, q_j, cs["jw"])
    ju = jcalib.uniform_plan(cs["jw"], q_j, bits=3, rank=16)
    tu = tcalib.uniform_plan(cs["tw"], q_t, bits=3, rank=16)
    assert tu.to_json() == ju.to_json()


def test_plan_json_roundtrip_matches_jax(plans):
    d = plans["plan"].to_json()
    tp = tcalib.CompressionPlan.from_json(json.loads(json.dumps(d)))
    assert tp.to_json() == d
    assert tp.summary() == plans["plan"].summary()


# ---------------------------------------------------------------------------
# compression from a plan and stats
# ---------------------------------------------------------------------------

def test_compress_from_jax_plan_and_stats(cs, plans):
    jst, tst = plans["jst"], plans["tst"]
    for jl, tl, w in zip(jst, tst, cs["jw"]):
        for proj in ("w1", "w2", "w3"):
            a, b = tl[proj], jl[proj]
            assert (a.bits, a.group_size, tuple(a.shape), a.ranks,
                    a.pad_rank, a.factor_bits, a.expert_bits) == \
                (b.bits, b.group_size, tuple(b.shape), b.ranks,
                 b.pad_rank, b.factor_bits, b.expert_bits)
            for pa, pb in zip(a.planes, b.planes):
                np.testing.assert_array_equal(pa.numpy(), np.asarray(pb))
            np.testing.assert_allclose(a.scale.numpy(), np.asarray(b.scale),
                                       rtol=1e-6)
            np.testing.assert_allclose(a.zero.numpy(), np.asarray(b.zero),
                                       rtol=1e-6, atol=1e-6)
            # restoration error per expert as JAX's
            w64 = np.asarray(w[proj], np.float64)
            e = w64.shape[0]
            nw = np.linalg.norm(w64.reshape(e, -1), axis=1)

            def rel(what):
                return np.linalg.norm((w64 - what).reshape(e, -1),
                                      axis=1) / nw
            rt = rel(a.dequantize_all().double().numpy()
                     + a.compensation_all().double().numpy())
            rj = rel(np.asarray(b.dequantize_all(), np.float64)
                     + np.asarray(b.compensation_all(), np.float64))
            assert np.all(rt <= rj * 1.01 + 1e-6)
    imps = [s.importance() for s in cs["js"]]
    np.testing.assert_allclose(
        tcalib.weighted_restoration_error(tst, cs["tw"], imps),
        jcalib.weighted_restoration_error(jst, cs["jw"], imps), rtol=1e-2)
    assert tcalib.stacks_wire_bytes(tst) == jcalib.stacks_wire_bytes(jst)


def test_no_plan_no_stats_is_the_uncalibrated_path(cs):
    """``plan=None, stats=None`` gives the stacks of the plain pipeline."""
    from repro_torch.core.pipeline import compress_ffn_weights
    _, _, st = compress_moe_params(cs["tp"], cs["tcfg"])
    mp = cs["tp"]["layers"][1]["moe"]
    ref, _ = compress_ffn_weights(mp["w1"], mp["w2"], mp["w3"],
                                  cs["tcfg"].moe.quant)
    for proj in ("w1", "w2", "w3"):
        a, b = st[1][proj], ref[proj]
        for f in ("scale", "zero", "u", "v", "u_scale", "v_scale"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.ranks == b.ranks


# ---------------------------------------------------------------------------
# artifacts across the packages
# ---------------------------------------------------------------------------

def _assert_stacks_equal(port_stacks, jax_stacks):
    assert len(port_stacks) == len(jax_stacks)
    for tl, jl in zip(port_stacks, jax_stacks):
        assert list(tl) == list(jl)
        for proj in tl:
            a, b = tl[proj], jl[proj]
            assert (a.bits, a.group_size, a.shape, a.ranks, a.pad_rank,
                    a.factor_bits, a.expert_bits) == \
                (b.bits, b.group_size, b.shape, b.ranks, b.pad_rank,
                 b.factor_bits, b.expert_bits)
            pairs = list(zip(a.planes, b.planes)) + [
                (getattr(a, f), getattr(b, f))
                for f in ("scale", "zero", "u", "v", "u_scale", "v_scale")]
            for x, y in pairs:
                y = np.asarray(y)
                if x.dtype == torch.bfloat16:
                    assert y.dtype.name == "bfloat16"
                    x, y = x.view(torch.int16).numpy(), y.view(np.int16)
                else:
                    x = x.numpy()
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("factor_bits", [8, 16])
def test_artifacts_cross_between_packages(cs, tmp_path, factor_bits):
    jcfg, tcfg = j_tiny_cfg(factor_bits=factor_bits), \
        port_tiny_cfg(factor_bits=factor_bits)
    plan = jcalib.allocate_budget(cs["jw"], jcfg.moe.quant,
                                  0.9 * cs["ref_bytes"], stats=cs["js"])
    _, _, jst = j_compress(cs["jp"], jcfg, plan=plan, stats=cs["js"])
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jman = jcalib.save_compression_artifact(jdir, jcfg, jst, plan=plan,
                                            seed=3)
    # JAX -> port
    tst, tplan, meta = tcalib.load_compression_artifact(jdir, tcfg,
                                                        device="cpu")
    _assert_stacks_equal(tst, jst)
    assert tplan.to_json() == plan.to_json() and meta["seed"] == 3
    if factor_bits == 16:
        assert tst[0]["w1"].u.dtype == torch.bfloat16
    # port -> JAX, and the port writes JAX's bytes
    tman = tcalib.save_compression_artifact(tdir, tcfg, tst, plan=tplan,
                                            seed=3)
    assert tman["checksum"] == jman["checksum"]
    assert tman["spec"] == jman["spec"]
    assert tman["meta"]["fingerprint"] == jman["meta"]["fingerprint"]
    jst2, jplan2, _ = jcalib.load_compression_artifact(tdir, jcfg)
    _assert_stacks_equal(tst, jst2)
    assert jplan2.to_json() == plan.to_json()


def test_port_compressed_artifact_loads_in_jax(cs, plans, tmp_path):
    tplan = tcalib.CompressionPlan.from_json(plans["plan"].to_json())
    man = tcalib.save_compression_artifact(tmp_path, cs["tcfg"],
                                           plans["tst"], plan=tplan)
    assert "_meta" not in json.dumps(man["spec"])
    jst, jplan, _ = jcalib.load_compression_artifact(tmp_path, cs["jcfg"])
    _assert_stacks_equal(plans["tst"], jst)
    tst, _, _ = tcalib.load_compression_artifact(tmp_path, cs["tcfg"],
                                                 device="cpu")
    for a, b in zip(tst, plans["tst"]):
        for proj in a:
            assert torch.equal(a[proj].dequantize_all(),
                               b[proj].dequantize_all())


def test_tampered_or_mismatched_artifact_refused(cs, plans, tmp_path):
    tcalib.save_compression_artifact(tmp_path, cs["tcfg"], plans["tst"],
                                     seed=0)
    other = port_tiny_cfg(hqq_iters=3)
    with pytest.raises(ValueError, match="fingerprint"):
        tcalib.load_compression_artifact(tmp_path, other, device="cpu")
    _, _, meta = tcalib.load_compression_artifact(tmp_path, other,
                                                  strict=False, device="cpu")
    assert "fingerprint_mismatch" in meta
    # one flipped bit deep in the largest tensor, in a well-formed file
    npz = tmp_path / "artifact.npz"
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    big = max(arrays, key=lambda k: arrays[k].nbytes)
    flat = arrays[big].reshape(-1).view(np.uint8)
    flat[flat.size // 2] ^= 1
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(IOError, match="checksum"):
        tcalib.load_compression_artifact(tmp_path, cs["tcfg"], device="cpu")


def test_serve_refuses_artifact_of_other_params(cs, plans, tmp_path):
    """The serve CLI boots only artifacts compressed against its own
    parameters: the same seed, initialized by the port."""
    jcalib.save_compression_artifact(tmp_path / "jax", cs["jcfg"],
                                     plans["jst"], seed=0)
    tcalib.save_compression_artifact(
        tmp_path / "port", cs["tcfg"], plans["tst"], seed=0,
        extra={"params_init": "repro_torch"})
    args = serve_cli.build_parser().parse_args(
        ["--arch", "x", "--offload", "--seed", "0"])
    args.artifact = str(tmp_path / "jax")
    with pytest.raises(ValueError, match="JAX package"):
        serve_cli.load_artifact_for(cs["tcfg"], args, "cpu")
    args.artifact = str(tmp_path / "port")
    serve_cli.load_artifact_for(cs["tcfg"], args, "cpu")
    args.seed = 1
    with pytest.raises(ValueError, match="seed"):
        serve_cli.load_artifact_for(cs["tcfg"], args, "cpu")


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_config_fingerprint_is_jax(name):
    for reduced in (False, True):
        assert tcalib.config_fingerprint(get_config(name, reduced)) == \
            jcalib.config_fingerprint(j_get_config(name, reduced))
    assert tcalib.config_fingerprint(port_tiny_cfg()) == \
        jcalib.config_fingerprint(tiny_moe_cfg())


# ---------------------------------------------------------------------------
# serving from an artifact
# ---------------------------------------------------------------------------

def test_serve_from_artifact_equals_in_memory(cs, tmp_path):
    tcfg, tp = cs["tcfg"], cs["tp"]
    plan = tcalib.allocate_budget(cs["tw"], tcfg.moe.quant,
                                  0.9 * cs["ref_bytes"], stats=cs["ts"])
    qparams, cfg_q, stacks = compress_moe_params(tp, tcfg, plan=plan,
                                                 stats=cs["ts"])
    tcalib.save_compression_artifact(tmp_path, tcfg, stacks, plan=plan)
    loaded, _, _ = tcalib.load_compression_artifact(tmp_path, tcfg,
                                                    device="cpu")
    aparams, acfg_q = apply_compressed_stacks(tp, tcfg, loaded)
    assert acfg_q == cfg_q
    assert set(aparams["layers"][0]["moe"]) == \
        set(qparams["layers"][0]["moe"])
    out = []
    for params, st in ((qparams, stacks), (aparams, loaded)):
        eng = ServeEngine(cfg_q, params, quantized=True, device="cpu")
        eng.attach_offload(st, policy="ours", cache_capacity=3)
        reqs = synthetic_workload(5, tcfg.vocab_size, max_new=6,
                                  min_len=4, max_len=20, seed=2)
        out.append(eng.serve(reqs, num_slots=2, chunk=4))
    a, b = out
    for ra, rb in zip(a.results, b.results):
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
        assert ra.offload_bytes == rb.offload_bytes
    np.testing.assert_array_equal(a.router_trace, b.router_trace)
    assert a.offload_report == b.offload_report
    with pytest.raises(ValueError, match="MoE layers"):
        apply_compressed_stacks(tp, tcfg, loaded[:1])

"""The port's expert-parallel serving against the JAX package, on the CPU.

- ``parse_mesh_spec`` on a table of specs, errors included;
- the sharding rules: ``logical_axes_for`` and ``mesh_spec`` for every
  leaf path of a small MoE param + stack tree at three mesh shapes;
- ``ShardedExpertStore`` at ep 1, 2, 4 and 8 replaying one router trace
  over heterogeneous-bit stacks (with and without evictions): total,
  per-shard, hit, miss and compensator bytes exactly JAX's;
- the controller's ``per_shard`` budget scope: the plan trace JAX's;
- the decode path's decomposition: the per-rank partials of
  ``moe_ep_replicated_partial``, summed, within 1e-6 of JAX's
  ``moe_apply``; at E 64 top-6 (partials crossing ranks) both EP paths
  on thread ranks, and kernel 1's wrapper refusing a foreign slice;
- one spawn of 4 gloo ranks on the CPU (``tests/torch_ep_worker.py``,
  an ep 4 mesh and two ep 2 meshes) serving the tiny configs of
  ``tests/test_distributed_serve.py`` (E 8 top-2, and E 1, which falls
  back to every expert on every rank): greedy tokens and traces equal
  to the JAX single-device engine's (which that file pins equal to JAX's
  meshes), log-probs within 1e-4, per-shard bytes equal to JAX's
  ``attach_offload(ep=N)``; at ep 2 paged serving gives the contiguous
  tokens, speculative serving plain serve's (the n-gram drafter, and
  the target drafting through the mesh), ``score`` the
  single-device engine's, a JAX-written heterogeneous-bit artifact
  serves from per-rank slices (their own widths) with its bytes
  conserved, and a ``per_shard`` budget gives the plan trace of the
  single-device engine metering through ``attach_offload(ep=2)``;
- the serve CLI's mesh usage errors, and the refusals that name their
  ROADMAP items.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import save_compression_artifact
from repro.config import ControlConfig as JControlConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import MoEConfig as JMoEConfig
from repro.config import ParallelConfig as JParallelConfig
from repro.config import QuantConfig as JQuantConfig
from repro.core.pipeline import compress_expert_stack
from repro.distributed import sharding as jsh
from repro.launch.mesh import parse_mesh_spec as j_parse
from repro.models import init_params as j_init_params
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.transformer import compress_moe_params as j_compress
from repro.offload import store as jstore
from repro.serve import ServeEngine as JServeEngine
from repro.serve.controller import BandwidthController as JController
from repro_torch.bridge import params_from_jax, stack_to_torch
from repro_torch.config import (ControlConfig, ModelConfig, MoEConfig,
                                ParallelConfig, QuantConfig)
from repro_torch.core.pipeline import CompressedExpertStack
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import parse_mesh_spec, run_ranks
from repro_torch.models.moe import moe_ep_replicated_partial
from repro_torch.offload import store as tstore
from repro_torch.serve.controller import BandwidthController

import torch_cpu  # noqa: F401  (one intra-op thread per worker)
import torch_ep_worker

LP_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = [np.random.default_rng(i).integers(0, 64, (5 + 3 * i,))
           .astype(np.int32) for i in range(3)]
SHAPE = (6, 2, 3)          # max_new, num_slots, chunk


def _cfgs(e, k, port=False):
    """``tests/test_distributed_serve.py``'s ``make_cfg(e, k)`` in either
    package's config classes."""
    M, Mo, Q = ((ModelConfig, MoEConfig, QuantConfig) if port else
                (JModelConfig, JMoEConfig, JQuantConfig))
    return M(name=f"ep-serve-{e}", family="moe", num_layers=2, d_model=64,
             num_heads=2, num_kv_heads=1, head_dim=32, d_ff=0,
             vocab_size=64, block_pattern=("global",), max_position=512,
             moe=Mo(num_experts=e, top_k=k, d_expert=64,
                    quant=Q(enabled=True, bits=2, rank_budget=8,
                            top_n_restore=1, hqq_iters=2)))


# ---------------------------------------------------------------------------
# mesh specs and sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["ep=4", "ep=2,", " ep = 8 ", "", "ep=1",
                                  "ep", "tp=2", "ep=2,dp=2", "ep=x"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = j_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


@pytest.fixture(scope="module")
def jmodel():
    """JAX's E 8 top-2 model: (params, compressed params, config', stacks)."""
    jcfg = _cfgs(8, 2)
    params = _j_init(jcfg)
    jq, jcq, jst = j_compress(params, jcfg)
    return params, jq, jcq, jst


def _j_init(jcfg):
    """JAX's ``init_params`` as one compiled program (op by op it
    compiles each op apart, seconds on this tiny model)."""
    return jax.jit(lambda k: j_init_params(k, jcfg, jnp.float32))(
        jax.random.key(0))


@pytest.mark.parametrize("flags", [
    ["--mesh", "tp=2"],
    ["--mesh", "ep"],
    ["--mesh", "ep=2", "--offload", "--stream"],
    ["--mesh", "ep=2", "--dist-backend", "mpi"],
])
def test_serve_cli_mesh_usage_errors(flags):
    """The serve CLI refuses a bad mesh spec, streaming on a mesh (JAX's
    refusal) and an unknown backend before it starts a rank."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "mixtral-8x7b", "--device", "cpu",
                    "--requests", "2"] + flags)


def test_mesh_refusals_name_their_item():
    """Without ranks a mesh cannot be made; a graph on a mesh and a train
    step on one name their ROADMAP items; streaming on a mesh raises
    JAX's error."""
    from repro_torch.launch.mesh import ServeMesh, make_serve_mesh
    from repro_torch.launch.steps import make_context
    from repro_torch.serve import ServeEngine
    assert make_serve_mesh(1, backend="gloo") is None
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_serve_mesh(2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_serve_mesh(2, backend="mpi")
    mesh = ServeMesh(2, 0, None, torch.device("cpu"), "gloo")
    cfg = _cfgs(8, 2, port=True)
    with pytest.raises(NotImplementedError, match="A13b"):
        make_context(cfg, "train", mesh=mesh)
    assert make_context(cfg, "step", mesh=mesh).ep_mode == "replicated"
    assert make_context(cfg, "prefill", mesh=mesh).ep_mode == "a2a"
    params = {"embed": {"tok": torch.zeros(64, 64)}, "layers": []}
    with pytest.raises(NotImplementedError, match="A13c"):
        ServeEngine(cfg, params, device="cpu", mesh=mesh, decode_graph=True)
    eng = ServeEngine(cfg, params, device="cpu", mesh=mesh)
    assert not eng.decode_graph and eng.ep == 2
    eng._stores = []
    with pytest.raises(ValueError, match="single-device"):
        eng.attach_streaming()


def _tree_paths(tree, prefix: str = ""):
    """(path, leaf) over a param / stack tree in the JAX package's path
    form: dict keys and list indices joined by '/', a
    ``CompressedExpertStack``'s tensors under their field names (its
    planes as ``planes/<i>``)."""
    if isinstance(tree, CompressedExpertStack):
        for i, p in enumerate(tree.planes):
            yield f"{prefix}planes/{i}", p
        for name in ("scale", "zero", "u", "v", "u_scale", "v_scale"):
            yield prefix + name, getattr(tree, name)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix.rstrip("/"), tree


class _Mesh:
    """What JAX's ``mesh_spec`` reads of a mesh: its ``shape``."""
    def __init__(self, shape):
        self.shape = shape


def _jax_paths(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsh._path_str(p), np.shape(v)) for p, v in leaves]


@pytest.mark.parametrize("shape", [{"model": 2}, {"model": 8},
                                   {"data": 2, "model": 4}])
def test_sharding_rules_match_jax(shape, jmodel):
    """Every leaf of a small MoE tree (dense experts, shared experts,
    compressed stacks) and of its caches gets JAX's logical axes and
    partition spec."""
    cfg = dataclasses.replace(_cfgs(8, 2), moe=dataclasses.replace(
        _cfgs(8, 2).moe, num_shared_experts=1))
    params = jax.eval_shape(lambda: j_init_params(jax.random.key(0), cfg,
                                                  jnp.float32))
    stacks = jmodel[3]
    paths = _jax_paths(params) + [
        (f"segments/0/0/moe/stacks/{q}", s) for q, s in
        _jax_paths({k: v for k, v in stacks[0].items()})]
    paths += [("caches/layers/0/k", (2, 64, 1, 32)),
              ("caches/layers/0/pos", (2, 64)),
              ("caches/layers/0/h", (2, 128))]
    pc, jpc = ParallelConfig(), JParallelConfig()
    assert any("stacks/w1/planes/0" in p for p, _ in paths)
    for path, shp in paths:
        for rules, jrules in ((tsh.PARAM_RULES, jsh.PARAM_RULES),
                              (tsh.CACHE_RULES, jsh.CACHE_RULES)):
            ax = tsh.logical_axes_for(path, len(shp), rules)
            assert ax == jsh.logical_axes_for(path, len(shp), jrules), path
            assert tsh.mesh_spec(shape, ax, shp, pc) == \
                tuple(jsh.mesh_spec(_Mesh(shape), ax, shp, jpc)), path


def test_local_expert_slice_cuts_only_experts(jmodel):
    """A rank's tree: the MoE layers' experts (dense and compressed,
    widths and ranks included) cut to its slice, everything else the
    same tensors; E = 1 stays whole (the fallback)."""
    params, jq = jmodel[:2]
    tp = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
    for tree in (tp, tq):
        for rank in range(4):
            loc = tsh.local_expert_slice(tree, 8, rank, 4)
            for (pa, a), (pb, b) in zip(_tree_paths(tree),
                                        _tree_paths(loc)):
                assert pa == pb
                if "moe/w" in pa or "moe/stacks" in pa:
                    assert torch.equal(b, a[2 * rank:2 * rank + 2]), pa
                else:
                    assert b is a, pa
    s = tq["layers"][0]["moe"]["stacks"]["w2"]
    s = dataclasses.replace(s, expert_bits=(2, 3, 2, 4, 2, 3, 2, 4),
                            ranks=tuple(range(8)))
    loc = tsh.local_expert_slice({"moe": {"stacks": {"w2": s}}}, 8, 3, 4)
    got = loc["moe"]["stacks"]["w2"]
    assert got.expert_bits == (2, 4) and got.ranks == (6, 7)
    assert got.meta_tensors()[0].tolist() == [2, 4]
    one = {"layers": [{"moe": {"router": torch.zeros(64, 1),
                               "w1": torch.zeros(1, 64, 64)}}]}
    loc = tsh.local_expert_slice(one, 1, 1, 2)
    assert loc["layers"][0]["moe"]["w1"] is one["layers"][0]["moe"]["w1"]
    # a rank's slice (a loader's shard=) is kept for that rank only; a
    # bare E/ep tensor cannot say whose experts it holds
    tree = {"moe": {"stacks": {"w2": tsh.slice_stack(s, 6, 8)}}}
    assert tsh.local_expert_slice(tree, 8, 3, 4) == tree
    for rank, ep in ((2, 4), (1, 2)):
        with pytest.raises(ValueError, match=r"holds experts \(6, 8\)"):
            tsh.local_expert_slice(tree, 8, rank, ep)
    with pytest.raises(ValueError, match="holds experts 2"):
        tsh.local_expert_slice(
            {"moe": {"w1": torch.zeros(2, 64, 64)}}, 8, 3, 4)


# ---------------------------------------------------------------------------
# sharded stores, the per_shard controller, the replicated decomposition
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hetero():
    """A JAX-compressed (E 8, K 64, N 64) layer whose experts hold 2, 3
    and 4 bits and ranks 0..8, twice (two MoE layers), its bridged twin,
    and one router trace (40 steps, 2 layers, 3 rows, top-2; some rows
    masked -1)."""
    rng = np.random.default_rng(0)
    qcfg = JQuantConfig(enabled=True, bits=4, group_size=64, rank_budget=8,
                        top_n_restore=1, hqq_iters=2)
    bits = np.array([2, 3, 4, 2, 3, 4, 2, 3])
    ranks = np.array([8, 4, 0, 8, 2, 6, 8, 1])
    lay = {}
    for i, proj in enumerate(("w1", "w3", "w2")):
        w = jnp.asarray(rng.standard_normal((8, 64, 64)),
                        jnp.float32) * 0.05
        lay[proj], _ = compress_expert_stack(
            w, qcfg, ranks=np.roll(ranks, i), bits=np.roll(bits, i))
    layers = [lay, dict(lay)]
    tlayers = [{k: stack_to_torch(s, "cpu") for k, s in lay.items()}
               for lay in layers]
    tr = np.stack([rng.permutation(8)[:2] for _ in range(40 * 2 * 3)]) \
        .reshape(40, 2, 3, 2).astype(np.int32)
    tr[rng.random((40, 2, 3)) < 0.2] = -1
    return layers, tlayers, tr


@pytest.mark.parametrize("cap", [8, 2])
def test_sharded_store_bytes_match_jax(hetero, cap):
    jl, tl, tr = hetero
    base = None
    for ep in (1, 2, 4, 8):
        got = {}
        for side, mod, stacks in (("jax", jstore, jl), ("torch", tstore, tl)):
            stores = mod.make_expert_stores(stacks, ep=ep,
                                            cache_capacity=max(cap // ep, 1))
            snap = mod.snapshot_offload(stores)
            ntok, slot = mod.replay_decode_trace(stores, tr, top_n=1,
                                                 rank_caps=[8, 3])
            rep = mod.offload_report(stores, None, snap, ntok, "ours")
            got[side] = (rep, slot.tolist(),
                         [s.shard_totals.tolist() for s in stores],
                         [(s.cache.stats.hits, s.cache.stats.misses,
                           s.comp_bytes_moved) for s in stores])
        assert got["torch"] == got["jax"], ep
        rep = got["torch"][0]
        assert rep["ep"] == ep and sum(rep["per_shard_bytes"]) == \
            rep["total_bytes"] > 0
        if cap == 8:
            # eviction-free: the totals are conserved over shard counts
            base = base or rep["total_bytes"]
            assert rep["total_bytes"] == base


def test_per_shard_controller_matches_jax(hetero):
    jl, tl, _ = hetero
    rng = np.random.default_rng(1)
    chunks = [(rng.integers(0, 4, 4) * 2**18, int(rng.integers(4, 12)))
              for _ in range(30)]
    for scope in ("per_shard", "aggregate"):
        ctl = {}
        for side, cls, ccls, stacks in (
                ("jax", JController, JControlConfig, jl),
                ("torch", BandwidthController, ControlConfig, tl)):
            c = cls.from_stacks(stacks, 2, ccls(
                enabled=True, bytes_per_token=2.0**17, budget_scope=scope),
                static_top_n=1)
            ctl[side] = [c.update(int(sb.sum()), n, shard_bytes=sb)
                         .as_array().tolist() for sb, n in chunks]
        assert ctl["torch"] == ctl["jax"], scope
        assert len({str(p) for p in ctl["torch"]}) > 2


@pytest.mark.parametrize("quantized", [False, True])
def test_replicated_partials_sum_to_jax_moe_apply(quantized, jmodel):
    """The decode path's decomposition without a process group: the
    partials of ep = 4 ranks over their local slices, summed in a loop,
    are JAX's single-shard ``moe_apply`` (the all-reduce's sum)."""
    jcfg = _cfgs(8, 2)
    params, jq = jmodel[:2]
    jp = jq if quantized else params
    jmp = jp["segments"][0][0]["moe"] if quantized else \
        jax.tree.map(lambda a: a[0], jp["segments"][0][0]["moe"])
    x = np.random.default_rng(2).standard_normal((6, 64)).astype(np.float32)
    want, _, _ = jax.jit(lambda x, p: j_moe_apply(
        x, p, jcfg.moe, quantized=quantized, exact_capacity=True,
        impl="ref"))(jnp.asarray(x), jmp)
    tmp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    mp = tmp["layers"][0]["moe"]
    mcfg = _cfgs(8, 2, port=True).moe
    tot = 0
    for rank in range(4):
        loc = tsh.local_expert_slice(mp, 8, rank, 4, prefix="moe/")
        y, info = moe_ep_replicated_partial(
            torch.from_numpy(x), loc, mcfg, rank, 4, quantized=quantized,
            impl="auto")
        tot = tot + y
    np.testing.assert_allclose(tot.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


class _ThreadComm:
    """``ep`` ranks in one process, a thread each: ``ServeMesh``'s
    ``all_to_all`` and ``all_reduce`` (summed in rank order) over a
    shared board, in lockstep."""

    def __init__(self, board, barrier, rank: int, ep: int):
        self.board, self.barrier, self.rank, self.ep = board, barrier, \
            rank, ep

    def _swap(self, t):
        self.board[self.rank] = t.contiguous()
        self.barrier.wait()
        got = list(self.board)
        self.barrier.wait()
        return got

    def all_to_all(self, t):
        return torch.cat([a.chunk(self.ep)[self.rank]
                          for a in self._swap(t)])

    def all_reduce(self, t):
        got = self._swap(t)
        out = got[0].clone()
        for a in got[1:]:
            out += a
        return out


def _threaded(ep: int, fn):
    """``fn(comm)`` on ``ep`` thread ranks; their results by rank."""
    board, outs, errs = [None] * ep, [None] * ep, []
    barrier = threading.Barrier(ep, timeout=60)

    def run(r):
        try:
            outs[r] = fn(_ThreadComm(board, barrier, r, ep))
        except BaseException as e:          # noqa: BLE001 (re-raised)
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(ep)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return outs


@pytest.fixture(scope="module")
def moe64():
    """One E 64 top-6 MoE layer (DeepSeek-MoE's routing at a tiny width):
    JAX's params and output on 12 tokens (one compiled ``moe_apply``),
    the port's twin and its compression of it (the port's own, which the
    zoo tests hold to JAX's)."""
    from repro_torch.models.transformer import compress_moe_params
    jcfg = _cfgs(64, 6)
    jp = _j_init(jcfg)
    jmp = jax.tree.map(lambda a: a[0], jp["segments"][0][0]["moe"])
    x = np.random.default_rng(3).standard_normal((12, 64)) \
        .astype(np.float32)
    want, _, _ = jax.jit(lambda x, p: j_moe_apply(
        x, p, jcfg.moe, exact_capacity=True, impl="ref"))(
            jnp.asarray(x), jmp)
    cfg = _cfgs(64, 6, port=True)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tq, _, _ = compress_moe_params(tp, cfg)
    return x, np.asarray(want), cfg, tp["layers"][0]["moe"], \
        tq["layers"][0]["moe"]


@pytest.mark.parametrize("path", ["replicated", "a2a"])
@pytest.mark.parametrize("quantized", [False, True])
def test_top6_partials_cross_ranks(moe64, quantized, path):
    """Top-6 of 64 experts over ep 2 and 4 thread ranks: each token's six
    partials fall on several ranks.  The decode path's all-reduced
    partials and the prefill path's all-to-all (each rank dispatching its
    share of the tokens) give JAX's ``moe_apply`` (unquantized) and the
    port's single-shard ``moe_apply`` on its compressed stacks within
    1e-6: a partial dropped or counted twice would not."""
    from repro_torch.models.moe import (moe_apply, moe_apply_ep_a2a,
                                        moe_apply_ep_replicated)
    x, want, cfg, mp, qmp = moe64
    mp = qmp if quantized else mp
    xt = torch.from_numpy(x)
    if quantized:
        want = moe_apply(xt, mp, cfg.moe, quantized=True,
                         exact_capacity=True, impl="auto")[0].numpy()
    for ep in (2, 4):
        def rank(comm):
            loc = tsh.local_expert_slice(mp, 64, comm.rank, ep,
                                         prefix="moe/")
            if path == "replicated":
                return moe_apply_ep_replicated(xt, loc, cfg.moe, comm,
                                               quantized=quantized,
                                               impl="auto")[0]
            n = xt.shape[0] // ep
            return moe_apply_ep_a2a(xt[comm.rank * n:(comm.rank + 1) * n],
                                    loc, cfg.moe, comm, quantized=quantized,
                                    impl="auto", exact_capacity=True)[0]

        outs = _threaded(ep, rank)
        got = outs[0] if path == "replicated" else torch.cat(outs)
        if path == "replicated":
            for o in outs[1:]:
                assert torch.equal(o, outs[0])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0,
                                   err_msg=f"ep {ep}")


def test_kernel1_refuses_a_foreign_slice(hetero):
    """Kernel 1's wrapper checks that every per-expert operand holds the
    experts of ``xe``: a rank's 4-expert slice given 8 experts' tokens
    (what a forward without the mesh's region would pass) raises, on the
    CPU as on the card, before anything is read."""
    from repro_torch.kernels.quant_matmul import fused_expert_matmul
    s = tsh.slice_stack(hetero[1][0]["w1"], 4, 8)
    eb, rk = s.meta_tensors()
    me = torch.ones(8, 3)
    with pytest.raises(ValueError, match="xe holds 8 experts"):
        fused_expert_matmul(torch.zeros(8, 3, 64), s.planes, s.scale,
                            s.zero, s.u, s.u_scale, s.v, s.v_scale, me, None,
                            None, eb, rk, bits=s.bits,
                            group_size=s.group_size)


# ---------------------------------------------------------------------------
# one spawn of 4 gloo ranks: serving on the mesh against JAX
# ---------------------------------------------------------------------------

def _jax_offload(eng, stacks, ep, cap=8, prefetch=False, control=None):
    eng.attach_offload(stacks, policy="ours", cache_capacity=cap,
                       prefetch=prefetch, ep=ep)
    eng._controller = None
    if control is not None:
        eng.attach_controller(control)
    return eng


def _summary_jax(st):
    rep = st.offload_report
    return {"tokens": [r.tokens.tolist() for r in st.results],
            "logprobs": np.concatenate([r.logprobs for r in st.results]),
            "trace": st.router_trace,
            "report": {k: rep[k] for k in ("total_bytes", "tokens",
                                           "hit_rate", "per_shard_bytes",
                                           "ep", "compensator_bytes")},
            "plan_trace": st.plan_trace}


@pytest.fixture(scope="module")
def served(tmp_path_factory, jmodel, hetero):
    """JAX's single-device engine on both archs (reports at ep 1, 2 and 4)
    and a heterogeneous-bit artifact of ``hetero``'s stacks; then the 4
    ranks."""
    tmp = tmp_path_factory.mktemp("ep")
    mn, slots, chunk = SHAPE
    data = {"prompts": PROMPTS, "shape": SHAPE, "vocab": 64,
            "score_tokens": np.random.default_rng(7).integers(
                0, 64, (2, 24)).astype(np.int32)}
    jax_out = {}
    for arch, (e, k) in (("moe", (8, 2)), ("dense_e1", (1, 1))):
        jcfg = _cfgs(e, k)
        if arch == "moe":
            params, jq, jcq, jst = jmodel
        else:
            jq, jcq, jst = j_compress(_j_init(jcfg), jcfg)
        eng = JServeEngine(jcq, jq, quantized=True)
        for ep in (1, 2, 4):
            jax_out[f"{arch}/ep{ep}"] = _summary_jax(_jax_offload(
                eng, jst, ep).generate_many(PROMPTS, max_new=mn,
                                            num_slots=slots, chunk=chunk))
        tq = params_from_jax(jax.tree.map(np.asarray, jq), "cpu")
        data[arch] = (dataclasses.replace(_cfgs(e, k, port=True),
                                          force_unroll_plan=True), tq,
                      [lp["moe"]["stacks"] for lp in tq["layers"]])
    # a heterogeneous-bit artifact, written by the JAX package
    save_compression_artifact(str(tmp / "art"), _cfgs(8, 2), hetero[0])
    data["art_dir"] = str(tmp / "art")
    data["art_cfg"] = _cfgs(8, 2, port=True)
    data["art_params"] = params_from_jax(
        jax.tree.map(np.asarray, jmodel[0]), "cpu")
    data["control"] = ControlConfig(enabled=True, bytes_per_token=3000.0,
                                    budget_scope="per_shard")
    torch.save(data, tmp / "data.pt")
    ranks = run_ranks(torch_ep_worker.serve_ranks, 4, backend="gloo",
                      args=(str(tmp / "data.pt"),))
    return jax_out, ranks


def _same(got, want, bytes_too=True):
    assert got["tokens"] == want["tokens"]
    np.testing.assert_array_equal(got["trace"], want["trace"])
    np.testing.assert_allclose(got["logprobs"], want["logprobs"], **LP_TOL)
    if bytes_too:
        assert got["report"] == want["report"]


@pytest.mark.parametrize("arch", ["moe", "dense_e1"])
@pytest.mark.parametrize("ep", [2, 4])
def test_mesh_serve_matches_jax(served, arch, ep):
    """Every rank of an ep-way mesh serves JAX's single-device tokens,
    traces and log-probs, with the per-shard bytes of JAX's
    ``attach_offload(ep=N)``; E = 1 falls back to one store."""
    jax_out, ranks = served
    key = f"{arch}/ep{ep}"
    holders = [r for r in ranks if key in r]
    assert len(holders) == (4 if ep == 4 else 2)
    for r in holders:
        _same(r[key], jax_out[key])
        assert r[key]["shard_bytes"] == r[key]["report"]["per_shard_bytes"]
    rep = holders[0][key]["report"]
    assert rep["ep"] == (ep if arch == "moe" else 1)
    assert sum(rep["per_shard_bytes"]) == rep["total_bytes"] > 0
    # eviction-free: the bytes are conserved across shard counts
    assert rep["total_bytes"] == jax_out[f"{arch}/ep1"]["report"][
        "total_bytes"]
    if arch == "moe" and ep == 4:
        assert sum(b > 0 for b in rep["per_shard_bytes"]) >= 3
        assert holders[0]["comm_calls_ep4"] > 0


def test_mesh_paged_and_score(served):
    """ep 2: paged serving (page 4) gives the contiguous tokens, traces
    and bytes; ``score`` is the single-device engine's."""
    _, ranks = served
    for r in ranks[:2]:
        _same(r["moe/ep2/paged"], r["moe/ep2/contiguous"])
        assert r["moe/ep2/paged"]["report"]["ep"] == 2
        assert abs(r["moe/ep2/score"] - r["moe/score"]) <= 1e-5


def test_mesh_spec_and_per_shard_budget(served):
    """ep 2: greedy speculation, drafted by n-grams or by the target
    itself through the mesh, gives plain serve's tokens; a
    ``per_shard`` byte budget moves the plan, and the mesh gives the
    plan trace, tokens and bytes of the single-device engine metering
    through ``attach_offload(ep=2)`` (whose controller the unit test
    above holds to JAX's)."""
    _, ranks = served
    for r in ranks[2:]:
        assert r["moe/ep2/spec"]["tokens"] == r["moe/ep2/plain"]["tokens"]
        assert r["moe/ep2/spec_self"]["tokens"] == \
            r["moe/ep2/plain"]["tokens"]
        got, want = r["moe/ep2/per_shard"], r["moe/per_shard"]
        np.testing.assert_array_equal(got["plan_trace"], want["plan_trace"])
        assert len({str(p) for p in got["plan_trace"]}) > 1
        _same(got, want)
        assert got["report"]["ep"] == 2


def test_mesh_serves_jax_artifact_slices(served, hetero):
    """A heterogeneous-bit artifact the JAX package wrote loads into each
    rank of ep 2 as its slice (its experts' own widths and ranks) and
    serves the single-device engine's tokens with its bytes conserved,
    split over the shards."""
    _, ranks = served
    for r in ranks[2:]:
        _same(r["art/ep2"], r["art/ep1"], bytes_too=False)
        rep, one = r["art/ep2"]["report"], r["art/ep1"]["report"]
        assert rep["total_bytes"] == one["total_bytes"] > 0
        assert sum(rep["per_shard_bytes"]) == rep["total_bytes"]
        assert rep["ep"] == 2 and one["ep"] == 1
    for proj, s in hetero[0][0].items():
        for r, lo in ((ranks[2], 0), (ranks[3], 4)):
            assert r["art/local"][proj] == (
                tuple(s.expert_bits[lo:lo + 4]), tuple(s.ranks[lo:lo + 4]))

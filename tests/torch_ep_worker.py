"""The ranks of ``tests/test_torch_distributed.py``'s one gloo spawn.

A spawned rank imports this module by name, so it imports neither JAX
nor the test module: only the port, torch and numpy.  ``serve_ranks``
runs in each of 4 CPU ranks over one world; the ranks form an ep = 4
mesh (all of them) and two ep = 2 meshes (ranks 0-1 and 2-3), and serve
the weights the test wrote with ``torch.save`` (the JAX package's,
carried over by ``repro_torch.bridge``).  Each rank returns numpy
summaries; the test compares them with the JAX engine's.
"""
import numpy as np
import torch

from repro_torch.calib import load_compression_artifact
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.transformer import apply_compressed_stacks
from repro_torch.serve import ServeEngine, synthetic_workload


def summary(st) -> dict:
    """Tokens, log-probs, trace and offload report of a ``ServeStats``."""
    rep = st.offload_report
    return {
        "tokens": [r.tokens.tolist() for r in st.results],
        "logprobs": np.concatenate([r.logprobs for r in st.results]),
        "trace": st.router_trace,
        "report": None if rep is None else {
            k: rep[k] for k in ("total_bytes", "tokens", "hit_rate",
                                "per_shard_bytes", "ep",
                                "compensator_bytes")},
        "shard_bytes": (None if st.shard_bytes is None
                        else st.shard_bytes.tolist()),
        "plan_trace": st.plan_trace,
    }


def serve_ranks(rank: int, path: str) -> dict:
    data = torch.load(path, weights_only=False)
    prompts, (mn, slots, chunk) = data["prompts"], data["shape"]
    mesh4 = make_serve_mesh(4, backend="gloo", device="cpu")
    mesh2 = make_serve_mesh(2, backend="gloo", device="cpu")
    out = {"ep4_rank": mesh4.rank, "ep2_rank": mesh2.rank}

    def engine(arch, mesh, **kw):
        cfg, qparams, stacks = data[arch]
        eng = ServeEngine(cfg, qparams, quantized=True, device="cpu",
                          mesh=mesh)
        eng.attach_offload(stacks, policy="ours", cache_capacity=8,
                           prefetch=False, **kw)
        return eng

    for arch in ("moe", "dense_e1"):
        st = engine(arch, mesh4).generate_many(prompts, max_new=mn,
                                               num_slots=slots, chunk=chunk)
        out[f"{arch}/ep4"] = summary(st)
    out["comm_calls_ep4"] = mesh4.comm_calls
    if rank < 2:
        # ranks 0-1: the MoE arch at ep 2, its paged serve and score
        eng = engine("moe", mesh2)
        out["moe/ep2"] = summary(eng.generate_many(
            prompts, max_new=mn, num_slots=slots, chunk=chunk))
        reqs = lambda: synthetic_workload(5, data["vocab"], max_new=6,
                                          min_len=3, max_len=20, seed=3)
        eng.attach_offload(data["moe"][2], policy="ours", cache_capacity=8,
                           prefetch=False)
        out["moe/ep2/contiguous"] = summary(eng.serve(reqs(), num_slots=2,
                                                      chunk=3))
        eng.attach_offload(data["moe"][2], policy="ours", cache_capacity=8,
                           prefetch=False)
        out["moe/ep2/paged"] = summary(eng.serve(reqs(), num_slots=2,
                                                 chunk=3, page_size=4))
        out["moe/ep2/score"] = eng.score(data["score_tokens"])
        out["moe/score"] = engine("moe", None).score(data["score_tokens"])
    else:
        # ranks 2-3: E = 1 at ep 2, speculation (n-gram and self
        # drafters), the artifact, the per_shard budget
        out["dense_e1/ep2"] = summary(engine("dense_e1", mesh2)
                                      .generate_many(prompts, max_new=mn,
                                                     num_slots=slots,
                                                     chunk=chunk))
        eng = engine("moe", mesh2)
        reqs = lambda: synthetic_workload(4, data["vocab"], max_new=7,
                                          min_len=3, max_len=20, seed=5)
        out["moe/ep2/plain"] = summary(eng.serve(reqs(), num_slots=2,
                                                 chunk=3))
        out["moe/ep2/spec"] = summary(eng.serve(reqs(), num_slots=2,
                                                spec_k=2, drafter="ngram"))
        # the target drafting for itself: its forward runs the mesh's
        # MoE region over this rank's experts
        out["moe/ep2/spec_self"] = summary(eng.serve(
            reqs(), num_slots=2, spec_k=2, drafter="self"))
        cfg = data["art_cfg"]
        local, _, _ = load_compression_artifact(
            data["art_dir"], cfg, device="cpu", shard=(mesh2.rank, 2))
        full, _, _ = load_compression_artifact(data["art_dir"], cfg,
                                               device="cpu")
        meta, _, _ = load_compression_artifact(data["art_dir"], cfg,
                                               device="meta")
        for tag, stacks, mesh in (("ep2", local, mesh2), ("ep1", full, None)):
            qp, cfg_q = apply_compressed_stacks(data["art_params"], cfg,
                                                stacks)
            art = ServeEngine(cfg_q, qp, quantized=True, device="cpu",
                              mesh=mesh)
            art.attach_offload(meta, policy="ours", cache_capacity=8,
                               prefetch=False)
            out[f"art/{tag}"] = summary(art.generate_many(
                prompts, max_new=mn, num_slots=slots, chunk=chunk))
        out["art/local"] = {k: (s.expert_bits, s.ranks)
                            for k, s in local[0].items()}
        work = lambda: synthetic_workload(5, data["vocab"], max_new=8,
                                          seed=3)
        for tag, mesh, ep in (("moe/ep2/per_shard", mesh2, None),
                              ("moe/per_shard", None, 2)):
            eng = engine("moe", mesh, ep=ep)
            eng.attach_offload(data["moe"][2], policy="ours",
                               cache_capacity=2, ep=ep)
            eng.attach_controller(data["control"])
            out[tag] = summary(eng.serve(work(), num_slots=2, chunk=4))
    return out


def card_ranks(rank: int, job: dict) -> dict:
    """A rank of ``tests/test_torch_cuda.py``'s 2-rank gloo mesh on
    cuda:0: the seeded params and this rank's slice of the artifact's
    experts, ``generate`` of the job's prompts."""
    from repro_torch.models.transformer import init_params
    dev = torch.device("cuda:0")
    mesh = make_serve_mesh(2, backend="gloo", device=dev)
    params = init_params(job["cfg"], seed=0, dtype=torch.float32,
                         device=dev)
    local, _, _ = load_compression_artifact(job["art"], job["cfg_q"],
                                            device=dev, shard=(mesh.rank, 2))
    qp, cfg_q = apply_compressed_stacks(params, job["cfg"], local)
    eng = ServeEngine(cfg_q, qp, quantized=True, device=dev, mesh=mesh)
    res = eng.generate(job["prompts"], max_new=job["new"])
    return {"tokens": res.tokens, "trace": res.router_trace,
            "logprobs": res.logprobs, "comm_calls": mesh.comm_calls}

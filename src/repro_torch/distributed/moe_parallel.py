"""Expert-parallel MoE execution (port of
``repro/distributed/moe_parallel.py``).

Wraps ``models.moe.moe_apply_ep_a2a`` (prefill: dispatch all-to-all) and
``moe_apply_ep_replicated`` (decode: resident-expert partials +
all-reduce) for the MoE block of ``models.transformer``, over a
``launch.mesh.ServeMesh``.  Falls back to the plain single-shard path,
every expert on every rank, when the expert count does not divide the
mesh (or at ``ep == 1``), as the JAX package does.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import ModelConfig, ParallelConfig
from ..models.moe import moe_apply, moe_apply_ep_a2a, moe_apply_ep_replicated
from .sharding import mesh_spec

EP_AXIS = "model"


def ep_size(mesh) -> int:
    """Expert-parallel degree of a mesh (size of the EP axis, 1 if none)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(EP_AXIS, 1))


def make_moe_ep_fn(mesh, pcfg: Optional[ParallelConfig] = None) -> Callable:
    """Returns ``ctx.moe_ep_fn(h, mp, cfg, ctx, plan=None) -> (y, aux,
    info)`` for (B, S, d) inputs ``h``; ``info`` is the routing of all
    B * S tokens (the first-class trace output of the single-shard path,
    so the engine and the offload meter see the same routing on any
    path).

    ``plan`` is this layer's (2,) [top_n, rank_cap] row of the bandwidth
    controller's plan: every rank applies the same row.  The shared
    experts (``mp['shared']``) stay out of the region: the caller adds
    them on every rank.  In the a2a mode (prefill) each rank dispatches
    only its share of the sequence when the mesh divides it (the JAX
    rules' ``moe_seq``: otherwise every rank would route the same tokens
    and the expert work would repeat ep-fold), and the outputs and
    routings are gathered back along the sequence."""
    pcfg = pcfg or ParallelConfig()

    def moe_ep_fn(h, mp, cfg: ModelConfig, ctx, plan=None):
        mcfg = cfg.moe
        ep = ep_size(mesh)
        quantized = ctx.quantized and "stacks" in mp
        with_aux = ctx.mode == "train"
        mp_local = {k: v for k, v in mp.items() if k != "shared"}
        b, s, d = h.shape
        kw = dict(act=cfg.act, quantized=quantized, impl=ctx.kernel_impl,
                  plan=plan, with_aux=with_aux)
        if mcfg.num_experts % ep or ep == 1:
            y2, aux, info = moe_apply(h.reshape(-1, d), mp_local, mcfg,
                                      exact_capacity=ctx.exact_capacity,
                                      **kw)
            return y2.reshape(b, s, d), aux, info
        if ctx.ep_mode == "replicated":
            y2, aux, info = moe_apply_ep_replicated(
                h.reshape(-1, d), mp_local, mcfg, mesh, **kw)
            return y2.reshape(b, s, d), aux, info
        # a2a: the sequence split inside the region (JAX's moe_seq rule)
        split = mesh_spec(mesh.shape, ("batch", "moe_seq", None), h.shape,
                          pcfg)
        if len(split) < 2 or split[1] is None:
            y2, aux, info = moe_apply_ep_a2a(
                h.reshape(-1, d), mp_local, mcfg, mesh,
                exact_capacity=ctx.exact_capacity, **kw)
            return y2.reshape(b, s, d), aux, info
        sl = s // ep
        h_l = h[:, mesh.rank * sl:(mesh.rank + 1) * sl]
        y2, aux, info = moe_apply_ep_a2a(
            h_l.reshape(-1, d), mp_local, mcfg, mesh,
            exact_capacity=ctx.exact_capacity, **kw)

        def gather(a):
            # (b * sl, ...) per rank -> (b * s, ...) in token order
            g = mesh.all_gather(a.reshape((1, b, sl) + a.shape[1:]))
            return g.transpose(0, 1).reshape((b * s,) + a.shape[1:])

        y = gather(y2).reshape(b, s, d)
        info = type(info)(*(gather(f) for f in info))
        return y, aux, info

    return moe_ep_fn

"""Mixture-of-Experts layer with router-guided low-rank restoration
(port of ``repro/models/moe.py``).

Routing is softmax-then-top-k; dispatch scatters (T, d) tokens into
(E, C, d) expert buffers by index; each (expert, slot) carries a 0/1
top-n compensation mask; the expert FFN is run by a backend from
``models.expert_backend``; combine gathers and scatter-adds back.

Three paths share that core:

- ``moe_apply`` (single shard, all experts);
- ``moe_apply_ep_a2a`` (prefill): tokens local, experts sharded over
  the ranks of a ``launch.mesh.ServeMesh``; two all-to-alls move the
  dispatched slots to their expert's rank and back;
- ``moe_apply_ep_replicated`` (decode): tokens replicated; each rank
  runs only its resident experts (``moe_ep_replicated_partial``, which
  needs no process group) and an all-reduce sums the partials.

In the expert-parallel paths ``params`` holds the rank's LOCAL slice of
experts (``distributed.sharding.local_expert_slice``) and the whole
router.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import MoEConfig
from .expert_backend import ExpertBackend, select_backend


class RoutingInfo(NamedTuple):
    gates: torch.Tensor       # (T, k) normalized top-k gate values
    topk_idx: torch.Tensor    # (T, k) expert ids, descending score
    probs: torch.Tensor       # (T, E) full softmax
    logits: torch.Tensor      # (T, E)


def route(x2: torch.Tensor, w_router: torch.Tensor, mcfg: MoEConfig
          ) -> RoutingInfo:
    """x2: (T, d) -> routing for the top-k experts."""
    logits = x2.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, topi = torch.topk(probs, mcfg.top_k, dim=-1)
    if mcfg.router_norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return RoutingInfo(gates, topi, probs, logits)


def aux_losses(info: RoutingInfo, mcfg: MoEConfig) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance + router z-loss."""
    e = info.probs.shape[-1]
    frac = F.one_hot(info.topk_idx[:, 0], e).float().mean(0)
    lb = e * torch.sum(frac * info.probs.mean(0))
    z = torch.mean(torch.logsumexp(info.logits, dim=-1) ** 2)
    return {"load_balance": lb * mcfg.router_aux_weight,
            "router_z": z * mcfg.router_z_weight}


class Dispatch(NamedTuple):
    e_idx: torch.Tensor       # (T*k,) target expert per assignment
    slot: torch.Tensor        # (T*k,) capacity slot (>= C means dropped)
    t_idx: torch.Tensor       # (T*k,) source token per assignment
    gates: torch.Tensor       # (T*k,)
    comp: torch.Tensor        # (T*k,) 1.0 if assignment rank < top_n
    capacity: int
    # (E,) i32 occupied leading slots per expert (slots fill from 0)
    rows: torch.Tensor


def make_dispatch(info: RoutingInfo, num_experts: int, capacity: int,
                  top_n) -> Dispatch:
    t, k = info.topk_idx.shape
    dev = info.topk_idx.device
    e_idx = info.topk_idx.reshape(-1)
    # slot within expert: the running count of the expert's earlier
    # assignments.  The one-hot is laid out (E, T*k) so that the count
    # runs along the contiguous dimension: on an H100 a scan down the
    # (T*k, E) layout's columns took ~1.1 ms per layer at T*k 6144, E 64
    oh = (torch.arange(num_experts, device=dev)[:, None]
          == e_idx[None, :]).to(torch.int32)                 # (E, T*k)
    slot = (torch.cumsum(oh, dim=1) - oh)[e_idx,
                                          torch.arange(t * k, device=dev)]
    t_idx = torch.arange(t, device=dev).repeat_interleave(k)
    rank = torch.arange(k, device=dev).repeat(t)
    comp = (rank < top_n).float()
    rows = torch.clamp(oh.sum(1), max=capacity).to(torch.int32)
    return Dispatch(e_idx, slot, t_idx, info.gates.reshape(-1), comp,
                    capacity, rows)


def _sink_slots(d: Dispatch) -> torch.Tensor:
    """Slot per assignment, with dropped ones (slot >= C) sent to a sink
    slot C that is cut off afterwards (no host sync for a boolean mask)."""
    return torch.clamp(d.slot, max=d.capacity)


def dispatch_tokens(x2: torch.Tensor, d: Dispatch, num_experts: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter (T, dm) tokens into (E, C, dm) buffers + comp mask; slots
    past the capacity are dropped.  Each token's k copies are a broadcast
    (assignments are token-major), not a gather by ``t_idx``: the same
    rows, and in training their gradient is a sum over k, where a
    gather's backward adds with atomics in any order on the card."""
    t, dm = x2.shape
    slot = _sink_slots(d)
    xe = torch.zeros((num_experts, d.capacity + 1, dm), dtype=x2.dtype,
                     device=x2.device)
    k = d.e_idx.shape[0] // t
    xe[d.e_idx, slot] = x2[:, None].expand(t, k, dm).reshape(t * k, dm)
    me = torch.zeros((num_experts, d.capacity + 1), dtype=torch.float32,
                     device=x2.device)
    me[d.e_idx, slot] = d.comp
    return xe[:, :d.capacity].contiguous(), me[:, :d.capacity].contiguous()


def dispatch_gates(d: Dispatch, num_experts: int) -> torch.Tensor:
    """Router gates in the (E, C) slot layout (for backends that fold
    the gates into their output)."""
    ge = torch.zeros((num_experts, d.capacity + 1), dtype=torch.float32,
                     device=d.gates.device)
    ge[d.e_idx, _sink_slots(d)] = d.gates.float()
    return ge[:, :d.capacity].contiguous()


def combine_tokens(ye: torch.Tensor, d: Dispatch, num_tokens: int, *,
                   pre_weighted: bool = False) -> torch.Tensor:
    """Gather (E, C, dm) expert outputs back to (T, dm), gate-weighted
    unless the backend already folded the gates in.

    Each token's k outputs are summed in router-rank order, one rounded
    add at a time: the order of the JAX package's sequential scatter-add,
    and the same on every run (``index_add_`` on a CUDA tensor adds with
    atomics in any order, which in bf16 changes the sum from run to run
    once a token has more than two experts)."""
    keep = d.slot < d.capacity
    ya = ye[d.e_idx, torch.clamp(d.slot, max=d.capacity - 1)]
    ya = ya * keep[:, None].to(ya.dtype)
    if not pre_weighted:
        ya = ya * d.gates[:, None].to(ya.dtype)
    # assignments are token-major (make_dispatch): row t * k + j
    ya = ya.reshape(num_tokens, -1, ye.shape[-1])
    y = ya[:, 0]
    for j in range(1, ya.shape[1]):
        y = y + ya[:, j]
    return y


def _capacity(tokens: int, mcfg: MoEConfig, exact: bool) -> int:
    if exact:
        return tokens
    c = int(math.ceil(tokens * mcfg.top_k * mcfg.capacity_factor
                      / mcfg.num_experts))
    return max(8, -(-c // 8) * 8)


def _plan_knobs(mcfg: MoEConfig, quantized: bool, plan):
    """(top_n, rank_cap) of one MoE layer: the static QuantConfig values,
    or a (2,) plan row."""
    if not quantized:
        return 0, None
    if plan is None:
        return mcfg.quant.top_n_restore, None
    return plan[0], plan[1]


def moe_apply(x2: torch.Tensor, params: Dict, mcfg: MoEConfig, *,
              act: str = "silu", quantized: bool = False,
              exact_capacity: bool = False, impl: Optional[str] = None,
              backend: Optional[ExpertBackend] = None,
              plan: Optional[torch.Tensor] = None, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], RoutingInfo]:
    """x2: (T, d) -> (T, d), aux losses, routing info.  ``with_aux=False``
    skips the auxiliary losses (serving never reads them; eager PyTorch
    would still launch their kernels)."""
    t = x2.shape[0]
    backend = backend or select_backend(params, quantized, impl)
    info = route(x2, params["router"], mcfg)
    cap = _capacity(t, mcfg, exact_capacity)
    top_n, rank_cap = _plan_knobs(mcfg, quantized, plan)
    disp = make_dispatch(info, mcfg.num_experts, cap, top_n)
    xe, me = dispatch_tokens(x2, disp, mcfg.num_experts)
    fuse = backend.fuses_gates
    ge = dispatch_gates(disp, mcfg.num_experts) if fuse else None
    ye = backend(xe, params, me, act, rank_cap=rank_cap, gates=ge,
                 rows=disp.rows)
    y = combine_tokens(ye, disp, t, pre_weighted=fuse)
    aux = aux_losses(info, mcfg) if with_aux else {}
    return y.to(x2.dtype), aux, info


# ---------------------------------------------------------------------------
# expert-parallel paths (``comm``: a ``launch.mesh.ServeMesh``)
# ---------------------------------------------------------------------------

def moe_apply_ep_a2a(x2: torch.Tensor, params: Dict, mcfg: MoEConfig, comm,
                     *, act: str = "silu", quantized: bool = False,
                     impl: Optional[str] = None,
                     backend: Optional[ExpertBackend] = None,
                     plan: Optional[torch.Tensor] = None,
                     exact_capacity: bool = False, with_aux: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                RoutingInfo]:
    """Tokens local, experts sharded over ``comm``'s ranks: dispatch into
    (E, C, d) slots, all-to-all so that each rank receives its E/ep
    experts' slots from every rank ((E/ep, ep * C, d), source-rank major
    along the slots, as JAX's tiled ``all_to_all`` concatenates), run the
    experts, all-to-all back and combine.  ``exact_capacity`` dispatches
    at capacity = local tokens (drop-free).  Aux losses are averaged
    over the ranks."""
    t, d = x2.shape
    ep = comm.ep
    e_total = mcfg.num_experts
    e_local = e_total // ep
    backend = backend or select_backend(params, quantized, impl)
    info = route(x2, params["router"], mcfg)
    cap = _capacity(t, mcfg, exact_capacity)
    top_n, rank_cap = _plan_knobs(mcfg, quantized, plan)
    disp = make_dispatch(info, e_total, cap, top_n)
    xe, me = dispatch_tokens(x2, disp, e_total)            # (E, C, d)
    fuse = backend.fuses_gates
    ge = dispatch_gates(disp, e_total) if fuse else None

    def to_experts(a):
        # (E, C, ...) -> (E/ep, ep * C, ...): rank j's slots of my experts
        # land at [j * C, (j + 1) * C)
        r = comm.all_to_all(a)
        r = r.reshape((ep, e_local) + a.shape[1:]).transpose(0, 1)
        return r.reshape((e_local, ep * a.shape[1]) + a.shape[2:])

    xe, me = to_experts(xe), to_experts(me)
    ge = to_experts(ge) if ge is not None else None
    # slots from several ranks are not leading-contiguous: no row counts
    ye = backend(xe, params, me, act, rank_cap=rank_cap, gates=ge)
    # (E/ep, ep * C, d) -> (E, C, d): each rank's slots back to it
    ye = ye.reshape(e_local, ep, cap, d).transpose(0, 1)
    ye = comm.all_to_all(ye.reshape(e_total, cap, d))
    y = combine_tokens(ye, disp, t, pre_weighted=fuse)
    aux = {}
    if with_aux:
        aux = {k: comm.all_reduce(v.reshape(1))[0] / ep
               for k, v in aux_losses(info, mcfg).items()}
    return y.to(x2.dtype), aux, info


def moe_ep_replicated_partial(x2: torch.Tensor, params: Dict,
                              mcfg: MoEConfig, rank: int, ep: int, *,
                              act: str = "silu", quantized: bool = False,
                              impl: Optional[str] = None,
                              backend: Optional[ExpertBackend] = None,
                              plan: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, RoutingInfo]:
    """Rank ``rank`` of ``ep``'s share of the decode path: every token
    routed, global expert ids mapped into the rank's slice (experts of
    other ranks to an out-of-bounds sentinel expert whose slots are cut
    off), the resident E/ep experts run at exact capacity.  Returns the
    (T, d) partial output and the routing; the partials of all ranks sum
    to ``moe_apply``'s output.  Needs no process group."""
    t = x2.shape[0]
    e_local = mcfg.num_experts // ep
    backend = backend or select_backend(params, quantized, impl)
    info = route(x2, params["router"], mcfg)
    local = info.topk_idx - rank * e_local
    oob = (local < 0) | (local >= e_local)
    local = torch.where(oob, torch.full_like(local, e_local), local)
    local_info = RoutingInfo(torch.where(oob, torch.zeros_like(info.gates),
                                         info.gates), local, info.probs,
                             info.logits)
    top_n, rank_cap = _plan_knobs(mcfg, quantized, plan)
    disp = make_dispatch(local_info, e_local + 1, t, top_n)
    xe, me = dispatch_tokens(x2, disp, e_local + 1)
    fuse = backend.fuses_gates
    ge = dispatch_gates(disp, e_local + 1)[:e_local] if fuse else None
    ye = backend(xe[:e_local], params, me[:e_local], act, rank_cap=rank_cap,
                 gates=ge, rows=disp.rows[:e_local])
    ye = torch.cat([ye, torch.zeros_like(ye[:1])], dim=0)
    return combine_tokens(ye, disp, t, pre_weighted=fuse), info


def moe_apply_ep_replicated(x2: torch.Tensor, params: Dict, mcfg: MoEConfig,
                            comm, *, act: str = "silu",
                            quantized: bool = False,
                            impl: Optional[str] = None,
                            backend: Optional[ExpertBackend] = None,
                            plan: Optional[torch.Tensor] = None,
                            with_aux: bool = True
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                       RoutingInfo]:
    """Decode path: tokens replicated over ``comm``'s ranks; each rank's
    resident-expert partial (``moe_ep_replicated_partial``), summed by an
    all-reduce."""
    y, info = moe_ep_replicated_partial(
        x2, params, mcfg, comm.rank, comm.ep, act=act, quantized=quantized,
        impl=impl, backend=backend, plan=plan)
    y = comm.all_reduce(y)
    aux = aux_losses(info, mcfg) if with_aux else {}
    return y.to(x2.dtype), aux, info

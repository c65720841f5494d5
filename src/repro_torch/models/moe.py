"""Mixture-of-Experts layer with router-guided low-rank restoration,
single-shard path (port of ``repro/models/moe.py``).

Routing is softmax-then-top-k; dispatch scatters (T, d) tokens into
(E, C, d) expert buffers by index; each (expert, slot) carries a 0/1
top-n compensation mask; the expert FFN is run by a backend from
``models.expert_backend``; combine gathers and scatter-adds back.
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
    past the capacity are dropped."""
    dm = x2.shape[-1]
    slot = _sink_slots(d)
    xe = torch.zeros((num_experts, d.capacity + 1, dm), dtype=x2.dtype,
                     device=x2.device)
    xe[d.e_idx, slot] = x2[d.t_idx]
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

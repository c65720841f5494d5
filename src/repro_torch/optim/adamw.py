"""AdamW with f32 master weights over the compute parameters (port of
``repro/optim/adamw.py``).

The state mirrors the parameter tree.  ``adamw_update`` keeps the JAX
package's order of operations, but updates the master copy and the
moments in place and casts the new master into the parameter tensors
the model already holds, in their dtype (JAX returns a fresh tree in
``param_dtype``): no second copy of the model per step.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..config import TrainConfig
from ..tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    master: Any          # f32 master copy of params
    m: Any
    v: Any


def adamw_init(params) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(
        torch.zeros((), dtype=torch.int32, device=dev),
        # a copy: the master must never alias the compute params
        tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params),
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params))


def warmup_cosine(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = s / max(tcfg.warmup_steps, 1)
    total = max(tcfg.total_steps - tcfg.warmup_steps, 1)
    prog = torch.clamp((s - tcfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.lr * torch.where(s < tcfg.warmup_steps, warm,
                                 torch.clamp(cos, min=0.02))


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        g32 = g.float()
        total = total + torch.sum(g32 * g32)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most
    ``max_norm``; returns them and their norm before clipping."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


@torch.no_grad()
def adamw_update(grads, state: OptState, tcfg: TrainConfig, params
                 ) -> Tuple[Any, OptState, Dict]:
    """Returns (``params``, new state, metrics).  The master, the moments
    and ``params`` (the new master, cast) are updated in place; so are
    f32 ``grads`` when clipped."""
    grads = tree_map(lambda g: g.float(), grads)
    if tcfg.clip_norm:
        grads, gn = clip_by_global_norm(grads, tcfg.clip_norm)
    else:
        gn = global_norm(grads)
    step = state.step + 1
    lr = warmup_cosine(tcfg, step)
    b1, b2, eps, wd = tcfg.b1, tcfg.b2, tcfg.eps, tcfg.weight_decay
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for g, p, m, v in zip(tree_leaves(grads), tree_leaves(state.master),
                          tree_leaves(state.m), tree_leaves(state.v)):
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p
        p.sub_(lr * upd)
    for dst, src in zip(tree_leaves(params), tree_leaves(state.master)):
        dst.copy_(src)
    return (params, OptState(step, state.master, state.m, state.v),
            {"grad_norm": gn, "lr": lr})

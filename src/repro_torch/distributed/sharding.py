"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Parameters and caches are annotated with *logical* axes by path-suffix
regex rules; a ``ParallelConfig`` maps logical names to mesh axes, and a
mapping that does not divide the dimension falls back to successively
shorter mesh-axis prefixes and finally to replication.  ``mesh_spec``
returns the JAX package's ``PartitionSpec`` entries as a tuple (``None``
for a replicated dim, an axis name or a tuple of names otherwise).

The port serves expert-parallel with only the MoE experts sharded
(``launch/mesh.py``): ``local_expert_slice`` cuts a rank's slice of a
param or stack tree by the rules' ``expert`` axis and keeps every other
leaf whole.  JAX's GSPMD also shards heads, mlp and vocab over the
``model`` axis, a placement of the same function that the port does not
build.  ``tree_constraint`` and ``constraint_fn`` pin GSPMD shardings
inside a jitted function and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ParallelConfig
from ..core.pipeline import CompressedExpertStack

# (path-suffix regex, logical axes aligned to the TRAILING dims)
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/tok$",                ("vocab", "embed")),
    (r"head/w$",                   ("embed", "vocab")),
    (r"attn/wq$",                  ("embed", "heads", None)),
    (r"attn/(wk|wv)$",             ("embed", "kv_heads", None)),
    (r"attn/wo$",                  ("heads", None, "embed")),
    (r"attn/(bq|bk|bv)$",          (None, None)),
    (r"cross_wq$",                 ("embed", "heads", None)),
    (r"cross_(wk|wv)$",            (None, "heads", None)),
    (r"cross_wo$",                 ("heads", None, "embed")),
    (r"ffn/(w1|w3)$",              ("embed", "mlp")),
    (r"ffn/w2$",                   ("mlp", "embed")),
    (r"shared/(w1|w3)$",           ("embed", "mlp")),
    (r"shared/w2$",                ("mlp", "embed")),
    (r"moe/router$",               ("embed", None)),
    (r"moe/(w1|w3)$",              ("expert", "embed", "expert_mlp")),
    (r"moe/w2$",                   ("expert", "expert_mlp", "embed")),
    # compressed expert stacks (serving): shard by expert, keep factors local
    (r"moe/stacks/\w+/(planes/\d+|scale|zero|u|v|u_scale|v_scale)$",
     ("expert", None, None)),
    (r"ffn/stacks/(w1|w3)/(planes/\d+|scale|zero)$", (None, None, "mlp")),
    (r"ffn/stacks/w2/(planes/\d+|scale|zero)$",      (None, "mlp_in", "embed")),
    (r"ffn/stacks/\w+/(u|v|u_scale|v_scale)$",       (None, None, None)),
    (r"rglru/(wx|wgate)$",         ("embed", "lru")),
    (r"rglru/wo$",                 ("lru", "embed")),
    (r"rglru/(rg_wa|rg_wx)$",      (None, "lru")),
    (r"rglru/(conv_w)$",           (None, "lru")),
    (r"rglru/(conv_b|rg_ba|rg_bx|lam)$", ("lru",)),
    (r"mlstm/w_up$",               ("embed", "mlp")),
    (r"mlstm/(wq|wk|wv)$",         ("mlp", None, None)),
    (r"mlstm/w_if$",               ("mlp", None)),
    (r"mlstm/w_down$",             ("mlp", "embed")),
    (r"slstm/w_zifo$",             ("embed", None, None, None)),
    (r"(norm|scale|bias|b_if|b_zifo|lam)\w*$", None),  # replicate small
)

CACHE_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"/(k|v)$",        ("batch", "kv_seq", "kv_heads", None)),
    (r"/(k_scale|v_scale)$", ("batch", "kv_seq", "kv_heads")),
    (r"/pos$",          ("batch", "kv_seq")),
    (r"/(cross_k|cross_v)$", ("batch", None, "heads", None)),
    (r"/h$",            ("batch", "lru")),
    (r"/conv$",         ("batch", None, "lru")),
    (r"/c$",            ("batch", None, None, None)),
    (r"/(n|m)$",        ("batch", None, None)),
)


def logical_axes_for(path: str, ndim: int, rules) -> Tuple[Optional[str], ...]:
    """Match path suffix against rules; align to trailing dims."""
    for pat, axes in rules:
        if re.search(pat, path):
            if axes is None:
                return (None,) * ndim
            axes = tuple(axes)
            if len(axes) > ndim:  # unstacked (repeat-1) leaf
                axes = axes[len(axes) - ndim:]
            return (None,) * (ndim - len(axes)) + axes
    return (None,) * ndim


def mesh_spec(mesh_shape: Mapping[str, int],
              logical: Sequence[Optional[str]], shape: Sequence[int],
              pcfg: ParallelConfig) -> Tuple[Any, ...]:
    """Logical axes -> partition spec entries with divisibility fallback.

    ``mesh_shape``: mesh axis name -> size (a ``ServeMesh``'s ``shape``).
    Trailing replicated entries are dropped, as the JAX package
    normalises its ``PartitionSpec``."""
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        entry: Any = None
        if name is not None:
            axes = tuple(a for a in pcfg.rule_for(name)
                         if a in mesh_shape and a not in used)
            # longest divisible prefix
            while axes:
                size = int(np.prod([mesh_shape[a] for a in axes]))
                if dim % size == 0:
                    break
                axes = axes[:-1]
            if axes:
                entry = axes if len(axes) > 1 else axes[0]
                used.update(axes)
        out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def slice_stack(stack: CompressedExpertStack, lo: int, hi: int
                ) -> CompressedExpertStack:
    """Experts ``[lo, hi)`` of a stack, their true widths and ranks
    included (the kernel reads them per expert as device data), tagged
    with the range so that ``local_expert_slice`` can check it."""
    return dataclasses.replace(
        stack, planes=tuple(p[lo:hi] for p in stack.planes),
        scale=stack.scale[lo:hi], zero=stack.zero[lo:hi],
        u=stack.u[lo:hi], v=stack.v[lo:hi], u_scale=stack.u_scale[lo:hi],
        v_scale=stack.v_scale[lo:hi],
        shape=(hi - lo,) + tuple(stack.shape[1:]),
        ranks=tuple(stack.ranks[lo:hi]),
        expert_bits=(None if stack.expert_bits is None
                     else tuple(stack.expert_bits[lo:hi])),
        _meta={}, _experts=(lo, hi))


def local_expert_slice(tree, num_experts: int, rank: int, ep: int,
                       pcfg: Optional[ParallelConfig] = None,
                       prefix: str = ""):
    """The tree a rank of an ``ep``-way mesh serves from: every leaf whose
    path the rules map to the ``expert`` logical axis, and whose expert
    dim the mesh divides (``mesh_spec``), cut to the rank's slice
    ``[rank * E/ep, (rank + 1) * E/ep)``; every other leaf the same
    object.  A leaf holds all E experts, or is a stack that this function
    already cut to the same rank's slice (a loader's ``shard=``), which
    is kept; anything else raises.  ``prefix`` is the tree's path in the
    whole params (a layer's ``moe`` dict: ``"layers/3/moe/"``)."""
    pcfg = pcfg or ParallelConfig()
    lo, hi = rank * (num_experts // ep), (rank + 1) * (num_experts // ep)

    def sharded_dim(path, t: torch.Tensor) -> Optional[int]:
        # whether the mesh cuts the leaf is a question about all E
        # experts, whichever slice the leaf holds
        ax = logical_axes_for(path, t.dim(), PARAM_RULES)
        if "expert" not in ax or ep <= 1:
            return None
        dim = ax.index("expert")
        shape = t.shape[:dim] + (num_experts,) + t.shape[dim + 1:]
        spec = mesh_spec({"model": ep}, ax, shape, pcfg)
        if dim >= len(spec) or spec[dim] is None:
            return None              # E does not divide: replicated
        return dim

    def whole(path, n: int, held=None):
        if n != num_experts:
            raise ValueError(
                f"{path}: holds experts {held or n}; rank {rank} of {ep} "
                f"serves [{lo}, {hi}) of {num_experts}, cut from all of "
                "them")

    def walk(node, path):
        if isinstance(node, CompressedExpertStack):
            if sharded_dim(path + "scale", node.scale) is None:
                return node
            if node._experts == (lo, hi):
                return node
            whole(path, node.shape[0], node._experts)
            return slice_stack(node, lo, hi)
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}{i}/") for i, v in enumerate(node)]
        if isinstance(node, torch.Tensor):
            dim = sharded_dim(path.rstrip("/"), node)
            if dim is None:
                return node
            whole(path, node.shape[dim])
            return node.narrow(dim, lo, hi - lo)
        return node

    return walk(tree, prefix)


"""Move the JAX package's parameters into the port's layout.

The input is the JAX parameter tree with numpy (or any array-protocol)
leaves, e.g. ``jax.tree.map(np.asarray, params)``: nested dicts, the
``segments`` tuple of scanned layer groups, and compressed expert stacks
as objects carrying the ``CompressedExpertStack`` fields.  Nothing here
imports ``jax`` or ``repro``: stacks are read by attribute.  bfloat16
leaves cross through a ``uint16`` view, as the JAX checkpoint writer
stores them.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from . import resolve_device
from .core.pipeline import CompressedExpertStack

_STACK_FIELDS = ("planes", "scale", "zero", "u", "v", "u_scale", "v_scale")


def to_torch(a, device=None) -> torch.Tensor:
    """One array -> tensor on ``device`` (bf16 through a uint16 view)."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(resolve_device(device))


def stack_to_torch(s, device=None) -> CompressedExpertStack:
    """A JAX ``CompressedExpertStack`` (numpy or jax leaves) -> the port's."""
    leaves = {f: getattr(s, f) for f in _STACK_FIELDS}
    eb = getattr(s, "expert_bits", None)
    return CompressedExpertStack(
        planes=tuple(to_torch(p, device) for p in leaves["planes"]),
        **{f: to_torch(leaves[f], device) for f in _STACK_FIELDS[1:]},
        bits=int(s.bits), group_size=int(s.group_size),
        shape=tuple(int(x) for x in s.shape),
        ranks=tuple(int(r) for r in s.ranks), pad_rank=int(s.pad_rank),
        factor_bits=int(s.factor_bits),
        expert_bits=None if eb is None else tuple(int(b) for b in eb))


def tree_to_torch(tree, device=None):
    """Convert dicts / sequences / stacks / arrays recursively."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if hasattr(tree, "planes") and hasattr(tree, "pad_rank"):
        return stack_to_torch(tree, device)
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return to_torch(tree, device)


def _slice(tree, r: int):
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _unstack_layers(segments) -> List[Dict[str, Any]]:
    """JAX ``segments`` (tuple of pattern-position tuples, leaves with a
    leading repeat axis when a segment repeats) -> per-layer dicts in
    global layer order (repeat-major, pattern position minor)."""
    layers = []
    for seg in segments:
        repeat = (np.asarray(seg[0]["pre_norm"]).shape[0]
                  if np.ndim(seg[0]["pre_norm"]) == 2 else 0)
        if repeat == 0:
            layers.extend(seg)
            continue
        for r in range(repeat):
            layers.extend(_slice(lp, r) for lp in seg)
    return layers


def params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree -> the port's parameter dict
    (``layers`` list instead of scanned ``segments``)."""
    out = {k: tree_to_torch(v, device) for k, v in tree.items()
           if k != "segments"}
    out["layers"] = [tree_to_torch(lp, device)
                     for lp in _unstack_layers(tree["segments"])]
    return out

"""Expert-execution backends over dispatched (E, C, d) buffers (port of
``repro/models/expert_backend.py``).

  ``dense``   einsum over full-precision (E, d, f) stacks
  ``ref``     quantized experts with masked compensation, through the
              reference composition (``core.restoration``)
  ``kernel``  the fused CUDA kernel once per projection
              (``kernels.ops.fused_expert_matmul``); on the down
              projection the kernel also folds in the router gates
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.restoration import compensated_expert_ffn
from ..kernels import ops
from .layers import activation


def expert_ffn_dense(xe: torch.Tensor, w1, w3, w2, act: str) -> torch.Tensor:
    """xe: (E, C, d); w1/w3: (E, d, f); w2: (E, f, d)."""
    f = activation(act)
    h = f(torch.einsum("ecd,edf->ecf", xe, w1)) \
        * torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


class ExpertBackend:
    """Runs the expert FFN.  ``me`` is the (E, C) compensation mask and
    ``rank_cap`` the optional rank ceiling; backends with ``fuses_gates``
    weight their output by ``gates`` themselves.  ``rows`` (E,) counts
    each expert's occupied leading slots; backends may skip the rest."""

    name = "base"
    fuses_gates = False

    def __call__(self, xe, params: Dict, me, act: str, rank_cap=None,
                 gates: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError


class DenseBackend(ExpertBackend):
    name = "dense"

    def __call__(self, xe, params, me, act, rank_cap=None, gates=None,
                 rows=None):
        return expert_ffn_dense(xe, params["w1"], params["w3"], params["w2"],
                                act)


class RefQuantBackend(ExpertBackend):
    name = "ref"

    def __call__(self, xe, params, me, act, rank_cap=None, gates=None,
                 rows=None):
        stacks = params["stacks"]
        return compensated_expert_ffn(
            xe, stacks["w1"], stacks.get("w3"), stacks["w2"], me,
            act=activation(act), dtype=xe.dtype, rank_cap=rank_cap)


class KernelQuantBackend(ExpertBackend):
    """One fused kernel launch per (layer, projection); mirrors the JAX
    package's ``PallasQuantBackend``."""

    name = "kernel"
    fuses_gates = True

    def __init__(self, impl: str = "auto"):
        self.impl = impl

    def __call__(self, xe, params, me, act, rank_cap=None, gates=None,
                 rows=None):
        stacks = params["stacks"]
        f = activation(act)
        kw = dict(impl=self.impl, out_dtype=torch.float32,
                  rank_cap=rank_cap, rows=rows)
        h1 = ops.fused_expert_matmul(xe, stacks["w1"], me, **kw)
        if "w3" in stacks:
            h3 = ops.fused_expert_matmul(xe, stacks["w3"], me, **kw)
            h = f(h1) * h3
        else:
            h = f(h1)
        ye = ops.fused_expert_matmul(h.to(xe.dtype), stacks["w2"], me,
                                     gates=gates, **kw)
        return ye.to(xe.dtype)


def select_backend(params: Dict, quantized: bool,
                   impl: Optional[str] = None) -> ExpertBackend:
    """Dense weights (or ``quantized=False``) run the einsum path;
    compressed stacks run the reference composition for ``impl='ref'``
    and the fused kernel wrappers otherwise."""
    if not quantized or "stacks" not in params:
        return DenseBackend()
    resolved = ops.resolve_impl(impl)
    if resolved == "ref":
        return RefQuantBackend()
    return KernelQuantBackend(resolved)

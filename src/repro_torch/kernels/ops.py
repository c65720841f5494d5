"""Kernel entry points at the compressed-stack level, and the dispatch
policy (port of ``repro/kernels/ops.py``).

Dispatch policy (``impl``):
  'auto'  the kernel wrappers: the CUDA kernel for a CUDA tensor, its
          plain version for a CPU tensor
  'cuda'  the CUDA kernel; raises for a CPU tensor
  'ref'   the plain oracles that mirror the JAX package's ``ref.py``
"""
from __future__ import annotations

from typing import Optional

import torch

from . import quant_matmul
from . import ref as ref_ops

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: Optional[str] = None) -> str:
    """Validate an ``impl`` request (None = 'auto')."""
    impl = impl or "auto"
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return impl


def _cap_tensor(rank_cap, device) -> Optional[torch.Tensor]:
    if rank_cap is None:
        return None
    return torch.as_tensor(rank_cap, dtype=torch.int32,
                           device=device).reshape(1)


def fused_expert_matmul(xe: torch.Tensor, stack, me: torch.Tensor, *,
                        gates: Optional[torch.Tensor] = None,
                        rank_cap=None, rows: Optional[torch.Tensor] = None,
                        impl: Optional[str] = None,
                        out_dtype=None) -> torch.Tensor:
    """Fused projection over one expert stack.

    xe: (E, C, K) dispatched tokens; stack: CompressedExpertStack; me:
    (E, C) top-n compensation mask; gates: optional (E, C) router gates
    folded into the output; rank_cap: scalar or (1,) tensor ceiling on the
    compensator rank (None = full padded rank); rows: optional (E,) i32
    count of each expert's occupied leading slots (dispatch fills slots
    from 0), which lets the kernel skip empty tiles and idle experts.

    The CUDA kernel masks a ragged C itself, so C is not padded; the true
    per-expert widths, the true ranks and the rank cap enter the kernel
    as device tensors.
    """
    out_dtype = out_dtype or xe.dtype
    impl = resolve_impl(impl)
    if impl == "ref":
        cap = None if rank_cap is None else torch.as_tensor(
            rank_cap, device=xe.device).reshape(())
        return ref_ops.fused_expert_matmul_ref(
            xe, stack.planes, stack.scale, stack.zero, stack.bits,
            stack.group_size, stack.u, stack.v, stack.u_scale,
            stack.v_scale, me, ge=gates, rank_cap=cap, out_dtype=out_dtype)
    eb, ranks = stack.meta_tensors()
    if eb.shape[0] != xe.shape[0]:
        raise ValueError(f"stack holds {eb.shape[0]} experts, xe "
                         f"{xe.shape[0]}")
    ye = quant_matmul.fused_expert_matmul(
        xe, stack.planes, stack.scale, stack.zero, stack.u, stack.u_scale,
        stack.v, stack.v_scale, me, gates, _cap_tensor(rank_cap, xe.device),
        eb, ranks, rows, bits=stack.bits, group_size=stack.group_size,
        require_kernel=(impl == "cuda"))
    return ye.to(out_dtype)

"""Router-guided error compensation (paper §3.2); port of
``repro/core/restoration.py`` (``topn_mask``, ``compensated_expert_ffn``).

Per token only the top-n (n < k) experts by router score get their
low-rank compensators; the selectivity is a 0/1 mask folded into the
low-rank branch:

    y_e = x @ Q^-1(Q(W_e))  +  ((x * m_e) @ U_e) @ V_e
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .pipeline import CompressedExpertStack


def topn_mask(topk_idx: torch.Tensor, n: int, num_experts: int
              ) -> torch.Tensor:
    """(..., k) descending-score expert ids -> (..., E) 0/1 top-n mask."""
    n = min(n, topk_idx.shape[-1])
    sel = topk_idx[..., :n]
    return F.one_hot(sel, num_experts).float().sum(dim=-2)


def compensated_expert_ffn(x: torch.Tensor, stack_w1: CompressedExpertStack,
                           stack_w3: Optional[CompressedExpertStack],
                           stack_w2: CompressedExpertStack,
                           comp_mask: torch.Tensor,
                           act: Callable = F.silu,
                           dtype=torch.bfloat16,
                           rank_cap: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gated FFN over expert-stacked inputs with masked compensation.

    x: (E, C, d); comp_mask: (E, C); rank_cap: optional scalar ceiling on
    the compensator rank (None = full padded rank).  Returns (E, C, d).
    The reference composition: every expert's weights are dequantized in
    full, in f32.
    """
    x32 = x.float()
    m = comp_mask[..., None].float()

    def proj(stack: CompressedExpertStack, inp: torch.Tensor):
        w = stack.dequantize_all(torch.float32)
        y = torch.einsum("eck,ekn->ecn", inp, w)
        u = stack.u.float() * stack.u_scale
        v = stack.v.float() * stack.v_scale
        xu = torch.einsum("eck,ekr->ecr", inp * m, u)
        if rank_cap is not None:
            xu = xu * (torch.arange(stack.pad_rank, device=xu.device)
                       < rank_cap).float()
        return y + torch.einsum("ecr,ern->ecn", xu, v)

    h1 = proj(stack_w1, x32)
    h = act(h1) * proj(stack_w3, x32) if stack_w3 is not None else act(h1)
    return proj(stack_w2, h).to(dtype)

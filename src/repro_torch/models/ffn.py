"""Dense FFN (gated SwiGLU / plain MLP) and its quantized-compensated form
(port of ``repro/models/ffn.py``): the degenerate static E = 1 case of the
paper's technique, used for dense models (DESIGN.md §5)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.pipeline import CompressedExpertStack
from ..kernels import ops
from .layers import activation


def ffn_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], act: str = "silu",
              gated: bool = True) -> torch.Tensor:
    """x: (..., d); params w1 (d, ff), [w3 (d, ff)], w2 (ff, d)."""
    f = activation(act)
    h = torch.einsum("...d,df->...f", x, p["w1"])
    h = f(h) * torch.einsum("...d,df->...f", x, p["w3"]) if gated else f(h)
    return torch.einsum("...f,fd->...d", h, p["w2"])


def ffn_apply_quantized(x: torch.Tensor,
                        stacks: Dict[str, CompressedExpertStack],
                        act: str = "silu", gated: bool = True,
                        compensate: bool = True,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Static quantize-then-compensate FFN over single-expert stacks
    (E = 1); every projection is one ``ops.lowrank_comp_matmul`` on views
    of the stack's expert 0.  ``compensate=False`` gives the
    uniform-quantization baseline (a zero mask)."""
    shp = x.shape
    xf = x.reshape(-1, shp[-1])
    m = xf.shape[0]
    mask = (torch.ones if compensate else torch.zeros)(
        (m,), dtype=torch.float32, device=x.device)

    def proj(name, inp):
        st = stacks[name]
        return ops.lowrank_comp_matmul(
            inp, ops.stack_member(st, 0), st.u[0], st.v[0], st.u_scale[0],
            st.v_scale[0], mask, impl=impl, out_dtype=x.dtype)

    f = activation(act)
    h = proj("w1", xf)
    h = f(h) * proj("w3", xf) if gated else f(h)
    y = proj("w2", h.to(x.dtype))
    return y.reshape(*shp[:-1], y.shape[-1])

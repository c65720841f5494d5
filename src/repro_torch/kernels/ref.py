"""Plain PyTorch oracles (port of ``repro/kernels/ref.py``:
``dequant_ref``, ``quant_matmul_ref``, ``lowrank_comp_matmul_ref`` and
``fused_expert_matmul_ref``).

These follow the JAX oracle step for step: dequantize every expert in
full, then dense products.  Like the JAX oracle, they do not mask planes
by ``expert_bits``; heterogeneous stacks keep a narrower expert's upper
planes zero, so unpacking at the container width is exact.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.quantize import unpack_bits


def dequant_ref(planes: Tuple[torch.Tensor, ...], scale: torch.Tensor,
                zero: torch.Tensor, bits: int, group_size: int,
                dtype=torch.float32) -> torch.Tensor:
    """(planes, scale, zero) -> dense (K, N) weights."""
    q = unpack_bits(planes, bits).float()
    k, n = q.shape
    g = q.reshape(k // group_size, group_size, n)
    w = (g - zero[:, None, :]) * scale[:, None, :]
    return w.reshape(k, n).to(dtype)


def quant_matmul_ref(x: torch.Tensor, planes: Tuple[torch.Tensor, ...],
                     scale: torch.Tensor, zero: torch.Tensor, bits: int,
                     group_size: int, out_dtype=torch.float32
                     ) -> torch.Tensor:
    """y = x @ dequant(Wq);  x: (M, K) -> (M, N), in f32."""
    w = dequant_ref(planes, scale, zero, bits, group_size)
    return (x.float() @ w).to(out_dtype)


def lowrank_comp_matmul_ref(x: torch.Tensor,
                            planes: Tuple[torch.Tensor, ...],
                            scale: torch.Tensor, zero: torch.Tensor,
                            bits: int, group_size: int,
                            u: torch.Tensor, v: torch.Tensor,
                            u_scale: torch.Tensor, v_scale: torch.Tensor,
                            mask: Optional[torch.Tensor],
                            out_dtype=torch.float32,
                            rank_cap: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """y = x @ dequant(Wq) + mask_r((x*mask) @ (U u_s)) @ (V v_s).

    u: (K, R) codes, u_scale: (1, R); v: (R, N) codes, v_scale: (R, 1);
    mask: (M,) 0/1 per-token compensation gate (None = all tokens);
    rank_cap: scalar ceiling on the compensator rank (None = R)."""
    y = quant_matmul_ref(x, planes, scale, zero, bits, group_size)
    xf = x.float()
    if mask is not None:
        xf = xf * mask[:, None].float()
    xu = xf @ (u.float() * u_scale)
    if rank_cap is not None:
        xu = xu * (torch.arange(u.shape[-1], device=xu.device)
                   < rank_cap).float()
    y = y + xu @ (v.float() * v_scale)
    return y.to(out_dtype)


def fused_expert_matmul_ref(xe: torch.Tensor,
                            planes: Tuple[torch.Tensor, ...],
                            scale: torch.Tensor, zero: torch.Tensor,
                            bits: int, group_size: int,
                            u: torch.Tensor, v: torch.Tensor,
                            u_scale: torch.Tensor, v_scale: torch.Tensor,
                            me: torch.Tensor,
                            ge: Optional[torch.Tensor] = None,
                            rank_cap: Optional[torch.Tensor] = None,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Per-expert compensated matmul with the gate-weighted combine:

        ye[e] = (xe[e] @ dequant(W_e)
                 + mask_r((xe[e] * me[e]) @ (U_e u_scale_e)) @ (V_e v_scale_e))
                * ge[e]

    xe: (E, C, K); planes[i]: (E, K//c_i, N); scale/zero: (E, K//G, N);
    u: (E, K, R); v: (E, R, N); me, ge: (E, C); rank_cap: scalar or None.
    """
    outs = []
    for e in range(xe.shape[0]):
        w = dequant_ref(tuple(p[e] for p in planes), scale[e], zero[e],
                        bits, group_size)
        x = xe[e].float()
        y = x @ w
        xu = (x * me[e][:, None].float()) @ (u[e].float() * u_scale[e])
        if rank_cap is not None:
            xu = xu * (torch.arange(u.shape[-1], device=xu.device)
                       < rank_cap).float()
        outs.append(y + xu @ (v[e].float() * v_scale[e]))
    ye = torch.stack(outs)
    if ge is not None:
        ye = ye * ge[..., None].float()
    return ye.to(out_dtype)

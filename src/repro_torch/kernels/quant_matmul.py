"""Fused expert projection: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/quant_matmul.py::fused_expert_matmul_pallas``.
For every expert e of one (layer, projection):

    ye[e] = (xe[e] @ dequant_e(W)                       # true-width HQQ
             + mask_r((xe[e] * me[e]) @ (U_e u_s)) v_s @ V_e)  # comp
            * ge[e]                                      # gate

The kernel (``csrc/fused_expert.cu``) is a rank-space pre-pass plus one
main kernel; see the source note there for what bounds it on the H100 and
what its design does about that.  ``rank_cap``, ``expert_bits`` and the
true ``ranks`` are device tensors read by the kernel, never compile-time
specialisations.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.quantize import PACK_BLOCK, PLANES, unpack_plane
from .build import LaunchCounter, check, load

launches = LaunchCounter()


def fused_expert_matmul_plain(xe, planes, scale, zero, u, u_scale, v,
                              v_scale, me, ge, rank_cap, expert_bits, ranks,
                              rows=None, *, bits: int, group_size: int
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same arguments: planes
    at or above ``expert_bits[e]`` are masked, ranks at or above
    ``min(rank_cap, ranks[e])`` contribute nothing, slots at or past
    ``rows[e]`` give zeros.  Returns (E, C, N) f32."""
    E, C, K = xe.shape
    R = u.shape[-1]
    r_idx = torch.arange(R, device=xe.device)
    outs = []
    for e in range(E):
        codes = None
        for (p, off), plane in zip(PLANES[bits], planes):
            sub = unpack_plane(plane[e], p).to(torch.int32) << off
            sub = sub * (expert_bits[e] > off).to(torch.int32)
            codes = sub if codes is None else codes | sub
        n = codes.shape[1]
        g = codes.float().reshape(K // group_size, group_size, n)
        w = ((g - zero[e][:, None, :]) * scale[e][:, None, :]).reshape(K, n)
        x = xe[e].float()
        y = x @ w
        keep = r_idx < ranks[e]
        if rank_cap is not None:
            keep = keep & (r_idx < rank_cap.reshape(()))
        xu = (x * me[e][:, None].float()) @ (u[e].float() * u_scale[e])
        xu = xu * keep.float() * v_scale[e][:, 0]
        y = y + xu @ v[e].float()
        if ge is not None:
            y = y * ge[e][:, None].float()
        if rows is not None:
            y = y * (torch.arange(C, device=y.device) < rows[e])[:, None]
        outs.append(y)
    return torch.stack(outs)


def _lib():
    lib = load("fused_expert.cu")
    fn = lib.fused_expert_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 18 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def xu_splits(E: int, C: int, K: int, R: int) -> int:
    """K splits of the rank-space pre-pass: enough blocks (about 1024) to
    spread even one compensated expert over the card, at least one 64-row
    pack block per split."""
    tiles = E * -(-C // 8) * -(-R // 128)
    return max(1, min(K // PACK_BLOCK, -(-1024 // tiles)))


def _ptr(t: Optional[torch.Tensor], dtype: torch.dtype, name: str,
         device: torch.device, align: int = 4) -> Optional[int]:
    if t is None:
        return None
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
    return t.data_ptr()


def fused_expert_matmul(xe: torch.Tensor, planes: Tuple[torch.Tensor, ...],
                        scale: torch.Tensor, zero: torch.Tensor,
                        u: torch.Tensor, u_scale: torch.Tensor,
                        v: torch.Tensor, v_scale: torch.Tensor,
                        me: torch.Tensor, ge: Optional[torch.Tensor],
                        rank_cap: Optional[torch.Tensor],
                        expert_bits: torch.Tensor, ranks: torch.Tensor,
                        rows: Optional[torch.Tensor] = None,
                        *, bits: int, group_size: int,
                        require_kernel: bool = False) -> torch.Tensor:
    """(E, C, N) f32 fused expert projection.

    xe: (E, C, K); planes[i]: (E, K//c_i, N) u8; scale/zero: (E, K//G, N)
    f32; u: (E, K, R) i8; u_scale: (E, 1, R); v: (E, R, N) i8; v_scale:
    (E, R, 1); me, ge: (E, C) (ge may be None); rank_cap: (1,) i32 or None
    (= R); expert_bits, ranks: (E,) i32; rows: optional (E,) i32 count of
    each expert's occupied leading slots (the slots past it hold zeros
    and get zero output).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version, unless ``require_kernel`` asks for the kernel."""
    if not xe.is_cuda:
        if require_kernel:
            raise ValueError("the CUDA fused expert kernel needs CUDA "
                             f"tensors; xe is on {xe.device}")
        return fused_expert_matmul_plain(
            xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge,
            rank_cap, expert_bits, ranks, rows, bits=bits,
            group_size=group_size)
    E, C, K = xe.shape
    N = scale.shape[-1]
    R = u.shape[-1]
    if K % PACK_BLOCK or group_size % PACK_BLOCK or K % group_size:
        raise ValueError(f"fused expert kernel needs K ({K}) and group_size "
                         f"({group_size}) multiples of {PACK_BLOCK}")
    if N % 4:
        raise ValueError(f"fused expert kernel needs N % 4 == 0, got {N}")
    if len(planes) != len(PLANES[bits]):
        raise ValueError(f"{len(planes)} planes for bits={bits}")
    if u.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("fused expert kernel takes int8 compensator "
                         f"factors, got {u.dtype}/{v.dtype}")
    dev = xe.device
    x = xe.float().contiguous()
    mef = me.float().contiguous()
    gef = None if ge is None else ge.float().contiguous()
    out = torch.empty((E, C, N), dtype=torch.float32, device=dev)
    ks = xu_splits(E, C, K, R)
    partial = torch.empty((E, C, ks, R), dtype=torch.float32, device=dev)
    xu = torch.empty((E, C, R), dtype=torch.float32, device=dev)
    p0 = _ptr(planes[0], torch.uint8, "planes[0]", dev)
    p1 = _ptr(planes[1], torch.uint8, "planes[1]", dev) \
        if len(planes) > 1 else None
    fn = _lib()
    rc = fn(_ptr(x, torch.float32, "xe", dev), p0, p1,
            _ptr(scale, torch.float32, "scale", dev, 16),
            _ptr(zero, torch.float32, "zero", dev, 16),
            _ptr(u, torch.int8, "u", dev, 1),
            _ptr(u_scale, torch.float32, "u_scale", dev),
            _ptr(v, torch.int8, "v", dev, 1),
            _ptr(v_scale, torch.float32, "v_scale", dev),
            _ptr(mef, torch.float32, "me", dev),
            _ptr(gef, torch.float32, "ge", dev),
            _ptr(rank_cap, torch.int32, "rank_cap", dev),
            _ptr(ranks, torch.int32, "ranks", dev),
            _ptr(expert_bits, torch.int32, "expert_bits", dev),
            _ptr(rows, torch.int32, "rows", dev),
            _ptr(partial, torch.float32, "partial", dev),
            _ptr(xu, torch.float32, "xu", dev),
            _ptr(out, torch.float32, "out", dev),
            E, C, K, N, R, ks, bits, group_size,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "fused_expert_forward")
    launches.n += 1
    return out

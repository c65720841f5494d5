"""Quantized matmuls: CUDA kernel wrappers and their plain versions.

``fused_expert_matmul`` ports
``repro/kernels/quant_matmul.py::fused_expert_matmul_pallas``.  For every
expert e of one (layer, projection):

    ye[e] = (xe[e] @ dequant_e(W)                       # true-width HQQ
             + mask_r((xe[e] * me[e]) @ (U_e u_s)) v_s @ V_e)  # comp
            * ge[e]                                      # gate

The kernel (``csrc/fused_expert.cu``) is a rank-space pre-pass plus one
main kernel; see the source note there for what bounds it on the H100 and
what its design does about that.  ``rank_cap``, ``expert_bits`` and the
true ``ranks`` are device tensors read by the kernel, never compile-time
specialisations.

``quant_matmul`` ports ``quant_matmul_pallas`` and
``lowrank_comp_matmul_pallas`` (one packed (K, N) matrix, the dense-FFN
path):

    y = x @ dequant(W) [+ mask_r((x * mask) @ (U u_s)) v_s @ V]

Its kernel (``csrc/quant_matmul.cu``) has two paths, chosen by the token
count M: below ``MMA_MIN_M`` (decode) it splits K over CUDA-core blocks;
from ``MMA_MIN_M`` (prefill) one block per 64 x 128 output tile runs
bf16 ``mma.sync`` on the exact codes with x split into bf16 parts (hi and
lo; a third for 8-bit codes).
A second launch adds the compensation epilogue (and, on the split-K path,
sums the splits).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.quantize import PACK_BLOCK, PLANES, unpack_plane
from .build import LaunchCounter, check, load

launches = LaunchCounter()          # fused_expert_matmul
qmm_launches = LaunchCounter()      # quant_matmul

_TARGET_BLOCKS = 264                # two blocks per SM of an H100


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


def _fused_lib():
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
    fn = _fused_lib()
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


# ---------------------------------------------------------------------------
# one packed matrix: quant_matmul / lowrank_comp_matmul
# ---------------------------------------------------------------------------

def quant_matmul_plain(x, planes, scale, zero, u=None, u_scale=None, v=None,
                       v_scale=None, mask=None, rank_cap=None, *, bits: int,
                       group_size: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same arguments: unpack,
    dequantize, ``x @ W``, then, when ``u`` is given, the epilogue
    ``+ mask_r((x * mask) @ (U u_s)) v_s @ V`` (ranks at or above
    ``rank_cap`` contribute nothing).  Returns (M, N) f32."""
    K = x.shape[1]
    codes = None
    for (p, off), plane in zip(PLANES[bits], planes):
        sub = unpack_plane(plane, p).to(torch.int32) << off
        codes = sub if codes is None else codes | sub
    n = codes.shape[1]
    g = codes.float().reshape(K // group_size, group_size, n)
    w = ((g - zero[:, None, :]) * scale[:, None, :]).reshape(K, n)
    xf = x.float()
    y = xf @ w
    if u is None:
        return y
    if mask is not None:
        xf = xf * mask[:, None].float()
    xu = xf @ (u.float() * u_scale)
    if rank_cap is not None:
        keep = torch.arange(u.shape[-1], device=x.device) \
            < rank_cap.reshape(())
        xu = xu * keep.float()
    return y + (xu * v_scale[:, 0]) @ v.float()


# C entry points of csrc/quant_matmul.cu: quant_matmul_forward picks the
# path by M; the other two run one path at any M
_QMM_ENTRIES = {None: "quant_matmul_forward", "splitk": "quant_matmul_splitk",
                "mma": "quant_matmul_mma"}


def _qmm_lib(path: Optional[str] = None):
    fn = getattr(load("quant_matmul.cu"), _QMM_ENTRIES[path])
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 14 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def token_tile(m: int) -> int:
    """Tokens per block of the kernels (``quant_tile.cuh::token_tile``)."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


# Tokens from which quant_matmul runs its tensor-core path
# (``csrc/quant_matmul.cu::kMmaMinM``); below it, the split-K path.
MMA_MIN_M = 128


def qmm_path(M: int) -> str:
    """The kernel path ``quant_matmul_forward`` takes for M tokens:
    'mma' (tensor cores) from ``MMA_MIN_M``, else 'splitk'."""
    return "mma" if M >= MMA_MIN_M else "splitk"


def qmm_splits(M: int, K: int, N: int,
               path: Optional[str] = None) -> Tuple[int, int]:
    """(K splits, pack blocks per split) of the quant_matmul kernel on
    ``path`` (None: ``qmm_path(M)``).  The mma path never splits: (1,
    K/64).  The split-K path takes enough splits for about two blocks per
    SM, each split at least one 64-row pack block per warp (8), no split
    empty."""
    n_pb = K // PACK_BLOCK
    if (path or qmm_path(M)) == "mma":
        return 1, n_pb
    tiles = -(-M // token_tile(M)) * -(-N // 128)
    ks = max(1, min(-(-_TARGET_BLOCKS // tiles), n_pb // 8))
    kch = -(-n_pb // ks)
    return -(-n_pb // kch), kch


def quant_matmul(x: torch.Tensor, planes: Tuple[torch.Tensor, ...],
                 scale: torch.Tensor, zero: torch.Tensor,
                 u: Optional[torch.Tensor] = None,
                 u_scale: Optional[torch.Tensor] = None,
                 v: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None,
                 rank_cap: Optional[torch.Tensor] = None, *, bits: int,
                 group_size: int, require_kernel: bool = False
                 ) -> torch.Tensor:
    """(M, N) f32 ``x @ dequant(W)``, plus the compensation when ``u`` is
    given.

    x: (M, K); planes[i]: (K//c_i, N) u8; scale/zero: (K//G, N) f32;
    u: (K, R) i8; u_scale: (1, R); v: (R, N) i8; v_scale: (R, 1); mask:
    (M,) or None (= every token compensated); rank_cap: (1,) i32 or None
    (= R).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version, unless ``require_kernel`` asks for the kernel."""
    if not x.is_cuda:
        if require_kernel:
            raise ValueError("the CUDA quant_matmul kernel needs CUDA "
                             f"tensors; x is on {x.device}")
        return quant_matmul_plain(x, planes, scale, zero, u, u_scale, v,
                                  v_scale, mask, rank_cap, bits=bits,
                                  group_size=group_size)
    return _launch_qmm(None, x, planes, scale, zero, u, u_scale, v, v_scale,
                       mask, rank_cap, bits=bits, group_size=group_size)


def _launch_qmm(path: Optional[str], x, planes, scale, zero, u, u_scale, v,
                v_scale, mask, rank_cap, *, bits: int,
                group_size: int) -> torch.Tensor:
    """Launch the quant_matmul kernel on CUDA tensors.  ``path`` None lets
    ``quant_matmul_forward`` choose by M, as ``quant_matmul`` does;
    'splitk' or 'mma' runs that path at any M (for timing the two against
    each other)."""
    M, K = x.shape
    N = scale.shape[-1]
    if K % PACK_BLOCK or group_size % PACK_BLOCK or K % group_size:
        raise ValueError(f"quant_matmul kernel needs K ({K}) and group_size "
                         f"({group_size}) multiples of {PACK_BLOCK}")
    if N % 4:
        raise ValueError(f"quant_matmul kernel needs N % 4 == 0, got {N}")
    if len(planes) != len(PLANES[bits]):
        raise ValueError(f"{len(planes)} planes for bits={bits}")
    dev = x.device
    comp = u is not None
    R = u.shape[-1] if comp else 0
    if comp and (u.dtype != torch.int8 or v.dtype != torch.int8):
        raise ValueError("quant_matmul kernel takes int8 compensator "
                         f"factors, got {u.dtype}/{v.dtype}")
    if R > 1024:
        raise ValueError(f"quant_matmul kernel takes rank <= 1024, got {R}")
    mma = (path or qmm_path(M)) == "mma"
    xf = x.float().contiguous()
    if mma and xf.data_ptr() % 16:      # the mma path copies x by 16 bytes
        xf = xf.clone()
    mf = None if mask is None or not comp else mask.float().contiguous()
    ks, kch = qmm_splits(M, K, N, "mma" if mma else "splitk")
    # the mma path without compensation writes out directly
    partial = (None if mma and not comp else
               torch.empty((ks, M, N), dtype=torch.float32, device=dev))
    xu_part = (torch.empty((ks, M, R), dtype=torch.float32, device=dev)
               if comp else None)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    p1 = _ptr(planes[1], torch.uint8, "planes[1]", dev) \
        if len(planes) > 1 else None
    if comp:
        factors = (_ptr(u, torch.int8, "u", dev, 1),
                   _ptr(u_scale, torch.float32, "u_scale", dev),
                   _ptr(v, torch.int8, "v", dev),
                   _ptr(v_scale, torch.float32, "v_scale", dev),
                   _ptr(mf, torch.float32, "mask", dev),
                   _ptr(rank_cap, torch.int32, "rank_cap", dev))
    else:
        factors = (None,) * 6
    rc = _qmm_lib(path)(
        _ptr(xf, torch.float32, "x", dev),
        _ptr(planes[0], torch.uint8, "planes[0]", dev), p1,
        _ptr(scale, torch.float32, "scale", dev, 16),
        _ptr(zero, torch.float32, "zero", dev, 16), *factors,
        _ptr(partial, torch.float32, "partial", dev, 16),
        _ptr(xu_part, torch.float32, "xu_part", dev),
        _ptr(out, torch.float32, "out", dev, 16),
        M, K, N, R, ks, kch, bits, group_size,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, _QMM_ENTRIES[path])
    qmm_launches.n += 1
    return out

"""Quantized matmuls: CUDA kernel wrappers and their plain versions.

``fused_expert_matmul`` ports
``repro/kernels/quant_matmul.py::fused_expert_matmul_pallas``.  For every
expert e of one (layer, projection):

    ye[e] = (xe[e] @ dequant_e(W)                       # true-width HQQ
             + mask_r((xe[e] * me[e]) @ (U_e u_s)) v_s @ V_e)  # comp
            * ge[e]                                      # gate

The kernel (``csrc/fused_expert.cu``) is two launches.  The rank-space
pre-pass computes ``xu`` once per (expert, compensated token, live rank):
below ``FUSED_MMA_MIN_C`` a fixed grid of ``XU_SLOTS`` clusters of
``XU_CLUSTER`` blocks takes the live (expert, token tile,
``XU_TILE_R``-rank tile) items in turn, from it one block per item; K is
split in an order fixed by K, so a token's ``xu`` does not depend on the
other tokens of the call (``xu_geometry`` mirrors the grid).  The main kernel
has two paths, chosen by the capacity C: below ``FUSED_MMA_MIN_C``
(decode) CUDA-core blocks whose warps split both the K walk (by pack
blocks) and the rank walk of the ``xu @ V`` epilogue, the walk
multiplying only as many token slots as the tile holds tokens
(``walk_slots``: at decode most live experts hold one token); from
``FUSED_MMA_MIN_C`` (prefill) each expert's 64 x 128 output tiles run
quant_matmul's tensor-core tile.  See the source note there for what
bounds it on the H100 and what its design does about that.  ``rank_cap``,
``expert_bits`` and the true ``ranks`` are device tensors read by the
kernel, never compile-time specialisations, so a captured call reads
their current values.

``quant_matmul`` ports ``quant_matmul_pallas`` and
``lowrank_comp_matmul_pallas`` (one packed (K, N) matrix, the dense-FFN
path):

    y = x @ dequant(W) [+ mask_r((x * mask) @ (U u_s)) v_s @ V]

Its kernel (``csrc/quant_matmul.cu``) has two paths, chosen by the token
count M: below ``MMA_MIN_M`` (decode) one launch whose CUDA-core blocks
split K over a thread-block cluster and sum the splits, the rank-space
work and the epilogue inside it (``qmm_splits`` mirrors the geometry);
from ``MMA_MIN_M`` (prefill) one block per 64 x 128 output tile runs
bf16 ``mma.sync`` on the exact codes with x split into bf16 parts (hi and
lo; a third for 8-bit codes), and a second launch adds the compensation
epilogue.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.quantize import PACK_BLOCK, PLANES, unpack_plane
from .build import LaunchCounter, check, load

launches = LaunchCounter()          # fused_expert_matmul
fused_mma_launches = LaunchCounter()  # ... of them on the tensor-core path
qmm_launches = LaunchCounter()      # quant_matmul


def fused_expert_matmul_plain(xe, planes, scale, zero, u, u_scale, v,
                              v_scale, me, ge, rank_cap, expert_bits, ranks,
                              rows=None, *, bits: int, group_size: int
                              ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the same arguments: planes
    at or above ``expert_bits[e]`` are masked, ranks at or above
    ``min(rank_cap, ranks[e])`` contribute nothing, slots at or past
    ``rows[e]`` give zeros.  Returns (E, C, N) f32, or f64 for an f64
    ``xe`` (the kernels' yardstick where f32's own rounding is not
    enough: 8-bit codes over K 14336)."""
    ct = torch.promote_types(xe.dtype, torch.float32)
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
        g = codes.to(ct).reshape(K // group_size, group_size, n)
        w = ((g - zero[e][:, None, :]) * scale[e][:, None, :]).reshape(K, n)
        x = xe[e].to(ct)
        y = x @ w
        keep = r_idx < ranks[e]
        if rank_cap is not None:
            keep = keep & (r_idx < rank_cap.reshape(()))
        xu = (x * me[e][:, None].to(ct)) @ (u[e].to(ct) * u_scale[e])
        xu = xu * keep.to(ct) * v_scale[e][:, 0]
        y = y + xu @ v[e].to(ct)
        if ge is not None:
            y = y * ge[e][:, None].to(ct)
        if rows is not None:
            y = y * (torch.arange(C, device=y.device) < rows[e])[:, None]
        outs.append(y)
    return torch.stack(outs)


# C entry points of csrc/fused_expert.cu, all on the same arguments:
# fused_expert_forward runs the pre-pass and then picks the main kernel by
# C; the other three launch one part of a call
_FUSED_ENTRIES = ("forward", "prepass", "simt", "mma")


def _fused_lib(entry: str):
    fn = getattr(load("fused_expert.cu"), f"fused_expert_{entry}")
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 17 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


# Capacity C from which fused_expert_matmul runs its tensor-core path
# (``csrc/fused_expert.cu::kFusedMmaMinC``); below it, the CUDA cores.
FUSED_MMA_MIN_C = 96


def fused_path(C: int) -> str:
    """The main-kernel path ``fused_expert_forward`` takes for capacity C:
    'mma' (tensor cores) from ``FUSED_MMA_MIN_C``, else 'simt' (the CUDA
    cores)."""
    return "mma" if C >= FUSED_MMA_MIN_C else "simt"


def walk_slots(C: int, occupied: int) -> int:
    """Token slots the decode main kernel's K walk multiplies for a token
    tile holding ``occupied`` (>= 1) tokens at capacity C
    (``csrc/fused_expert.cu::walk_slots``): the smallest of 1, 2, 4, 8 that
    holds them in an 8-slot tile (``token_tile(C)``), 1 or the whole tile
    in a smaller one.  Each weight costs that many multiply-adds per lane,
    and a token's sum is the same whatever the count, so its row does not
    depend on C or on the tokens sharing its expert."""
    tile = token_tile(C)
    if occupied <= 1:
        return 1
    return min(token_tile(occupied), tile) if tile == 8 else tile


# The rank-space pre-pass (``csrc/fused_expert.cu``: ``kXuTileR``,
# ``kXuCluster``, ``kXuSlots``, ``kXuWarps``): ranks per work item (4 per
# lane); below FUSED_MMA_MIN_C, blocks per cluster and clusters in the
# grid; warps per block
XU_TILE_R = 128
XU_CLUSTER = 8
XU_SLOTS = 32
XU_WARPS = 8


def xu_geometry(E: int, C: int, K: int, R: int) -> dict:
    """The pre-pass launch for capacity C: its grid, the cluster size, the
    tokens per work item and the K rows each warp sums (the split, fixed
    by K and the cluster size).  Below ``FUSED_MMA_MIN_C`` the grid is
    ``XU_SLOTS`` clusters whatever E, C and R are, the clusters taking the
    live items (expert, token tile, rank tile) in turn; from it, one block
    per item, dead ones included."""
    ct = token_tile(C)
    if C < FUSED_MMA_MIN_C:
        cs, grid = XU_CLUSTER, (XU_CLUSTER, XU_SLOTS, 1)
    else:
        cs, grid = 1, (-(-R // XU_TILE_R), -(-C // ct), E)
    return {"grid": grid, "cluster": cs, "tokens": ct,
            "k_rows_per_warp": -(-K // (cs * XU_WARPS))}


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
    _check_experts(xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge,
                   expert_bits, ranks, rows)
    if not xe.is_cuda:
        if require_kernel:
            raise ValueError("the CUDA fused expert kernel needs CUDA "
                             f"tensors; xe is on {xe.device}")
        return fused_expert_matmul_plain(
            xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge,
            rank_cap, expert_bits, ranks, rows, bits=bits,
            group_size=group_size)
    return _launch_fused(None, xe, planes, scale, zero, u, u_scale, v,
                         v_scale, me, ge, rank_cap, expert_bits, ranks, rows,
                         bits=bits, group_size=group_size)


def _check_experts(xe, planes, scale, zero, u, u_scale, v, v_scale, me, ge,
                   expert_bits, ranks, rows) -> None:
    """Every per-expert operand holds the E experts of ``xe``: the kernel
    reads each one's row ``e`` for e < E unchecked, so a stack with fewer
    experts (another rank's slice) would be read past its end."""
    E = xe.shape[0]
    named = dict(scale=scale, zero=zero, u=u, u_scale=u_scale, v=v,
                 v_scale=v_scale, me=me, ge=ge, expert_bits=expert_bits,
                 ranks=ranks, rows=rows)
    named.update({f"planes[{i}]": p for i, p in enumerate(planes)})
    bad = {k: t.shape[0] for k, t in named.items()
           if t is not None and t.shape[0] != E}
    if bad:
        raise ValueError(f"xe holds {E} experts; these operands do not: "
                         f"{bad}")


def _launch_fused(path: Optional[str], xe, planes, scale, zero, u, u_scale,
                  v, v_scale, me, ge, rank_cap, expert_bits, ranks,
                  rows=None, *, bits: int, group_size: int) -> torch.Tensor:
    """Launch the fused expert kernel on CUDA tensors.  ``path`` None lets
    ``fused_expert_forward`` choose by C, as ``fused_expert_matmul`` does;
    'simt' or 'mma' runs the pre-pass and that main kernel at any C."""
    entries = ("forward",) if path is None else ("prepass", path)
    out = _fused_parts(entries, xe, planes, scale, zero, u, u_scale, v,
                       v_scale, me, ge, rank_cap, expert_bits, ranks, rows,
                       bits=bits, group_size=group_size)
    launches.n += 1
    if (path or fused_path(xe.shape[1])) == "mma":
        fused_mma_launches.n += 1
    return out


def _fused_parts(entries: Tuple[str, ...], xe, planes, scale, zero, u,
                 u_scale, v, v_scale, me, ge, rank_cap, expert_bits, ranks,
                 rows=None, *, bits: int, group_size: int) -> torch.Tensor:
    """Launch the named entry points of ``csrc/fused_expert.cu`` (of
    ``_FUSED_ENTRIES``), in order, on one call's operands and scratch, and
    return the output.  Uncounted: ``_launch_fused`` counts whole calls; a
    part alone ('prepass', or a main kernel reading the scratch as
    allocated, right only where no token is compensated) serves timing."""
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
    if any(e not in _FUSED_ENTRIES for e in entries):
        raise ValueError(f"entries {entries}: each one of {_FUSED_ENTRIES}")
    mma = "mma" in entries or ("forward" in entries
                               and fused_path(C) == "mma")
    dev = xe.device
    x = xe.float().contiguous()
    if mma and x.data_ptr() % 16:       # the mma path copies x by 16 bytes
        x = x.clone()
    mef = me.float().contiguous()
    gef = None if ge is None else ge.float().contiguous()
    out = torch.empty((E, C, N), dtype=torch.float32, device=dev)
    xu = torch.empty((E, C, R), dtype=torch.float32, device=dev)
    p0 = _ptr(planes[0], torch.uint8, "planes[0]", dev)
    p1 = _ptr(planes[1], torch.uint8, "planes[1]", dev) \
        if len(planes) > 1 else None
    args = (_ptr(x, torch.float32, "xe", dev), p0, p1,
            _ptr(scale, torch.float32, "scale", dev, 16),
            _ptr(zero, torch.float32, "zero", dev, 16),
            _ptr(u, torch.int8, "u", dev, 1),
            _ptr(u_scale, torch.float32, "u_scale", dev),
            _ptr(v, torch.int8, "v", dev, 4),
            _ptr(v_scale, torch.float32, "v_scale", dev),
            _ptr(mef, torch.float32, "me", dev),
            _ptr(gef, torch.float32, "ge", dev),
            _ptr(rank_cap, torch.int32, "rank_cap", dev),
            _ptr(ranks, torch.int32, "ranks", dev),
            _ptr(expert_bits, torch.int32, "expert_bits", dev),
            _ptr(rows, torch.int32, "rows", dev),
            _ptr(xu, torch.float32, "xu", dev),
            _ptr(out, torch.float32, "out", dev, 16),
            E, C, K, N, R, bits, group_size,
            torch.cuda.current_stream(dev).cuda_stream)
    for entry in entries:
        check(_fused_lib(entry)(*args), f"fused_expert_{entry}")
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
# (``csrc/quant_matmul.cu::kMmaMinM``); below it, the decode kernel.
MMA_MIN_M = 128


def qmm_path(M: int) -> str:
    """The kernel path ``quant_matmul_forward`` takes for M tokens:
    'mma' (tensor cores) from ``MMA_MIN_M``, else 'splitk' (the decode
    kernel, K split over a cluster)."""
    return "mma" if M >= MMA_MIN_M else "splitk"


# The decode kernel: blocks per cluster at most (``kMaxCluster``), warps
# per block, output columns per block
QMM_MAX_CLUSTER = 8
QMM_WARPS = 8
QMM_BN = 128
# The H100's SMs, and the decode kernel's clusters it holds at once by
# cluster size (cudaOccupancyMaxActiveClusters for 2 bits, token tile 4,
# rank 32, one block per SM; ``tools/qmm_decode_timing.py`` prints them):
# the defaults of ``qmm_splits``, which the wrapper replaces by the card's
# own counts
H100_SMS = 132
H100_DECODE_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15,
                        8: 15}


def qmm_splits(M: int, K: int, N: int, path: Optional[str] = None,
               clusters: Optional[Callable[[int], int]] = None,
               sms: int = H100_SMS) -> Tuple[int, int]:
    """(K splits, pack blocks per split) of the quant_matmul kernel on
    ``path`` (None: ``qmm_path(M)``).  The mma path never splits: (1,
    K/64).  The decode path splits K over a cluster of CS <= 8 blocks,
    each walking ``kch`` pack blocks (none empty, K covered exactly), on
    a grid of ``ceil(M/ct) * ceil(N/128)`` clusters.  Of the cluster sizes
    whose grid the card holds at once (``clusters(cs)``: clusters resident
    at once; default the H100's), it takes the one with the least time
    per SM: the grid's waves of ``sms`` blocks (one block per SM) times
    the pack blocks per warp (``kch / 8``) plus 1 for the first load,
    which nothing overlaps; a tie goes to the smaller cluster."""
    n_pb = K // PACK_BLOCK
    if (path or qmm_path(M)) == "mma":
        return 1, n_pb
    resident = clusters or H100_DECODE_CLUSTERS.__getitem__
    base = -(-M // token_tile(M)) * -(-N // QMM_BN)
    best = None
    for cs in range(1, min(QMM_MAX_CLUSTER, n_pb) + 1):
        kch = -(-n_pb // cs)
        if -(-n_pb // kch) != cs or (cs > 1 and base > resident(cs)):
            continue                # a split empty, or more than one wave
        cost = -(-base * cs // sms) * (kch / QMM_WARPS + 1)
        if best is None or cost < best[0]:
            best = (cost, cs, kch)
    return best[1], best[2]


_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def decode_occupancy(dev: torch.device, bits: int, M: int, R: int,
                     cs: int) -> Tuple[int, int]:
    """(clusters of ``cs`` blocks the card holds at once, blocks per SM) of
    the decode kernel's instantiation for ``bits`` and M tokens at rank R
    (0: no compensation), asked once per device and key."""
    key = (dev.index or 0, bits, token_tile(M), R, cs)
    if key not in _OCCUPANCY:
        fn = load("quant_matmul.cu").quant_matmul_decode_occupancy
        if fn.argtypes is None:
            i = ctypes.c_int
            fn.argtypes = [i] * 4 + [ctypes.c_void_p] * 2
            fn.restype = i
        n, b = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            check(fn(bits, M, R, cs, ctypes.byref(n), ctypes.byref(b)),
                  "quant_matmul_decode_occupancy")
        _OCCUPANCY[key] = (n.value, b.value)
    return _OCCUPANCY[key]


def decode_splits(dev: torch.device, M: int, K: int, N: int, R: int,
                  bits: int) -> Tuple[int, int]:
    """``qmm_splits`` of the decode path on the card ``dev``: its SM count
    and the kernel's clusters resident at once for these arguments."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return qmm_splits(M, K, N, "splitk", sms=sms, clusters=lambda cs:
                      decode_occupancy(dev, bits, M, R, cs)[0])


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
    ks, kch = (qmm_splits(M, K, N, "mma") if mma else
               decode_splits(dev, M, K, N, R, bits))
    # scratch of the compensated mma path (its second launch adds xu @ V);
    # the decode kernel and the uncompensated mma path write out directly
    partial = (torch.empty((M, N), dtype=torch.float32, device=dev)
               if mma and comp else None)
    xu_part = (torch.empty((M, R), dtype=torch.float32, device=dev)
               if mma and comp else None)
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

"""Flash-decode attention: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py::flash_decode_attention``:
GQA attention of one query token per row against a (B, S, KVH, hd)
cache, masked by ``pos >= 0 & pos <= cur`` (``& pos > cur - window``),
with an int8 cache's per-(slot, head) scales folded into the scores and
the probabilities.  The kernel (``csrc/flash_decode.cu``) is one launch:
the slots of each (row, kv-head) are split over a thread-block cluster
whose blocks merge in distributed shared memory; see the source note
there.  ``launch_geometry`` and ``block_slots`` mirror how the kernel
deals out the slots.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .build import LaunchCounter, check, load

launches = LaunchCounter()

NEG = -2.0 ** 30
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# mirrors of csrc/flash_decode.cu (tests/test_torch_kernels.py reads them
# from the source)
WARPS = 4                     # kWarps: warps per block
STAGE_BYTES = 16384           # kStageBytes: K + V bytes of a block's stage
CLUSTERS = (8, 4, 2, 1)       # blocks per (row, kv-head), largest first


def flash_decode_attention_plain(q, k, v, kv_pos, cur_pos, k_scale=None,
                                 v_scale=None, window: Optional[int] = None
                                 ) -> torch.Tensor:
    """q: (B, H, hd) pre-scaled by 1/sqrt(hd); k/v: (B, S, KVH, hd);
    kv_pos: (B, S); cur_pos: (B,); scales: (B, S, KVH) for int8 KV.
    Returns (B, H, hd) f32."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, kvh, g, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float())
    if k_scale is not None:
        s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    cur = cur_pos[:, None]
    valid = (kv_pos >= 0) & (kv_pos <= cur)
    if window is not None and window > 0:
        valid = valid & (kv_pos > cur - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return out.reshape(b, h, hd)


def _lib() -> ctypes.CDLL:
    lib = load("flash_decode.cu")
    if lib.flash_decode_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_forward.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.flash_decode_forward.restype = i
        lib.flash_decode_max_clusters.argtypes = [i] * 4 + [
            ctypes.POINTER(i)]
        lib.flash_decode_max_clusters.restype = i
    return lib


def slots_per_warp(hd: int, elem_bytes: int) -> int:
    """Slots of one warp tile (the kernel's ``Geo::SPW``): a block-wide
    stage of K and V rows is STAGE_BYTES."""
    return max(1, min(32, STAGE_BYTES // (WARPS * 2 * hd * elem_bytes)))


def launch_geometry(rows: int, s: int, spw: int,
                    capacity: Callable[[int], int]) -> int:
    """Blocks per (row, kv-head) (the cluster size CL) for ``rows`` =
    B * KVH rows of S slots: the largest CL that leaves no block without a
    tile (CL <= block tiles of WARPS * spw slots) and keeps the grid one
    resident wave (rows <= ``capacity(CL)``, the clusters of CL blocks the
    card holds at once); 1 where even that does not fit."""
    tiles = -(-s // (WARPS * spw))
    for cl in CLUSTERS:
        if cl <= tiles and rows <= capacity(cl):
            return cl
    return 1


def block_slots(s: int, spw: int, cl: int) -> List[List[int]]:
    """The slots each block of a cluster reads, as the kernel deals them:
    warp tiles of ``spw`` slots, tile u to the cluster's warp u mod
    (cl * WARPS), warp w of block r being the cluster's warp r * WARPS + w."""
    nw, nwt = cl * WARPS, -(-s // spw)
    return [[slot for w in range(WARPS)
             for u in range(r * WARPS + w, nwt, nw)
             for slot in range(u * spw, min(s, (u + 1) * spw))]
            for r in range(cl)]


_CAPACITY: Dict[Tuple[int, int, int, int, int], int] = {}


def cluster_capacity(dev: torch.device, kind: int, hd: int,
                     g: int) -> Callable[[int], int]:
    """Clusters of CL blocks of the kernel's instantiation for (kind, hd,
    g) that the card holds at once (``cudaOccupancyMaxActiveClusters``,
    which knows the SM count, the kernel's occupancy and how clusters
    pack), asked once per device and instantiation."""
    def cap(cl: int) -> int:
        key = (dev.index or 0, kind, hd, g, cl)
        if key not in _CAPACITY:
            n = ctypes.c_int(0)
            with torch.cuda.device(dev):
                rc = _lib().flash_decode_max_clusters(kind, hd, g, cl,
                                                      ctypes.byref(n))
            check(rc, "flash_decode_max_clusters")
            _CAPACITY[key] = n.value
        return _CAPACITY[key]
    return cap


def flash_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_pos: torch.Tensor,
                           cur_pos: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, *,
                           window: Optional[int] = None,
                           require_kernel: bool = False) -> torch.Tensor:
    """(B, H, hd) f32 decode attention; arguments as in the plain version.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version, unless ``require_kernel`` asks for the kernel.  A row
    with no valid slot gives the mean of V over its slots from both, as
    JAX's ``decode_attention`` does."""
    if not q.is_cuda:
        if require_kernel:
            raise ValueError("the CUDA flash-decode kernel needs CUDA "
                             f"tensors; q is on {q.device}")
        return flash_decode_attention_plain(q, k, v, kv_pos, cur_pos,
                                            k_scale, v_scale, window)
    b, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    if k.dtype not in _KV_KIND or v.dtype != k.dtype:
        raise ValueError(f"unsupported KV dtypes {k.dtype}/{v.dtype}")
    scaled = k.dtype == torch.int8
    if scaled != (k_scale is not None and v_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only "
                         "an int8 cache takes them")
    if hd not in (32, 64, 128, 256) or h % kvh or h // kvh > 8:
        raise ValueError(f"flash-decode kernel: hd={hd}, H={h}, KVH={kvh} "
                         "unsupported (hd in 32..256, H/KVH <= 8)")
    dev = q.device
    tensors = {"q": q.float().contiguous(), "k": k, "v": v,
               "kv_pos": kv_pos.to(torch.int32).contiguous(),
               "cur_pos": cur_pos.to(torch.int32).contiguous()}
    if scaled:
        tensors["k_scale"] = k_scale
        tensors["v_scale"] = v_scale
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor on {dev}")
    if k.data_ptr() % 16 or v.data_ptr() % 16 or (
            scaled and (k_scale.data_ptr() % 4 or v_scale.data_ptr() % 4)):
        raise ValueError("k and v must start at a 16-byte boundary and "
                         "their scales at a 4-byte one (the kernel copies "
                         "them in 16- and 4-byte pieces)")
    if scaled and (k_scale.dtype != torch.bfloat16
                   or v_scale.dtype != torch.bfloat16):
        raise ValueError("int8 cache scales must be bf16")
    kind = _KV_KIND[k.dtype]
    cl = launch_geometry(b * kvh, s_len, slots_per_warp(hd, k.element_size()),
                         cluster_capacity(dev, kind, hd, h // kvh))
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    rc = _lib().flash_decode_forward(
        tensors["q"].data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if scaled else None,
        v_scale.data_ptr() if scaled else None,
        tensors["kv_pos"].data_ptr(), tensors["cur_pos"].data_ptr(),
        out.data_ptr(), b, s_len, h, kvh, hd, int(window or 0), cl, kind,
        torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "flash_decode_forward")
    launches.n += 1
    return out

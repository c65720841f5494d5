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

Both wrappers also take several query positions per row (the verify pass
of speculative decoding): q (B, Q, H, hd) with a (B, Q) ``cur_pos``, Q <=
``MAX_QUERIES``.  That is the kernel's multi-query mode: each (row,
query) pair runs as a single-query call at its own position would, with
the cluster size of a single-query call at the same (B, S), so each
query's output equals that call's bit for bit; the plain version is the
single-query one applied per query.

``flash_decode_attention_paged`` is the same attention over a paged KV
cache (``models/kvcache.py``: a page pool plus a per-row block table).
The kernel reads the pool through the block table in place (its
block-table mode); the plain route gathers each row's view from the pool
(``paged_gather``) and runs the contiguous plain version, which is also
what the JAX package's paged decode computes.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.kvcache import paged_gather
from .build import LaunchCounter, check, load

launches = LaunchCounter()
# the launches of ``launches`` that ran the multi-query mode
multi_launches = LaunchCounter()
# the launches of ``launches`` with a window (a local layer's ring)
window_launches = LaunchCounter()

NEG = -2.0 ** 30
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# mirrors of csrc/flash_decode.cu (tests/test_torch_kernels.py reads them
# from the source)
WARPS = 4                     # kWarps: warps per block
STAGE_BYTES = 16384           # kStageBytes: K + V bytes of a block's stage
CLUSTERS = (8, 4, 2, 1)       # blocks per (row, kv-head), largest first
MAX_QUERIES = 8               # kMaxQueries: query positions per row


def flash_decode_attention_plain(q, k, v, kv_pos, cur_pos, k_scale=None,
                                 v_scale=None, window: Optional[int] = None
                                 ) -> torch.Tensor:
    """q: (B, H, hd) pre-scaled by 1/sqrt(hd); k/v: (B, S, KVH, hd);
    kv_pos: (B, S); cur_pos: (B,); scales: (B, S, KVH) for int8 KV.
    Returns (B, H, hd) f32.  Several queries per row, q (B, Q, H, hd) and
    cur_pos (B, Q), give (B, Q, H, hd): each query this function at its
    own position."""
    if q.ndim == 4:
        return torch.stack([flash_decode_attention_plain(
            q[:, i].contiguous(), k, v, kv_pos, cur_pos[:, i], k_scale,
            v_scale, window) for i in range(q.shape[1])], dim=1)
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
        lib.flash_decode_forward.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.flash_decode_forward.restype = i
        lib.flash_decode_max_clusters.argtypes = [i] * 4 + [
            ctypes.POINTER(i)]
        lib.flash_decode_max_clusters.restype = i
    return lib


def _paged_lib() -> ctypes.CDLL:
    """The block-table mode's library (``csrc/flash_decode_paged.cu``: the
    kernel's PAGED instantiations, built beside the contiguous ones)."""
    lib = load("flash_decode_paged.cu")
    if lib.flash_decode_paged_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_paged_forward.argtypes = [p] * 9 + [i] * 11 + [p]
        lib.flash_decode_paged_forward.restype = i
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
    """(B, H, hd) f32 decode attention, or (B, Q, H, hd) for q (B, Q, H,
    hd) and cur_pos (B, Q); arguments as in the plain version.

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
    return _launch(q, k, v, kv_pos, cur_pos, k_scale, v_scale, window,
                   block=None, s_len=k.shape[1])


def flash_decode_attention_paged_plain(q, k_pool, v_pool, pos_pool, block,
                                       cur_pos, k_scale=None, v_scale=None,
                                       window: Optional[int] = None
                                       ) -> torch.Tensor:
    """The plain route of paged decode attention: each row's view gathered
    from the pool through ``block`` (``paged_gather``), then the
    contiguous plain version.  q: (B, H, hd) pre-scaled, or (B, Q, H, hd)
    with cur_pos (B, Q); k_pool/v_pool: (P, PS, KVH, hd); pos_pool: (P,
    PS); block: (B, max_blocks) int32 (-1 = unmapped); scales: (P, PS,
    KVH) for an int8 pool.  Returns (B, H, hd) (or (B, Q, H, hd)) f32."""
    cache = {"k": k_pool, "v": v_pool, "pos": pos_pool, "block": block}
    if k_scale is not None:
        cache["k_scale"], cache["v_scale"] = k_scale, v_scale
    k, v, pos, ks, vs = paged_gather(cache)
    return flash_decode_attention_plain(q, k, v, pos, cur_pos, ks, vs,
                                        window)


def flash_decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor,
                                 pos_pool: torch.Tensor,
                                 block: torch.Tensor, cur_pos: torch.Tensor,
                                 k_scale: Optional[torch.Tensor] = None,
                                 v_scale: Optional[torch.Tensor] = None, *,
                                 window: Optional[int] = None,
                                 require_kernel: bool = False
                                 ) -> torch.Tensor:
    """(B, H, hd) (or (B, Q, H, hd)) f32 decode attention over a paged
    KV cache; arguments as in the plain version.  A CUDA tensor launches
    the kernel in its block-table mode (reading the pool in place, no
    gather) or raises; a CPU tensor runs the plain route, unless
    ``require_kernel`` asks for the kernel.  Equal bit for bit to
    ``paged_gather`` followed by ``flash_decode_attention`` on the
    card."""
    if not q.is_cuda:
        if require_kernel:
            raise ValueError("the CUDA flash-decode kernel needs CUDA "
                             f"tensors; q is on {q.device}")
        return flash_decode_attention_paged_plain(
            q, k_pool, v_pool, pos_pool, block, cur_pos, k_scale, v_scale,
            window)
    n_pages, ps = k_pool.shape[:2]
    if block.dtype != torch.int32 or block.ndim != 2 or \
            block.shape[0] != q.shape[0]:
        raise ValueError(f"block must be int32 (B, max_blocks) with B = "
                         f"{q.shape[0]}; got {block.dtype} "
                         f"{tuple(block.shape)}")
    if ps <= 0 or ps & (ps - 1):
        raise ValueError(f"the page size must be a power of two: {ps}")
    if tuple(pos_pool.shape) != (n_pages, ps) or \
            pos_pool.dtype != torch.int32:
        raise ValueError(f"the pool's pos plane must be int32 "
                         f"({n_pages}, {ps}); got {pos_pool.dtype} "
                         f"{tuple(pos_pool.shape)}")
    if v_pool.shape != k_pool.shape or (k_scale is not None and (
            k_scale.shape != k_pool.shape[:3]
            or v_scale is None or v_scale.shape != k_pool.shape[:3])):
        raise ValueError("k_pool, v_pool (P, PS, KVH, hd) and their scales "
                         "(P, PS, KVH) must agree in shape")
    return _launch(q, k_pool, v_pool, pos_pool, cur_pos, k_scale, v_scale,
                   window, block=block, s_len=block.shape[1] * ps)


def _launch(q, k, v, kv_pos, cur_pos, k_scale, v_scale, window, *, block,
            s_len: int) -> torch.Tensor:
    """Check the arguments and launch the kernel: over a contiguous (B, S,
    KVH, hd) cache (``block`` None) or, in its block-table mode, over a
    (P, PS, KVH, hd) pool of ``s_len`` = max_blocks * PS logical slots
    per row; one query per row (q (B, H, hd), cur_pos (B,)) or, in the
    multi-query mode, Q (q (B, Q, H, hd), cur_pos (B, Q))."""
    multi = q.ndim == 4
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nq = q.shape[1] if multi else 1
    if tuple(cur_pos.shape) != tuple(q.shape[:-2]) or not 1 <= nq <= \
            MAX_QUERIES:
        raise ValueError(f"q {tuple(q.shape)} takes cur_pos "
                         f"{tuple(q.shape[:-2])} and at most {MAX_QUERIES} "
                         f"queries per row; got cur_pos "
                         f"{tuple(cur_pos.shape)}")
    kvh = k.shape[2]
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
    if block is not None:
        tensors["block"] = block
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
    out = torch.empty(tuple(q.shape), dtype=torch.float32, device=dev)
    ptrs = (tensors["q"].data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if scaled else None,
            v_scale.data_ptr() if scaled else None,
            tensors["kv_pos"].data_ptr(), tensors["cur_pos"].data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if block is None:
        rc = _lib().flash_decode_forward(
            *ptrs, out.data_ptr(), b, s_len, h, kvh, hd, int(window or 0),
            cl, kind, nq, stream)
        check(rc, "flash_decode_forward")
    else:
        rc = _paged_lib().flash_decode_paged_forward(
            *ptrs, block.data_ptr(), out.data_ptr(), b, s_len, h, kvh, hd,
            int(window or 0), cl, kind, k.shape[1], k.shape[0], nq, stream)
        check(rc, "flash_decode_paged_forward")
    launches.n += 1
    if multi:
        multi_launches.n += 1
    if window:
        window_launches.n += 1
    return out

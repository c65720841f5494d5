"""Flash-decode attention: CUDA kernel wrapper and its plain version.

Port of ``repro/kernels/decode_attention.py::flash_decode_attention``:
GQA attention of one query token per row against a (B, S, KVH, hd)
cache, masked by ``pos >= 0 & pos <= cur`` (``& pos > cur - window``),
with an int8 cache's per-(slot, head) scales folded into the scores and
the probabilities.  The kernel (``csrc/flash_decode.cu``) splits S into
chunks and merges them in a second launch; see the source note there.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import LaunchCounter, check, load

launches = LaunchCounter()

NEG = -2.0 ** 30
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_TARGET_BLOCKS = 264          # two blocks per SM of an H100


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


def _lib():
    fn = load("flash_decode.cu").flash_decode_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p] * 11 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
    return fn


def num_chunks(b: int, kvh: int, s: int) -> int:
    """KV chunks per (row, kv-head): enough blocks to fill the card, with
    at least 32 slots per chunk."""
    want = -(-_TARGET_BLOCKS // max(b * kvh, 1))
    return max(1, min(want, -(-s // 32)))


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
    with no valid slot gives zeros from the kernel, where the plain
    version gives the mean of V over its slots."""
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
    if scaled and (k_scale.dtype != torch.bfloat16
                   or v_scale.dtype != torch.bfloat16):
        raise ValueError("int8 cache scales must be bf16")
    nc = num_chunks(b, kvh, s_len)
    pm = torch.empty((b, h, nc), dtype=torch.float32, device=dev)
    pl = torch.empty_like(pm)
    pacc = torch.empty((b, h, nc, hd), dtype=torch.float32, device=dev)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    rc = _lib()(tensors["q"].data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr() if scaled else None,
                v_scale.data_ptr() if scaled else None,
                tensors["kv_pos"].data_ptr(), tensors["cur_pos"].data_ptr(),
                pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
                b, s_len, h, kvh, hd, int(window or 0), nc,
                _KV_KIND[k.dtype], torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "flash_decode_forward")
    launches.n += 1
    return out

"""Group-wise affine quantization with block-local bit-plane packing.

Port of ``repro/core/quantize.py``.  A b-bit tensor is stored as a set of
power-of-two bit planes (3 = 2+1): a plane of width ``p`` packs
``c = 8//p`` values per byte.  Packing is block-local along K (block =
``PACK_BLOCK`` rows): the K axis is cut into blocks, each block into
``c`` contiguous chunks, chunk ``j`` stored at bit offset ``j*p``.  The
packed bytes are identical to the JAX package's, byte for byte.

Quantization is asymmetric uint: ``q = clip(round(w/s + z), 0, 2^b-1)``
and ``dequant = (q - z) * s`` with per-group (G along K) scale/zero.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

# plane decomposition per bit width: tuple of (plane_width, bit_offset)
PLANES = {
    1: ((1, 0),),
    2: ((2, 0),),
    3: ((2, 0), (1, 2)),
    4: ((4, 0),),
    8: ((8, 0),),
}

PACK_BLOCK = 64  # K rows per packing block

SCALE_WIRE_BYTES = 2  # scale/zero (and factor scales) travel as bf16


def packed_rows(p: int, k: int) -> int:
    """Row count of one width-``p`` bit plane over ``k`` K rows."""
    return k // (8 // p)


def packed_nbytes(bits: int, k: int, n: int) -> int:
    """Exact packed byte count for a (k, n) matrix at ``bits`` width."""
    return sum(packed_rows(p, k) * n for p, _ in PLANES[bits])


def quant_wire_bytes(bits: int, k: int, n: int, group_size: int) -> int:
    """Wire bytes of one (k, n) groupwise-quantized matrix: bit-plane
    packed codes + bf16 scale AND zero per (K-group, column)."""
    return (packed_nbytes(bits, k, n)
            + 2 * (k // group_size) * n * SCALE_WIRE_BYTES)


def factor_wire_bytes(rank: int, m: int, n: int, factor_bits: int) -> int:
    """Wire bytes of a rank-``rank`` compensator for an (m, n) matrix:
    sub-byte U/V codes at ``factor_bits`` plus two bf16 per-rank scale
    vectors."""
    return (int(rank) * (m + n) * factor_bits) // 8 \
        + 2 * SCALE_WIRE_BYTES * int(rank)


# ---------------------------------------------------------------------------
# block-local bit-plane packing
# ---------------------------------------------------------------------------

def pack_plane(vals: torch.Tensor, p: int, block: int = PACK_BLOCK
               ) -> torch.Tensor:
    """Pack (..., K, N) uint8 p-bit values into (..., K//(8//p), N) bytes,
    block-local: within each K-block, chunk j goes to bit offset j*p."""
    c = 8 // p
    *lead, k, n = vals.shape
    if k % block or block % c:
        raise ValueError(f"K={k} must be a multiple of the pack block "
                         f"{block} (c={c})")
    v = vals.reshape(*lead, k // block, c, block // c, n).to(torch.uint8)
    out = torch.zeros((*lead, k // block, block // c, n), dtype=torch.uint8,
                      device=vals.device)
    for j in range(c):
        out |= v[..., j, :, :] << (j * p)
    return out.reshape(*lead, k // c, n)


def unpack_plane(packed: torch.Tensor, p: int, block: int = PACK_BLOCK
                 ) -> torch.Tensor:
    """Inverse of :func:`pack_plane`: (..., K//c, N) bytes -> (..., K, N)
    uint8."""
    c = 8 // p
    *lead, kc, n = packed.shape
    k = kc * c
    mask = (1 << p) - 1
    pk = packed.reshape(*lead, k // block, block // c, n)
    chunks = [(pk >> (j * p)) & mask for j in range(c)]
    return torch.stack(chunks, dim=-3).reshape(*lead, k, n)


def pack_bits(q: torch.Tensor, bits: int, block: int = PACK_BLOCK
              ) -> Tuple[torch.Tensor, ...]:
    """Split b-bit codes (..., K, N) into power-of-two planes and pack
    each."""
    q = q.to(torch.uint8)
    return tuple(pack_plane((q >> off) & ((1 << p) - 1), p, block)
                 for p, off in PLANES[bits])


def unpack_bits(planes: Tuple[torch.Tensor, ...], bits: int,
                block: int = PACK_BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> uint8 codes (..., K, N)."""
    out = None
    for (p, off), plane in zip(PLANES[bits], planes):
        sub = unpack_plane(plane, p, block) << off
        out = sub if out is None else out | sub
    return out


# ---------------------------------------------------------------------------
# QuantizedTensor container
# ---------------------------------------------------------------------------

@dataclass
class QuantizedTensor:
    """Packed groupwise-quantized matrix of logical ``shape`` = (K, N).

    ``planes``: tuple of uint8 tensors (one per bit plane);
    ``scale``/``zero``: (K // group_size, N) f32.
    """
    planes: Tuple[torch.Tensor, ...]
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    shape: Tuple[int, int]


def _group_minmax(w: torch.Tensor, group_size: int):
    """(..., K, N) -> groups (..., K//G, G, N) and their min and max over
    each group, keepdims (..., K//G, 1, N)."""
    *lead, k, n = w.shape
    g = w.reshape(*lead, k // group_size, group_size, n)
    return (g, g.amin(dim=-2, keepdim=True), g.amax(dim=-2, keepdim=True))


def rtn_quantize(w: torch.Tensor, bits: int, group_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain round-to-nearest groupwise asymmetric quantization of
    (..., K, N) f32 weights, as the JAX package's ``quantize`` rounds
    (half to even, f32 throughout).  Returns (uint8 codes (..., K, N),
    scale, zero), each of the last two (..., K//G, N)."""
    *lead, k, n = w.shape
    g, lo, hi = _group_minmax(w.float(), group_size)
    qmax = (1 << bits) - 1
    scale = torch.clamp_min((hi - lo) / qmax, 1e-8)
    zero = -lo / scale
    q = torch.clamp(torch.round(g / scale + zero), 0, qmax)
    return (q.reshape(*lead, k, n).to(torch.uint8),
            scale.reshape(*lead, k // group_size, n),
            zero.reshape(*lead, k // group_size, n))


def quantize_codes(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   bits: int, group_size: int) -> torch.Tensor:
    """Unpacked uint8 codes in [0, 2^bits) for given scale/zero.  ``w``
    is (..., K, N), ``scale``/``zero`` (..., K//G, N): one matrix or a
    stack of experts."""
    *lead, k, n = w.shape
    qmax = (1 << bits) - 1
    g = w.float().reshape(*lead, k // group_size, group_size, n)
    q = torch.clamp(torch.round(g / scale[..., None, :]
                                + zero[..., None, :]), 0, qmax)
    return q.reshape(*lead, k, n).to(torch.uint8)


def dequantize_codes(q: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, group_size: int,
                     dtype=torch.float32) -> torch.Tensor:
    """``(q - z) * s`` per (K-group, column) of (..., K, N) codes."""
    *lead, k, n = q.shape
    g = q.float().reshape(*lead, k // group_size, group_size, n)
    w = (g - zero[..., None, :]) * scale[..., None, :]
    return w.reshape(*lead, k, n).to(dtype)

"""Pinned host-memory images of compressed expert stacks (streaming);
port of ``repro/offload/hostmem.py``.

Offloaded serving keeps the compressed experts in page-locked ("pinned")
host memory so the copy engine can source async H2D copies from them.
:class:`HostExpertImage` is that staging area for one MoE layer, filled
once from the stacks at attach time; the transfer engine
(``offload/staging.py``) takes per-expert copy payloads from it: bit-plane
codes + scale/zero for a weight fetch, factor rank rows for a compensator
fetch.  On a CUDA engine the image is pinned (a failure to pin raises);
on a CPU engine it is ordinary host memory.

Layout.  The JAX image keeps one numpy array per leaf.  Here one
layer's weight leaves are packed expert-major into ONE pinned (E, row)
byte buffer: expert ``e``'s scale and zero of every projection, then its
bit planes, back to back in row ``e``.  A weight payload is then one
contiguous host range, so a weight copy is one ``cudaMemcpyAsync`` (the
JAX layout would take nine for a three-projection layer).  Factor leaves
keep the stack layout; a rank window ``u[e][:, lo:hi]`` is strided, so a
factor payload is gathered into a contiguous (pinned) block before it
crosses the link.

The companion :func:`build_fallback_stack` produces the device-resident
low-bit fallback copy — MoBiLE's "little expert": a plain RTN
requantization of the dequantized layer at ``fallback_bits``, packed
into the SAME container layout (bit width, group size, padded rank, all
meta identical), with zeroed compensator factors.  The streaming engine
boots every device container from it, so a routed expert whose copy has
not landed is served degraded instead of stalling, and streamed payloads
are copied into the container without any shape change (the captured
decode graph reads the containers in place).

No wire-byte arithmetic lives here: byte accounting stays with the
canonical formulas in ``core/quantize.py`` via the store's metering
(``offload/store.py``); this module only lays out payload bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.pipeline import CompressedExpertStack
from ..core.quantize import PLANES, pack_bits, rtn_quantize

# leaves that move with a weight fetch vs a factor fetch
WEIGHT_LEAVES = ("planes", "scale", "zero")
FACTOR_LEAVES = ("u", "v", "u_scale", "v_scale")


def _nbytes(dtype: torch.dtype, shape: Tuple[int, ...]) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """Where one leaf of one projection sits in a payload's bytes."""
    proj: str
    name: str             # a WEIGHT_LEAVES / FACTOR_LEAVES name
    plane: int            # bit-plane index for 'planes', else -1
    offset: int           # byte offset in the payload
    dtype: torch.dtype
    shape: Tuple[int, ...]
    nbytes: int

    def view(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.offset:self.offset + self.nbytes] \
            .view(self.dtype).view(self.shape)


@dataclasses.dataclass
class Payload:
    """One copy's bytes: ``data`` is a contiguous (nbytes,) uint8 range
    (on the host as a copy's source, on the device once it has landed),
    ``leaves`` says which container leaf each part of it fills."""
    data: torch.Tensor
    leaves: Tuple[_Leaf, ...]

    @property
    def nbytes(self) -> int:
        return self.data.numel()

    def tree(self) -> Dict[str, Dict]:
        """The JAX payload pytree: {proj: {'planes': (...), 'scale',
        'zero'}} for weights, {proj: {'u', 'v', 'u_scale', 'v_scale'}}
        for factors, each leaf a view of ``data``."""
        out: Dict[str, Dict] = {}
        for lf in self.leaves:
            d = out.setdefault(lf.proj, {})
            t = lf.view(self.data)
            if lf.name == "planes":
                d["planes"] = d.get("planes", ()) + (t,)
            else:
                d[lf.name] = t
        return out


def _weight_layout(stacks: Dict[str, CompressedExpertStack]
                   ) -> Tuple[Tuple[_Leaf, ...], int]:
    """One expert's weight leaves in a packed row: the f32 scale/zero of
    every projection first, then the uint8 planes (so every view is
    aligned); the row padded to 16 bytes."""
    parts: List[Tuple[str, str, int, torch.Tensor]] = []
    for name, s in stacks.items():
        parts += [(name, "scale", -1, s.scale), (name, "zero", -1, s.zero)]
    for name, s in stacks.items():
        parts += [(name, "planes", i, p) for i, p in enumerate(s.planes)]
    leaves, off = [], 0
    for proj, leaf, plane, t in parts:
        shape = tuple(t.shape[1:])
        lf = _Leaf(proj, leaf, plane, off, t.dtype, shape,
                   _nbytes(t.dtype, shape))
        leaves.append(lf)
        off += lf.nbytes
    return tuple(leaves), -(-off // 16) * 16


class HostExpertImage:
    """Host-side per-expert image of one MoE layer's compressed stacks.

    ``stacks``: {proj: CompressedExpertStack} with the TRUE (offline
    compressed) contents.  The leaves are copied into host memory
    (pinned when ``pin``) at construction, so later in-place updates of
    the serving containers cannot touch the copy source."""

    def __init__(self, stacks: Dict[str, CompressedExpertStack],
                 pin: bool = False):
        self.meta = {name: s for name, s in stacks.items()}
        self.num_experts = e = next(iter(stacks.values())).scale.shape[0]
        dev = next(iter(stacks.values())).scale.device
        self._wleaves, self.row_bytes = _weight_layout(stacks)
        # one host allocation per layer (the pinned allocator rounds each
        # allocation up to a power of two): the packed weight rows, then
        # every factor leaf, each at a 16-byte aligned offset
        regions, off = [], e * self.row_bytes
        for name, s in stacks.items():
            for k in FACTOR_LEAVES:
                t = getattr(s, k)
                regions.append((name, k, off, t))
                off += -(-t.numel() * t.element_size() // 16) * 16
        self.buffer = torch.empty((off,), dtype=torch.uint8, pin_memory=pin)
        if pin and not self.buffer.is_pinned():
            raise RuntimeError("the host expert image could not be pinned")
        # the packed weight rows are assembled on the stacks' device and
        # cross to the host in one copy
        rows = torch.zeros((e, self.row_bytes), dtype=torch.uint8,
                           device=dev)
        for lf in self._wleaves:
            s = stacks[lf.proj]
            src = (s.planes[lf.plane] if lf.name == "planes"
                   else getattr(s, lf.name))
            rows[:, lf.offset:lf.offset + lf.nbytes] = \
                src.contiguous().view(e, -1).view(torch.uint8)
        self._wrows = self.buffer[:e * self.row_bytes].view(e, self.row_bytes)
        self._wrows.copy_(rows)
        del rows
        self._factors: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, k, o, t in regions:
            n = t.numel() * t.element_size()
            host = self.buffer[o:o + n].view(t.dtype).view(t.shape)
            host.copy_(t)
            self._factors.setdefault(name, {})[k] = host
        # the largest factor payload (every projection at its padded rank)
        self.max_factor_bytes = sum(
            sum(t[0].numel() * t.element_size() for t in f.values())
            for f in self._factors.values())

    @property
    def host_nbytes(self) -> int:
        """Host footprint of the container-form leaves (the packed rows'
        16-byte padding excluded: none at any shipped configuration)."""
        w = sum(lf.nbytes for lf in self._wleaves) * self.num_experts
        f = sum(t.numel() * t.element_size()
                for leaves in self._factors.values()
                for t in leaves.values())
        return w + f

    @property
    def weight_bytes(self) -> int:
        """Bytes one weight payload puts on the link (container form)."""
        return sum(lf.nbytes for lf in self._wleaves)

    def weight_payload(self, e: int) -> Payload:
        """Copy payload for expert ``e``'s quantized weights: its packed
        row (codes + scale/zero of every projection), one host range."""
        return Payload(self._wrows[e, :self.weight_bytes], self._wleaves)

    def factor_payload(self, e: int, ranks: Dict[str, Tuple[int, int]],
                       pin: bool = False) -> Payload:
        """Copy payload for expert ``e``'s compensator factor rows.

        ``ranks``: {proj: (lo, hi)} rank window per projection (a raised
        rank cap fetches only the missing delta rows).  Projections with
        an empty window are omitted.  The (strided) windows are gathered
        into a new contiguous host block, pinned when ``pin``: the f32
        scales first, then u and v.  The pinned allocator reuses a block
        only after the copies that read it have finished."""
        parts = []
        for name, leaves in self._factors.items():
            lo, hi = ranks.get(name, (0, 0))
            if hi <= lo:
                continue
            parts += [(name, "u_scale", leaves["u_scale"][e][:, lo:hi]),
                      (name, "v_scale", leaves["v_scale"][e][lo:hi, :])]
        for name, leaves in self._factors.items():
            lo, hi = ranks.get(name, (0, 0))
            if hi <= lo:
                continue
            parts += [(name, "u", leaves["u"][e][:, lo:hi]),
                      (name, "v", leaves["v"][e][lo:hi, :])]
        leaves_out, off = [], 0
        for proj, leaf, t in parts:
            shape = tuple(t.shape)
            lf = _Leaf(proj, leaf, -1, off, t.dtype, shape,
                       _nbytes(t.dtype, shape))
            leaves_out.append(lf)
            off += lf.nbytes
        flat = torch.empty((off,), dtype=torch.uint8, pin_memory=pin)
        if pin and not flat.is_pinned():
            raise RuntimeError("a factor payload block could not be pinned")
        for lf, (_p, _l, t) in zip(leaves_out, parts):
            lf.view(flat).copy_(t)
        return Payload(flat, tuple(leaves_out))


def _clamp_fallback_bits(bits: int, container_bits: int) -> int:
    """Largest supported plane width <= min(bits, container width)."""
    cap = min(int(bits), int(container_bits))
    ok = [b for b in PLANES if b <= cap]
    if not ok:
        raise ValueError(f"no supported fallback width <= {cap}")
    return max(ok)


@torch.no_grad()
def build_fallback_stack(stack: CompressedExpertStack,
                         fallback_bits: int = 2) -> CompressedExpertStack:
    """Device-resident low-bit fallback ("little expert") for one stack.

    RTN-requantizes the dequantized stack at ``fallback_bits`` (clamped
    to the container width), packs the codes back into the ORIGINAL
    container layout, and zeroes the compensator factors.  Every meta
    field — container bits, group size, ranks, pad_rank, expert_bits —
    is preserved, so the fallback has the true stack's shapes and dtypes:
    the streaming engine boots the serving containers from it and later
    copies true expert payloads in place."""
    fb = _clamp_fallback_bits(fallback_bits, stack.bits)
    q, scale, zero = rtn_quantize(stack.dequantize_all(), fb,
                                  stack.group_size)
    return dataclasses.replace(
        stack, planes=pack_bits(q, stack.bits),
        scale=scale.to(stack.scale.dtype), zero=zero.to(stack.zero.dtype),
        u=torch.zeros_like(stack.u), v=torch.zeros_like(stack.v),
        u_scale=torch.zeros_like(stack.u_scale),
        v_scale=torch.zeros_like(stack.v_scale), _meta={})


def build_fallback_stacks(stacks: Dict[str, CompressedExpertStack],
                          fallback_bits: int = 2
                          ) -> Dict[str, CompressedExpertStack]:
    """Fallback copies for every projection of one MoE layer."""
    return {name: build_fallback_stack(s, fallback_bits)
            for name, s in stacks.items()}

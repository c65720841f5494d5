"""Offline compression pipeline (paper §3.1): HQQ quantize -> kurtosis ->
rank allocation -> one truncated SVD per expert -> packed stack.

Port of ``repro/core/pipeline.py`` (the uncalibrated ``moment=None``
path).  Operates on expert stacks: a (E, K, N) weight tensor holding one
projection (w1/w2/w3) for all E experts of a layer.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import QuantConfig
from .compensator import _sym_quant_cols
from .hqq import hqq_params
from .kurtosis import allocate_ranks, kurtosis, uniform_ranks
from .quantize import (dequantize, factor_wire_bytes, quant_error,
                       quant_wire_bytes, quantize_with_params, unpack_bits)


@dataclass
class CompressedExpertStack:
    """Quantized weights + padded low-rank compensators for E experts.

    planes[i]: (E, K//c_i, N) uint8;  scale/zero: (E, K//G, N) f32
    u: (E, K, R) int8/bf16;  v: (E, R, N);  R = pad_rank
    u_scale: (E, 1, R) f32;  v_scale: (E, R, 1) f32
    ranks: per-expert TRUE ranks (columns >= ranks[e] are exact zeros).

    ``bits`` is the bit-plane CONTAINER width shared by the stacked
    layout; ``expert_bits[e]`` is expert e's true width (None = every
    expert at ``bits``).
    """
    planes: Tuple[torch.Tensor, ...]
    scale: torch.Tensor
    zero: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    u_scale: torch.Tensor
    v_scale: torch.Tensor
    bits: int
    group_size: int
    shape: Tuple[int, int, int]        # (E, K, N)
    ranks: Tuple[int, ...]
    pad_rank: int
    factor_bits: int
    expert_bits: Optional[Tuple[int, ...]] = None
    # device copies of (expert_bits, ranks) that kernels read as runtime
    # data; built on first use
    _meta: Dict[str, torch.Tensor] = field(default_factory=dict, repr=False,
                                           compare=False)

    def meta_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(expert_bits (E,) i32, ranks (E,) i32) on the stack's device."""
        if not self._meta:
            e = self.scale.shape[0]
            eb = self.expert_bits or (self.bits,) * e
            dev = self.scale.device
            self._meta["eb"] = torch.tensor(eb, dtype=torch.int32,
                                            device=dev)
            self._meta["ranks"] = torch.tensor(self.ranks, dtype=torch.int32,
                                               device=dev)
        return self._meta["eb"], self._meta["ranks"]

    def dequantize_all(self, dtype=torch.float32) -> torch.Tensor:
        """(E, K, N) dequantized weights (no compensation)."""
        _, K, N = self.shape
        E = self.scale.shape[0]
        q = torch.stack([unpack_bits(tuple(p[e] for p in self.planes),
                                     self.bits) for e in range(E)])
        g = q.float().reshape(E, K // self.group_size, self.group_size, N)
        w = (g - self.zero[:, :, None, :]) * self.scale[:, :, None, :]
        return w.reshape(E, K, N).to(dtype)

    def compensation_all(self, dtype=torch.float32) -> torch.Tensor:
        """(E, K, N) dense U V term for every expert."""
        u = self.u.float() * self.u_scale
        v = self.v.float() * self.v_scale
        return torch.einsum("ekr,ern->ekn", u, v).to(dtype)

    def bits_of(self, e: int) -> int:
        return self.bits if self.expert_bits is None else self.expert_bits[e]

    def expert_wire_bytes(self, e: int, compensated: bool) -> int:
        _, K, N = self.shape
        b = quant_wire_bytes(self.bits_of(e), K, N, self.group_size)
        if compensated:
            b += factor_wire_bytes(self.ranks[e], K, N, self.factor_bits)
        return b

    @property
    def fp16_wire_bytes(self) -> int:
        """Wire bytes of one expert at 16 bits (the 'fp16' fetch policy's
        per-expert transfer)."""
        _, K, N = self.shape
        return K * N * 2


@torch.no_grad()
def whitened_residual_factors(resid: torch.Tensor, rank: int, pad_rank: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank-``rank`` factors (u (K, R), v (R, N)) of one expert's quant
    residual, reparameterized u = U sqrt(S), v = sqrt(S) V^T and
    zero-padded to ``pad_rank`` columns.

    Only the top ``pad_rank`` singular triplets are needed, so they come
    from ``eigh`` of the smaller Gram matrix in float64 instead of a full
    SVD: the same truncated factors up to sign, at a fraction of the cost
    for (4096, 14336) residuals.  ``rank == 0`` gives exact zeros without
    any decomposition (the JAX package masks those columns to zero).
    """
    k, n = resid.shape
    dt = torch.float32
    if rank <= 0:
        return (torch.zeros((k, pad_rank), dtype=dt, device=resid.device),
                torch.zeros((pad_rank, n), dtype=dt, device=resid.device))
    r64 = resid.double()
    small_left = k <= n
    gram = r64 @ r64.T if small_left else r64.T @ r64
    evals, evecs = torch.linalg.eigh(gram)              # ascending
    top = torch.arange(evals.shape[0] - 1, evals.shape[0] - 1 - pad_rank, -1,
                       device=resid.device)
    s = torch.sqrt(torch.clamp(evals[top], min=0.0))    # singular values
    vec = evecs[:, top]
    sq = torch.sqrt(s)
    inv = torch.where(sq > 0, 1.0 / torch.clamp(sq, min=1e-300),
                      torch.zeros_like(sq))
    if small_left:                      # vec = left singular vectors
        uu = vec * sq[None, :]
        vv = (vec.T @ r64) * inv[:, None]
    else:                               # vec = right singular vectors
        vv = vec.T * sq[:, None]
        uu = (r64 @ vec) * inv[None, :]
    mask = (torch.arange(pad_rank, device=resid.device) < rank).double()
    return ((uu * mask[None, :]).to(dt), (vv * mask[:, None]).to(dt))


@torch.no_grad()
def compress_expert_stack(w: torch.Tensor, qcfg: QuantConfig,
                          ranks: Optional[np.ndarray] = None,
                          bits: Optional[np.ndarray] = None
                          ) -> Tuple[CompressedExpertStack, Dict]:
    """Full offline pipeline for one (E, K, N) projection stack.

    ``ranks``/``bits``: optional per-expert allocations; ``bits`` None
    means uniform ``qcfg.bits``.  Returns the packed stack plus a report
    dict (kurtosis, ranks, bits, residual norms before/after
    compensation)."""
    E, K, N = w.shape
    w32 = w.float()
    if qcfg.group_size <= 0 or qcfg.group_size > K:
        qcfg = dataclasses.replace(qcfg, group_size=K)

    kurt = np.array([float(kurtosis(w32[e])) for e in range(E)])

    if bits is None:
        expert_bits = np.full((E,), qcfg.bits, np.int64)
    else:
        expert_bits = np.asarray(bits, np.int64).reshape(E)
    store_bits = int(expert_bits.max())

    def _q(we, b):
        s, z = hqq_params(we, b, qcfg.group_size, qcfg.hqq_iters,
                          qcfg.hqq_p, qcfg.hqq_beta, qcfg.hqq_beta_scale)
        return quantize_with_params(we, s, z, b, qcfg.group_size,
                                    store_bits=store_bits)

    qts = [_q(w32[e], int(expert_bits[e])) for e in range(E)]

    max_rank = min(K, N)
    strategy = qcfg.rank_alloc if qcfg.kurtosis_guided else "uniform"
    if ranks is None:
        if strategy == "error":
            errs = np.array([float(quant_error(w32[e], qts[e]))
                             for e in range(E)])
            ranks = allocate_ranks(errs, qcfg.rank_budget, qcfg.rank_buckets,
                                   max_rank=max_rank)
        elif strategy == "kurtosis":
            ranks = allocate_ranks(kurt, qcfg.rank_budget, qcfg.rank_buckets,
                                   max_rank=max_rank)
        else:
            r = (qcfg.uniform_rank if qcfg.uniform_rank is not None
                 else qcfg.rank_budget)
            ranks = uniform_ranks(E, r, qcfg.rank_buckets)
    ranks = np.minimum(np.asarray(ranks, np.int64), max_rank)
    pad_rank = int(max(int(ranks.max()), 1))
    planes = tuple(torch.stack([qt.planes[i] for qt in qts])
                   for i in range(len(qts[0].planes)))
    scale = torch.stack([qt.scale for qt in qts])
    zero = torch.stack([qt.zero for qt in qts])

    us, vs, uss, vss = [], [], [], []
    rel_q, rel_c = [], []
    for e in range(E):
        resid = w32[e] - dequantize(qts[e])
        uu, vv = whitened_residual_factors(resid, int(ranks[e]), pad_rank)
        if qcfg.factor_bits >= 16:
            qu, qv = uu.to(torch.bfloat16), vv.to(torch.bfloat16)
            su = torch.ones((1, pad_rank), dtype=torch.float32,
                            device=w.device)
            sv = torch.ones((pad_rank, 1), dtype=torch.float32,
                            device=w.device)
        else:
            qu, su = _sym_quant_cols(uu, qcfg.factor_bits, axis=0)
            qv, sv = _sym_quant_cols(vv, qcfg.factor_bits, axis=1)
        us.append(qu); vs.append(qv); uss.append(su); vss.append(sv)
        comp = (qu.float() * su) @ (qv.float() * sv)
        nw = max(float(torch.linalg.norm(w32[e])), 1e-12)
        rel_q.append(float(torch.linalg.norm(resid)) / nw)
        rel_c.append(float(torch.linalg.norm(resid - comp)) / nw)
        del resid, comp

    hetero = bool((expert_bits != expert_bits[0]).any()) \
        or int(expert_bits[0]) != store_bits
    stack = CompressedExpertStack(
        planes=planes, scale=scale, zero=zero,
        u=torch.stack(us), v=torch.stack(vs),
        u_scale=torch.stack(uss), v_scale=torch.stack(vss),
        bits=store_bits, group_size=qcfg.group_size, shape=(E, K, N),
        ranks=tuple(int(r) for r in ranks), pad_rank=pad_rank,
        factor_bits=qcfg.factor_bits,
        expert_bits=tuple(int(b) for b in expert_bits) if hetero else None)
    report = {"kurtosis": kurt, "ranks": np.asarray(ranks),
              "bits": np.asarray(expert_bits),
              "rel_err_quant": np.asarray(rel_q),
              "rel_err_comp": np.asarray(rel_c)}
    return stack, report


def compress_ffn_weights(w1: torch.Tensor, w2: torch.Tensor,
                         w3: Optional[torch.Tensor], qcfg: QuantConfig):
    """Compress the three projections of an expert FFN stack; rank
    allocation runs per projection pool (w1/w2/w3 separately)."""
    out, reports = {}, {}
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if w is None:
            continue
        out[name], reports[name] = compress_expert_stack(w, qcfg)
    return out, reports

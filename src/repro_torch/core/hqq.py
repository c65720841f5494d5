"""Half-Quadratic Quantization (HQQ): calibration-free zero-point search.

Port of ``repro/core/hqq.py`` (Badri & Shaji, 2023).  Per iteration:

    W_q = clip(round(W/s + z))
    W_r = (W_q - z) * s
    W_e = shrink_lp(W - W_r, beta, p)
    z   = mean_g( W_q - (W - W_e)/s )
    beta *= kappa

Scale is held at its min/max initialization; only the zero-point moves.
"""
from __future__ import annotations

import numpy as np
import torch


def shrink_lp(x: torch.Tensor, beta: float, p: float) -> torch.Tensor:
    ax = torch.abs(x)
    thresh = torch.pow(torch.clamp(ax, min=1e-8), p - 1.0) / beta
    return torch.sign(x) * torch.clamp(ax - thresh, min=0.0)


@torch.no_grad()
def hqq_params(w: torch.Tensor, bits: int, group_size: int = 64,
               iters: int = 20, p: float = 0.7, beta: float = 10.0,
               beta_scale: float = 1.01):
    """HQQ-optimized (scale, zero), each (K//G, N) f32.

    The optimization runs on std-normalized weights (the l_p threshold is
    not scale-invariant); the normalization is folded back into scale."""
    k, n = w.shape
    w32 = w.float()
    wstd = torch.clamp(torch.std(w32, correction=0), min=1e-12)
    g = (w32 / wstd).reshape(k // group_size, group_size, n)
    qmax = (1 << bits) - 1
    lo = g.amin(dim=1, keepdim=True)
    hi = g.amax(dim=1, keepdim=True)
    scale = torch.clamp((hi - lo) / qmax, min=1e-8)
    zero = -lo / scale
    b = np.float32(beta)
    for _ in range(iters):
        wq = torch.clamp(torch.round(g / scale + zero), 0, qmax)
        wr = (wq - zero) * scale
        we = shrink_lp(g - wr, float(b), p)
        zero = torch.mean(wq - (g - we) / scale, dim=1, keepdim=True)
        b = np.float32(b * np.float32(beta_scale))
    return ((scale * wstd).reshape(-1, n),
            zero.expand(scale.shape).reshape(-1, n).contiguous())

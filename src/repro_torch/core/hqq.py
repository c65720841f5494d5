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
    """HQQ-optimized (scale, zero) of an (E, K, N) expert stack, each
    (E, K//G, N) f32; a (K, N) matrix is the E = 1 case and gives
    (K//G, N).

    The optimization runs on std-normalized weights (the l_p threshold is
    not scale-invariant), each matrix by its own std; the normalization
    is folded back into scale."""
    if w.dim() == 2:
        s, z = hqq_params(w[None], bits, group_size, iters, p, beta,
                          beta_scale)
        return s[0], z[0]
    e, k, n = w.shape
    w32 = w.float()
    wstd = torch.clamp(torch.std(w32.reshape(e, -1), dim=1, correction=0),
                       min=1e-12)[:, None, None, None]
    g = w32.reshape(e, k // group_size, group_size, n) / wstd
    qmax = (1 << bits) - 1
    lo = g.amin(dim=-2, keepdim=True)
    hi = g.amax(dim=-2, keepdim=True)
    scale = torch.clamp((hi - lo) / qmax, min=1e-8)
    zero = -lo / scale
    b = np.float32(beta)
    for _ in range(iters):
        wq = torch.clamp(torch.round(g / scale + zero), 0, qmax)
        wr = (wq - zero) * scale
        we = shrink_lp(g - wr, float(b), p)
        zero = torch.mean(wq - (g - we) / scale, dim=-2, keepdim=True)
        b = np.float32(b * np.float32(beta_scale))
    return ((scale * wstd).reshape(e, -1, n),
            zero.expand(scale.shape).reshape(e, -1, n).contiguous())

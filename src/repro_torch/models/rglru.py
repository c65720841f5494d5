"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU (port of
``repro/models/rglru.py``).

The RG-LRU diagonal linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t),
    a_t = exp(-c * softplus(Lambda) * r_t)
runs as a log-depth scan over the (a, b) pairs of h = a * h_prev + b for
prefill (the JAX package's ``associative_scan``: the same combine, its
products summed in another order) and as one fused step for decode.  The
state is O(1) per row: ``h`` (B, w) and the conv's last ``cw - 1``
inputs, both f32; callers write it into the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

RG_LRU_C = 8.0


def _lru_coeffs(u: torch.Tensor, p: Dict[str, torch.Tensor]):
    """u: (..., w) post-conv signal (f32) -> (a, b) of h = a * h_prev + b."""
    r = torch.sigmoid(torch.einsum("...w,wv->...v", u, p["rg_wa"])
                      + p["rg_ba"])
    i = torch.sigmoid(torch.einsum("...w,wv->...v", u, p["rg_wx"])
                      + p["rg_bx"])
    log_a = -RG_LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * u)
    return a, b


def causal_conv1d(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pad: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  u: (B, S, w); w: (cw, w);
    ``pad``: the (B, cw - 1, w) inputs before u."""
    cw, s = w.shape[0], u.shape[1]
    up = torch.cat([pad, u], dim=1)
    out = up[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + up[:, i:i + s] * w[i]
    return out + b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1, in
    ceil(log2 S) doubling rounds (Hillis-Steele over the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)), not a loop over S."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default: the tanh form, here on f32
    return F.gelu(x, approximate="tanh")


def rglru_seq(x: torch.Tensor, p: Dict[str, torch.Tensor],
              h0: Optional[torch.Tensor] = None,
              conv_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The block over a sequence.  x: (B, S, d) -> (B, S, d) in x's dtype,
    and the state after the last token: ``h`` (B, w) and ``conv`` (B,
    cw - 1, w), f32.  ``h0`` / ``conv_state`` carry a state in."""
    u = torch.einsum("bsd,dw->bsw", x, p["wx"]).float()
    g = _gelu(torch.einsum("bsd,dw->bsw", x, p["wgate"]).float())
    cw = p["conv_w"].shape[0]
    pad = conv_state if conv_state is not None else u.new_zeros(
        (u.shape[0], cw - 1, u.shape[-1]))
    uc = causal_conv1d(u, p["conv_w"].float(), p["conv_b"].float(), pad)
    a, b = _lru_coeffs(uc, p)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    y = torch.einsum("bsw,wd->bsd", h * g, p["wo"].float())
    # the conv's last cw - 1 inputs (the carried-in ones where S < cw - 1)
    conv = torch.cat([pad, u], dim=1)[:, u.shape[1]:]
    return y.to(x.dtype), {"h": h[:, -1], "conv": conv}


def rglru_step(x: torch.Tensor, p: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x: (B, 1, d); state = {h: (B, w), conv: (B, cw -
    1, w)}.  Returns (B, 1, d) in x's dtype and the new state."""
    u = torch.einsum("bsd,dw->bsw", x, p["wx"]).float()
    g = _gelu(torch.einsum("bsd,dw->bsw", x, p["wgate"]).float())
    window = torch.cat([state["conv"], u], dim=1)         # (B, cw, w)
    uc = torch.einsum("bcw,cw->bw", window, p["conv_w"].float()) \
        + p["conv_b"]
    a, b = _lru_coeffs(uc, p)
    h = a * state["h"] + b
    y = torch.einsum("bw,wd->bd", h * g[:, 0], p["wo"].float())
    return y[:, None].to(x.dtype), {"h": h, "conv": window[:, 1:]}

"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM (port of
``repro/models/xlstm.py``).

mLSTM keeps a matrix memory C (hd x hd per head) with exponential gating;
prefill runs the chunkwise-recurrent form (quadratic within a chunk, an
O(1) state carried between chunks) in stabilised log space, decode one
fused update.  sLSTM has a true hidden-to-hidden recurrence
(block-diagonal per head) and runs as a loop over the sequence, as the
JAX package's ``lax.scan`` does.  Stabilisers: ``NEG`` in the chunk mask
and a state built here, -inf in a cache's initial ``m``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, chunk: int = 256):
    """q/k/v: (B, S, H, hd); log_i/log_f: (B, S, H).

    Returns h: (B, S, H, hd) in q's dtype and the final state {c, n, m}
    (true C = c * exp(m) per row and head).  A chunk that does not divide
    S becomes S (one chunk)."""
    b, s, h, hd = q.shape
    if s % chunk:
        chunk = s
    nc = s // chunk
    scale = hd ** -0.5

    def rs(x):  # (B, S, ...) -> (nc, B, chunk, ...)
        return x.reshape((b, nc, chunk) + tuple(x.shape[2:])).movedim(1, 0)

    qs, ks, vs = rs(q * scale), rs(k), rs(v)
    lis, lfs = rs(log_i.float()), rs(log_f.float())
    dev = q.device
    if state is None:
        c = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev)
        n = torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, h), NEG, dtype=torch.float32, device=dev)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))
    outs = []
    for ci in range(nc):
        qc, kc, vc = qs[ci].float(), ks[ci].float(), vs[ci].float()
        li, lf = lis[ci], lfs[ci]                       # (B, chunk, H)
        bcum = torch.cumsum(lf, dim=1)
        # intra-chunk log weights W[t, j] = bcum_t - bcum_j + li_j (j <= t)
        wij = bcum[:, :, None] - bcum[:, None, :] + li[:, None, :]
        wij = torch.where(tri[None, :, :, None], wij,
                          torch.full_like(wij, NEG))    # (B, t, j, H)
        a_t = bcum + m[:, None]                         # inter log scale
        m_t = torch.maximum(a_t, wij.amax(dim=2))       # (B, chunk, H)
        inter = torch.exp(a_t - m_t)
        intra = torch.exp(wij - m_t[:, :, None])
        sc = torch.einsum("bthd,bjhd->btjh", qc, kc)
        num = torch.einsum("btjh,bjhd->bthd", sc * intra, vc)
        num = num + inter[..., None] * torch.einsum("bthd,bhde->bthe", qc,
                                                    c)
        nvec = torch.einsum("btjh,bjhd->bthd", intra, kc) \
            + inter[..., None] * n[:, None]
        qn = torch.einsum("bthd,bthd->bth", qc, nvec)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
        outs.append(num / denom[..., None])
        # chunk-end state
        btot = bcum[:, -1]                              # (B, H)
        wj = btot[:, None] - bcum + li                  # (B, chunk, H)
        m_new = torch.maximum(btot + m, wj.amax(dim=1))
        cd = torch.exp(btot + m - m_new)
        wj = torch.exp(wj - m_new[:, None])
        c = cd[:, :, None, None] * c + torch.einsum(
            "bjhd,bjhe->bhde", wj[..., None] * kc, vc)
        n = cd[:, :, None] * n + torch.einsum("bjh,bjhd->bhd", wj, kc)
        m = m_new
    hout = torch.stack(outs, dim=1).reshape(b, s, h, hd)
    return hout.to(q.dtype), {"c": c, "n": n, "m": m}


def mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step.  q/k/v: (B, 1, H, hd); log gates (B, 1, H)."""
    hd = q.shape[-1]
    scale = hd ** -0.5
    q1 = q[:, 0].float() * scale
    k1, v1 = k[:, 0].float(), v[:, 0].float()
    li, lf = log_i[:, 0].float(), log_f[:, 0].float()
    m_new = torch.maximum(lf + state["m"], li)
    cd = torch.exp(lf + state["m"] - m_new)
    iw = torch.exp(li - m_new)
    c = cd[..., None, None] * state["c"] + iw[..., None, None] * (
        k1[..., :, None] * v1[..., None, :])
    n = cd[..., None] * state["n"] + iw[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, c)
    qn = torch.einsum("bhd,bhd->bh", q1, n)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_new))
    hout = (num / denom[..., None])[:, None]
    return hout.to(q.dtype), {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM cell: sequential, block-diagonal recurrence
# ---------------------------------------------------------------------------

def _slstm_cell(x_zifo, h_prev, c_prev, n_prev, m_prev, rec):
    """One step.  x_zifo: (B, 4, H, hd) f32 pre-activations from the
    input; rec: (4, H, hd, hd) recurrent block-diagonal weights (z, i, f,
    o)."""
    r = torch.einsum("bhd,ghde->bghe", h_prev, rec)
    z = torch.tanh(x_zifo[:, 0] + r[:, 0])
    li = x_zifo[:, 1] + r[:, 1]                          # log input gate
    lf = F.logsigmoid(x_zifo[:, 2] + r[:, 2])            # log forget gate
    o = torch.sigmoid(x_zifo[:, 3] + r[:, 3])
    m_new = torch.maximum(lf + m_prev, li)
    fw = torch.exp(lf + m_prev - m_new)
    iw = torch.exp(li - m_new)
    c = fw * c_prev + iw * z
    n = fw * n_prev + iw
    h = o * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def slstm_seq(x_zifo: torch.Tensor, rec: Dict[str, torch.Tensor],
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x_zifo: (B, S, 4, H, hd); rec: {rz, ri, rf, ro} (H, hd, hd).
    Returns h: (B, S, H, hd) in x_zifo's dtype and the final state."""
    b, s, _, h, hd = x_zifo.shape
    if state is None:
        zeros = torch.zeros((b, h, hd), dtype=torch.float32,
                            device=x_zifo.device)
        state = {"c": zeros, "n": zeros, "h": zeros,
                 "m": torch.full((b, h, hd), NEG, dtype=torch.float32,
                                 device=x_zifo.device)}
    r = torch.stack([rec[k] for k in ("rz", "ri", "rf", "ro")])
    hp, cp, np_, mp = state["h"], state["c"], state["n"], state["m"]
    xf = x_zifo.float()
    hs = []
    for t in range(s):
        hp, cp, np_, mp = _slstm_cell(xf[:, t], hp, cp, np_, mp, r)
        hs.append(hp)
    return (torch.stack(hs, dim=1).to(x_zifo.dtype),
            {"c": cp, "n": np_, "h": hp, "m": mp})

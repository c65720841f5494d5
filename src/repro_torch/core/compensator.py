"""Compensator factor quantization (port of the part of
``repro/core/compensator.py`` that compression uses)."""
from __future__ import annotations

import torch


def _sym_quant_cols(x: torch.Tensor, bits: int, axis: int):
    """Symmetric per-column (``axis`` reduced) quantization into int8
    codes; returns (codes, f32 scale with ``axis`` kept)."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale

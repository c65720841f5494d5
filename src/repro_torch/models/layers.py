"""Shared primitive layers: RMSNorm, activations, RoPE, initializers
(port of ``repro/models/layers.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the JAX package evaluates it: in bf16 (or f16)
    each of exp, add, divide and multiply rounds to the input's type
    (``jax.nn.sigmoid`` lowers to 1 / (1 + exp(-x)) in the input's type),
    where ``F.silu`` rounds once and differs in ~40% of bf16 outputs by
    one step.  In f32 the two agree to an ulp, and ``F.silu`` is one
    kernel."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * (1.0 / (1.0 + torch.exp(-x)))
    return F.silu(x)


def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: a tensor times
    it is the product of two ``dtype`` numbers rounded once, which is how
    JAX multiplies by a weak-typed Python float."""
    return float(torch.tensor(value, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) as
    ``jax.nn.gelu(approximate=True)`` evaluates it: in bf16 each multiply,
    add and the tanh round to bf16, and both constants are bf16 (JAX casts
    sqrt(2/pi) to the input's type and 0.044715 is a weak-typed Python
    float), where ``F.gelu`` rounds once and differs in ~40% of bf16
    outputs.  In f32 the two agree to an ulp, and ``F.gelu`` is one
    kernel."""
    if x.dtype == torch.bfloat16:
        c = in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
        k = in_dtype(0.044715, x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": silu, "gelu": gelu_tanh, "gelu_tanh": gelu_tanh,
            "relu": F.relu}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


# (head_dim, theta, device) -> the frequencies, computed at the first call
_ROPE_FREQS: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 frequencies theta^(-2i/head_dim), computed once
    per (head_dim, theta, device) and then reused: computing them copies
    ``theta`` from the host, which a captured CUDA graph cannot do, so
    the first call must come before any capture.  Callers must not write
    into the returned tensor."""
    dev = torch.device("cpu" if device is None else device)
    key = (head_dim, float(theta), dev)
    if key not in _ROPE_FREQS:
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=dev) / head_dim
        _ROPE_FREQS[key] = 1.0 / torch.pow(
            torch.tensor(theta, dtype=torch.float32, device=dev), exps)
    return _ROPE_FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(shape, fan_in: Optional[int], generator: torch.Generator,
               device, dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (std = 1/sqrt(fan_in))."""
    fan_in = fan_in if fan_in is not None else shape[0]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def embed_init(shape, generator: torch.Generator, device,
               dtype=torch.float32) -> torch.Tensor:
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * 0.02).to(dtype)

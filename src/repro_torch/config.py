"""Frozen-dataclass configuration for the PyTorch port.

A copy of the subset of ``repro/config.py`` that the serving slice reads
(``QuantConfig``, ``MoEConfig``, ``ModelConfig``, ``ServeConfig`` and
``RANK_BUCKETS``).  Field names and defaults match the JAX package, so a
config built here describes the same model as its JAX twin.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

RANK_BUCKETS: Tuple[int, ...] = (0, 16, 32, 128, 256, 512, 1024)


@dataclass(frozen=True)
class QuantConfig:
    """BEAM-LRC quantize-then-compensate settings.

    ``bits`` is the expert-weight precision; ``rank_budget`` is R_avg of
    paper §3.1; ``top_n_restore`` is the number of router-ranked experts
    whose compensators are applied per token (n < k).
    """
    enabled: bool = False
    bits: int = 2
    group_size: int = 64
    rank_budget: int = 32
    rank_buckets: Tuple[int, ...] = RANK_BUCKETS
    top_n_restore: int = 1
    factor_bits: int = 8
    hqq_iters: int = 20
    hqq_p: float = 0.7
    hqq_beta: float = 10.0
    hqq_beta_scale: float = 1.01
    kurtosis_guided: bool = True
    uniform_rank: Optional[int] = None
    rank_alloc: str = "kurtosis"       # kurtosis | error | uniform

    def __post_init__(self):
        if self.bits not in (1, 2, 3, 4, 8):
            raise ValueError(f"unsupported bits={self.bits}")
        if self.factor_bits not in (3, 4, 8, 16):
            raise ValueError(f"unsupported factor_bits={self.factor_bits}")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared_experts: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    quant: QuantConfig = field(default_factory=QuantConfig)


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-only model description (the fields the port reads)."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096
    rope_theta: float = 10_000.0
    act: str = "silu"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    post_attn_norm: bool = False
    scale_embed: bool = False
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1
    first_layer_dense: bool = False
    quant: QuantConfig = field(default_factory=QuantConfig)
    max_position: int = 524_288
    kv_bits: int = 16                  # 8 = int8 KV cache
    force_unroll_plan: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe_layer_period == 0)


@dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0

"""Frozen-dataclass configuration for the PyTorch port.

A copy of the subset of ``repro/config.py`` that the serving slices read
(``QuantConfig``, ``MoEConfig``, ``ModelConfig``, ``ControlConfig``,
``ServeConfig`` and ``RANK_BUCKETS``).  Field names and defaults match
the JAX package, so a config built here describes the same model as its
JAX twin.
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
    gated_ffn: bool = True             # False -> plain 2-matrix MLP
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
class ControlConfig:
    """Runtime bandwidth-budget controller (serve/controller.py).

    Between scheduler decode chunks the controller compares the metered
    offload wire bytes/token against a budget and adjusts a per-layer
    ``(top_n, rank_cap)`` restoration plan.  The budget is either
    ``bytes_per_token`` directly, or derived from a ``tokens_per_s``
    SLO over ``link_bw`` (bytes/token the link can afford at that rate).
    Both zero -> no budget: the plan stays pinned at the static
    ``QuantConfig.top_n_restore`` / full-rank point.
    """
    enabled: bool = False
    bytes_per_token: float = 0.0       # wire-byte budget per decoded token
    tokens_per_s: float = 0.0          # alternative SLO: link_bw / tok_s
    link_bw: float = 25e9              # link bandwidth for the SLO form
    gain: float = 0.5                  # integral step: fraction of the
                                       # ladder crossed at 100% budget error
    deadband: float = 0.05             # |relative error| tolerated w/o moves
    ema: float = 0.5                   # weight of the newest bytes/token
                                       # sample (per-chunk LRU noise filter)
    max_step_frac: float = 0.125       # per-update ladder step ceiling
    min_top_n: int = 0                 # plan floor (0 = pure low-bit)
    max_top_n: int = -1                # plan ceiling (-1 = router top_k)
    rank_fracs: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
    # (the JAX config's budget_scope, for expert-parallel serving, comes
    # with that serving path)

    @property
    def target_bytes_per_token(self) -> float:
        """Resolved budget in bytes/token (0.0 = unconstrained)."""
        if self.bytes_per_token > 0:
            return self.bytes_per_token
        if self.tokens_per_s > 0:
            return self.link_bw / self.tokens_per_s
        return 0.0


@dataclass(frozen=True)
class ServeConfig:
    """The serving knobs the port reads (the JAX ``ServeConfig`` fields
    of the same names and defaults; paging, prefix caching, streaming
    and speculative decoding are not ported yet)."""
    temperature: float = 0.0
    eos_id: int = 1
    cache_experts: int = 4             # device-resident expert cache per layer
    # continuous batching: decode-slot pool size and chunk length (the
    # scheduler refills completed slots between fixed-shape chunks)
    num_slots: int = 4
    chunk_steps: int = 8
    # adaptive top-n restoration under a bandwidth budget; when enabled,
    # ServeEngine.attach_offload attaches the controller
    control: ControlConfig = field(default_factory=ControlConfig)

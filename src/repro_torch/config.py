"""Frozen-dataclass configuration for the PyTorch port.

A copy of the subset of ``repro/config.py`` that the port reads
(``QuantConfig``, ``MoEConfig``, ``EncoderConfig``, ``ModelConfig``,
``ParallelConfig``, ``TrainConfig``, ``ControlConfig``, ``ServeConfig``
and ``RANK_BUCKETS``).  Field names
and defaults match the JAX package, so a config built here describes the
same model as its JAX twin.
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
class EncoderConfig:
    """Encoder tower of an encoder-decoder model (Whisper): its decoder
    layers cross-attend to the tower's output."""
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    source_len: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    """Model description (the fields the port reads)."""
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
    rope_local_theta: float = 0.0      # local layers' theta (0: rope_theta)
    rope_kind: str = "default"         # default | mrope | none
    act: str = "silu"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    post_attn_norm: bool = False
    scale_embed: bool = False
    abs_pos_embed: bool = False        # whisper-style additive sinusoidal
    moe: Optional[MoEConfig] = None
    moe_layer_period: int = 1
    first_layer_dense: bool = False
    gated_ffn: bool = True             # False -> plain 2-matrix MLP
    quant: QuantConfig = field(default_factory=QuantConfig)
    encoder: Optional[EncoderConfig] = None
    # --- recurrent (RG-LRU) ---------------------------------------------
    lru_width: int = 0                 # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4              # temporal conv width in recurrent block
    max_position: int = 524_288
    kv_bits: int = 16                  # 8 = int8 KV cache
    # --- modality frontend stub -------------------------------------------
    frontend: str = "none"             # none | audio_stub | vision_stub
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
class ParallelConfig:
    multi_pod: bool = False
    # logical -> mesh axis rules; tried in order, first divisible rule wins.
    rules: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
        ("batch",      ("pod", "data")),
        ("seq",        ()),               # activation seq (opt-in seq-parallel)
        ("moe_seq",    ("model",)),       # seq sharding inside MoE dispatch
        ("kv_seq",     ("data",)),        # long-context KV sharding
        ("vocab",      ("model",)),
        ("embed",      ()),
        ("heads",      ("model",)),
        ("kv_heads",   ("model",)),
        ("mlp",        ("model",)),
        ("expert",     ("model",)),
        ("expert_mlp", ()),
        ("lowrank",    ()),
        ("conv",       ()),
        ("lru",        ("model",)),
    )
    remat_policy: str = "minimal"      # none | minimal | full
    scan_layers: bool = True
    grad_compress_bits: int = 0        # 0 = off, 8 = int8 compressed psum
    use_shard_map_moe: bool = False    # explicit all_to_all EP path
    donate_state: bool = True

    def rule_for(self, logical: str) -> Tuple[str, ...]:
        for name, axes in self.rules:
            if name == logical:
                return axes
        return ()


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    microbatch: int = 0                # 0 = no accumulation
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    seed: int = 0
    z_loss: float = 1e-4
    loss_chunk: int = 512   # sequence-chunked xent: peak logits = B*chunk*V


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
    # expert-parallel serving: what the bytes/token budget constrains —
    # 'aggregate' sums every shard's link traffic (one shared host link),
    # 'per_shard' budgets the HOTTEST shard's link (per-device links: the
    # slowest link gates decode, so the max is the latency-relevant signal)
    budget_scope: str = "aggregate"    # aggregate | per_shard

    def __post_init__(self):
        assert self.budget_scope in ("aggregate", "per_shard"), \
            self.budget_scope

    @property
    def target_bytes_per_token(self) -> float:
        """Resolved budget in bytes/token (0.0 = unconstrained)."""
        if self.bytes_per_token > 0:
            return self.bytes_per_token
        if self.tokens_per_s > 0:
            return self.link_bw / self.tokens_per_s
        return 0.0


@dataclass(frozen=True)
class StreamConfig:
    """True asynchronous expert streaming (offload/staging.py).

    When enabled, offloaded serving actually *moves* expert bytes: the
    compressed stacks live in a pinned host-memory image, a per-layer
    staging ring issues async H2D copies for every byte the offload
    meter charges, and the decode graph reads device stack containers
    that the streamed payloads are copied into in place (initialized to
    a device-resident ``fallback_bits`` "little expert" copy).

    ``miss_policy``:
      'block'    a chunk that routed to a not-yet-streamed expert stalls,
                 stages it, and re-runs from a cache snapshot — streamed
                 decode is token-identical to the all-resident path;
      'degrade'  never stall: the missed expert is served from the
                 resident low-bit fallback (MoBiLE little-expert
                 semantics) and the affected tokens count as degraded.
    A copy stalled longer than ``stall_timeout_s`` degrades even under
    'block' (a wedged link must not hang decode forever).
    """
    enabled: bool = False
    ring_slots: int = 2                # per-layer staging depth (double buffer)
    miss_policy: str = "block"         # block | degrade
    fallback_bits: int = 2             # resident low-bit fallback width
    stall_timeout_s: float = 5.0       # stalled-copy degrade threshold
    max_reruns: int = 8                # fixpoint re-run bound per chunk

    def __post_init__(self):
        assert self.miss_policy in ("block", "degrade"), self.miss_policy
        assert self.ring_slots >= 1, self.ring_slots


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding (serve/speculative.py).

    ``k`` > 0 turns each serve-loop iteration into a draft/verify round:
    a drafter proposes ``k`` continuations per slot, one batched target
    pass scores all ``k+1`` positions, and rejection sampling keeps a
    per-slot prefix — token-identical to autoregressive decode at
    temperature 0, distribution-preserving otherwise.  The verify pass's
    router trace doubles as the lookahead routing oracle that warms the
    expert stores for not-yet-verified tokens.
    """
    k: int = 0                         # drafted tokens per round (0 = off)
    drafter: str = "ngram"             # ngram | model | self
    ngram_order: int = 3               # longest backoff context is order-1 tokens
    draft_window: int = 32             # model drafter: tail tokens re-read per step

    def __post_init__(self):
        assert self.k >= 0, self.k
        assert self.drafter in ("ngram", "model", "self"), self.drafter
        assert self.ngram_order >= 2, self.ngram_order
        assert self.draft_window >= 1, self.draft_window


@dataclass(frozen=True)
class ServeConfig:
    """The serving knobs the port reads (the JAX ``ServeConfig`` fields
    of the same names and defaults)."""
    temperature: float = 0.0
    eos_id: int = 1
    cache_experts: int = 4             # device-resident expert cache per layer
    # continuous batching: decode-slot pool size and chunk length (the
    # scheduler refills completed slots between fixed-shape chunks)
    num_slots: int = 4
    chunk_steps: int = 8
    # paged KV cache: page_size > 0 (power of two) switches the serve
    # cache's attention layers to block-table paging; prefix_cache
    # additionally refcount-shares physical pages across requests whose
    # prompts share full leading pages (prefill for the shared span runs
    # once)
    page_size: int = 0
    prefix_cache: bool = False
    # adaptive top-n restoration under a bandwidth budget; when enabled,
    # ServeEngine.attach_offload attaches the controller
    control: ControlConfig = field(default_factory=ControlConfig)
    # true async expert streaming; when enabled, attach_offload attaches
    # the transfer engine (it feeds the same byte meters)
    stream: StreamConfig = field(default_factory=StreamConfig)
    # speculative decoding (serve/speculative.py); k = 0 keeps the plain
    # decode loop
    spec: SpecConfig = field(default_factory=SpecConfig)

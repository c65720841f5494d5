"""Config helpers: the reduced smoke-test variant (copy of
``repro/configs/base.py::reduce_config``)."""
from __future__ import annotations

import dataclasses

from ..config import EncoderConfig, ModelConfig


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU tests: few layers, narrow width,
    small vocab/experts; pattern, GQA ratio, MoE-ness, enc-dec and
    recurrence preserved."""
    pat = len(cfg.block_pattern)
    layers = max(pat, 2)
    if cfg.first_layer_dense:
        layers += 1
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv * min(cfg.q_per_kv, 2), 2)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=64,
            d_shared=64 if cfg.moe.d_shared else 0,
            quant=dataclasses.replace(cfg.moe.quant, rank_budget=8,
                                      hqq_iters=3),
        )
    enc = None
    if cfg.encoder is not None:
        enc = EncoderConfig(num_layers=2, d_model=128, num_heads=heads,
                            d_ff=192, source_len=24)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=192 if cfg.d_ff else 0,
        vocab_size=512,
        window_size=min(cfg.window_size, 16),
        lru_width=128 if cfg.lru_width else 0,
        moe=moe,
        encoder=enc,
        quant=dataclasses.replace(cfg.quant, rank_budget=8, hqq_iters=3),
        max_position=4096,
    )

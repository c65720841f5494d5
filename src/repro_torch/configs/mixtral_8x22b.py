"""Mixtral-8x22B (paper reference model, Table 1): 56L hidden (6144,16384),
8 experts top-2.  Paper setting: R_avg=32, top-n=1."""
from ..config import ModelConfig, MoEConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=0, vocab_size=32_768,
        block_pattern=("global",),
        rope_theta=1_000_000.0, act="silu", tie_embeddings=False,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384,
                      router_norm_topk=True,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                                        top_n_restore=1)),
        max_position=65_536,
    )

"""Mixtral-8x7B (paper reference model, Table 1): 32 layers, hidden
(4096, 14336), 8 experts top-2.  Paper setting: R_avg=32, top-n=1,
INT2 + HQQ."""
from ..config import ModelConfig, MoEConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=0, vocab_size=32_000,
        block_pattern=("global",),
        rope_theta=1_000_000.0, act="silu", tie_embeddings=False,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336,
                      router_norm_topk=True,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                                        top_n_restore=1)),
        max_position=32_768,
    )

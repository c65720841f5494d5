"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-3B]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=128_256,
        block_pattern=("global",),
        rope_theta=500_000.0, act="silu", tie_embeddings=True,
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=131_072,
    )

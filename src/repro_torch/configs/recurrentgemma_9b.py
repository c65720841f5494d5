"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) ff=12288
vocab=256000.  Griffin 2-recurrent:1-local-attention pattern, window 2048.
[arXiv:2402.19427]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12288, vocab_size=256_000,
        block_pattern=("recurrent", "recurrent", "local"),
        window_size=2048, lru_width=4096, conv1d_width=4,
        rope_theta=10_000.0, act="gelu_tanh", tie_embeddings=True,
        scale_embed=True,
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=1_048_576,
    )

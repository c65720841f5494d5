"""qwen2-7b [dense]: 28L d=3584 28H (GQA kv=4) ff=18944 vocab=152064.
QKV bias. [arXiv:2407.10671]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab_size=152_064,
        block_pattern=("global",), qkv_bias=True,
        rope_theta=1_000_000.0, act="silu", tie_embeddings=False,
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=131_072,
    )

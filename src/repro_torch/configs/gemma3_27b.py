"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) ff=21504 vocab=262144.
5:1 local:global interleave, 128k context. [hf:google/gemma-3-27b-pt]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=21504, vocab_size=262_144,
        block_pattern=("local",) * 5 + ("global",),
        window_size=1024,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0,
        act="gelu_tanh", tie_embeddings=True, scale_embed=True,
        post_attn_norm=True,
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=131_072,
    )

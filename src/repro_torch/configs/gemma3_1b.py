"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) ff=6912 vocab=262144.
5:1 local:global interleave, 128k context. [hf:google/gemma-3-1b-pt]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1,
        head_dim=256, d_ff=6912, vocab_size=262_144,
        block_pattern=("local",) * 5 + ("global",),
        window_size=512,
        rope_theta=1_000_000.0, rope_local_theta=10_000.0,
        act="gelu_tanh", tie_embeddings=True, scale_embed=True,
        post_attn_norm=True,
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=131_072,
    )

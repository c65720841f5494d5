"""qwen2-vl-7b [vlm]: qwen2-7b backbone + M-RoPE; dynamic-resolution
vision frontend is a STUB (precomputed patch embeddings merged into the
token stream; the caller provides 3xBxS multimodal positions).
[arXiv:2409.12191]"""
from ..config import ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        head_dim=128, d_ff=18944, vocab_size=152_064,
        block_pattern=("global",), qkv_bias=True,
        rope_theta=1_000_000.0, rope_kind="mrope",
        act="silu", tie_embeddings=False, frontend="vision_stub",
        quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                          top_n_restore=1),
        max_position=131_072,
    )

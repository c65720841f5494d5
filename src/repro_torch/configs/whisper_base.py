"""whisper-base [audio]: enc-dec, 6L decoder + 6L encoder, d=512 8H
ff=2048 vocab=51865.  Conv/audio frontend is a STUB: the caller provides
precomputed (B, 1500, 512) frame embeddings.  [arXiv:2212.04356]"""
from ..config import EncoderConfig, ModelConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=51_865,
        block_pattern=("global",), gated_ffn=False, act="gelu",
        rope_kind="none", abs_pos_embed=True, tie_embeddings=True,
        encoder=EncoderConfig(num_layers=6, d_model=512, num_heads=8,
                              d_ff=2048, source_len=1500),
        frontend="audio_stub",
        quant=QuantConfig(enabled=True, bits=3, rank_budget=16,
                          top_n_restore=1),
        max_position=65_536,
    )

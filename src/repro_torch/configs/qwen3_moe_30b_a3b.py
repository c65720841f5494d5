"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) vocab=151936,
128 experts top-8, d_expert=768.  [hf:Qwen/Qwen3-30B-A3B]

Paper technique: full router-guided restoration.  Many-small-experts
regime = the paper's DeepSeek case -> R_avg=64, top-n=3 (paper §4.2)."""
from ..config import ModelConfig, MoEConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=0, vocab_size=151_936,
        block_pattern=("global",),
        rope_theta=1_000_000.0, act="silu", tie_embeddings=False,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=768,
                      router_norm_topk=True,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=64,
                                        top_n_restore=3)),
        max_position=131_072,
    )

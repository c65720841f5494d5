"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) vocab=202048,
16 experts top-1 + 1 shared expert (d=8192), early fusion (frontend stub).
[hf:meta-llama/Llama-4-Scout-17B-16E]

Paper technique: top-k=1 -> n=1 (restore the routed expert); the shared
expert is statically compensated.  Skewed-router regime = Mixtral case."""
from ..config import ModelConfig, MoEConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202_048,
        block_pattern=("global",),
        rope_theta=500_000.0, act="silu", tie_embeddings=False,
        moe=MoEConfig(num_experts=16, top_k=1, d_expert=8192,
                      num_shared_experts=1, d_shared=8192,
                      router_norm_topk=False,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=32,
                                        top_n_restore=1)),
        max_position=131_072,
    )

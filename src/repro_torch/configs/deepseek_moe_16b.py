"""DeepSeek-MoE-16B (paper reference model, Table 1): 28L hidden
(2048, 10944 dense layer-0), 64 routed experts top-6 + 2 shared.
Paper setting: uniform router -> R_avg=64, top-n=3.
[hf:deepseek-ai/deepseek-moe-16b-base config.json]"""
from ..config import ModelConfig, MoEConfig, QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=10944, vocab_size=102_400,
        block_pattern=("global",), first_layer_dense=True,
        rope_theta=10_000.0, act="silu", tie_embeddings=False,
        moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                      num_shared_experts=2, d_shared=1408,
                      router_norm_topk=False,
                      quant=QuantConfig(enabled=True, bits=2, rank_budget=64,
                                        top_n_restore=3)),
        max_position=16_384,
    )

"""xlstm-125m [ssm]: 12L d=768 4H vocab=50304, alternating mLSTM/sLSTM
blocks (self-contained; d_ff=0).  [arXiv:2405.04517]

The paper's technique does not apply (no MoE and no standard FFN
experts): the model runs unquantized, as the JAX package serves it."""
from ..config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        head_dim=192, d_ff=0, vocab_size=50_304,
        block_pattern=("mlstm", "slstm"),
        rope_kind="none", act="gelu", tie_embeddings=True,
        max_position=1_048_576,
    )

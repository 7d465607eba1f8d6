"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 vocab=50304.  d_ff=0 per assignment: mLSTM blocks
use pre-up-projection (proj_factor=2) and carry no separate FFN; every 8th
block is an sLSTM block with a post-up GLU.  Runs long_500k (recurrent, O(1)
state per token).
"""
from repro_torch.configs.base import ModelConfig, register


@register("xlstm-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        mlp_style="none",
        slstm_every=8,
        proj_factor=2.0,
        conv_width=4,
        norm="layernorm",
        tie_embeddings=True,
    )

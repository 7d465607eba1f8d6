"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 2 recurrent : 1 attn.

[arXiv:2402.19427; hf].  26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Local attention window 2048.  Runs long_500k (sub-quadratic).
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn"),
        rnn_width=2560,
        conv_width=4,
        local_window=2048,
        tie_embeddings=True,
        mlp_style="swiglu",
        act="gelu",
        rope_theta=10_000.0,
    )

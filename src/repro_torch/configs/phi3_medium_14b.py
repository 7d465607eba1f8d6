"""phi3-medium-14b — dense RoPE/SwiGLU/GQA. [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("phi3-medium-14b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        mlp_style="swiglu",
        act="silu",
        rope_theta=10_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

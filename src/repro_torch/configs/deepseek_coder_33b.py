"""deepseek-coder-33b — llama-arch dense. [arXiv:2401.14196; hf].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("deepseek-coder-33b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        mlp_style="swiglu",
        act="silu",
        rope_theta=100_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

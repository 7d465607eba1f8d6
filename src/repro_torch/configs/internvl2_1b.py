"""internvl2-1b — InternViT + Qwen2-0.5B-style LM backbone. [arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT vision
frontend is a STUB: input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("internvl2-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        tie_embeddings=True,
        mlp_style="swiglu",
        act="silu",
        rope_theta=1_000_000.0,
        frontend="vlm_stub",
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

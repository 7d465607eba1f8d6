"""smollm-135m — llama-arch small dense model. [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("smollm-135m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        mlp_style="swiglu",
        act="silu",
        rope_theta=10_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

"""moonshot-v1-16b-a3b — kimi/moonlight-style MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf].  Exact assigned dims: 48L d_model=2048
16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("moonshot-v1-16b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        n_experts=64,
        top_k=6,
        moe_every=1,
        n_shared_experts=2,
        mlp_style="swiglu",
        act="silu",
        rope_theta=50_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

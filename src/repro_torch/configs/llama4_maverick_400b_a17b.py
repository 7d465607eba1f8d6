"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].  Assigned dims: 48L
d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.

To match the public ~400B-total/17B-active shape, MoE layers are interleaved
(every 2nd layer, `moe_every=2`) with one shared expert, as in the released
Maverick config; dense layers use the same d_ff.  Total ≈ 397B, active ≈ 17B.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        n_experts=128,
        top_k=1,
        moe_every=2,
        n_shared_experts=1,
        mlp_style="swiglu",
        act="silu",
        rope_theta=500_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

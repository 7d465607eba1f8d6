"""minitron-8b — pruned nemotron (squared-ReLU 2-matrix FFN). [arXiv:2407.14679; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("minitron-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        mlp_style="mlp",
        act="relu2",
        rope_theta=10_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

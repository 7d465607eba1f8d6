"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings; the backbone here is the transformer decoder only.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


@register("musicgen-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        mlp_style="mlp",
        act="gelu",
        norm="layernorm",
        frontend="audio_stub",
        rope_theta=10_000.0,
        skip_cells=("long_500k",),
        skip_reason=FULL_ATTENTION_SKIP,
    )

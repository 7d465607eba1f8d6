"""ibert-base — the paper's own model: integer-only RoBERTa-base encoder.

I-BERT [Kim et al. 2021, arXiv:2101.01321] quantization of RoBERTa-base:
L=12 encoders, A=12 heads, H=768, d_ff=3072, vocab=50265 (RoBERTa), max
sequence length 128 (GLUE).  Bidirectional encoder: no causal mask, no KV
cache — decode cells do not apply; the paper evaluates latency over
sequence lengths 1..128.
"""
from repro_torch.configs.base import ModelConfig, register


@register("ibert-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="ibert-base",
        family="ibert",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=50265,
        mlp_style="mlp",
        act="gelu",
        norm="layernorm",
        causal=False,
        max_seq_len=512,
        skip_cells=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skip_reason=(
            "ibert-base is the paper's own encoder-only model (max seq 512, "
            "no decode step); it runs through launch/ibert_encoder.py, not "
            "the LM shape cells"
        ),
    )

"""Config system of the PyTorch port: its own copy of the JAX package's
``ModelConfig``, registry and ``reduced()``.

The registry maps ``--arch <id>`` names to config factories.  Every config
is a frozen dataclass, hashable and immutable.  ``reduced()`` returns a
small same-family config for CPU tests.  The registry lists the same
architectures as the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Shape cells (assigned input-shape set; same 4 cells for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm | ibert
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    local_window: int = 0  # >0 -> sliding-window attention width
    causal: bool = True

    # mlp
    mlp_style: str = "swiglu"  # swiglu (3 mats) | mlp (2 mats) | none
    act: str = "silu"  # silu | gelu | relu2

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # MoE on layers where (layer % moe_every == moe_every-1)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # hybrid (recurrentgemma): block pattern, e.g. ("rglru","rglru","attn")
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0  # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4

    # xlstm
    slstm_every: int = 0  # 0 = no sLSTM blocks; else every k-th block is sLSTM
    proj_factor: float = 2.0

    # embeddings / io
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    frontend: str = "none"  # none | audio_stub | vlm_stub
    max_seq_len: int = 524_288

    # integer (I-BERT) serving path available for this arch
    int8_path: bool = True

    # shape-cell applicability: cells listed here are skipped (with reason)
    skip_cells: Tuple[str, ...] = ()
    skip_reason: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name

    # -- derived ------------------------------------------------------------

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kind(self, layer: int) -> str:
        """Kind of sequence-mixing block at `layer`."""
        if self.family == "hybrid" and self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        if self.family == "ssm":
            if self.slstm_every and (layer % self.slstm_every == self.slstm_every - 1):
                return "slstm"
            return "mlstm"
        return "attn"

    def is_moe_layer(self, layer: int) -> bool:
        return self.n_experts > 0 and (layer % self.moe_every == self.moe_every - 1)

    # -- parameter counting (analytic; used for MODEL_FLOPS roofline term) --

    def attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def ffn_params(self, d_ff: Optional[int] = None) -> int:
        d_ff = self.d_ff if d_ff is None else d_ff
        if d_ff == 0 or self.mlp_style == "none":
            return 0
        mats = 3 if self.mlp_style == "swiglu" else 2
        return mats * self.d_model * d_ff

    def _recurrent_block_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "rglru":
            w = self.rnn_width or d
            # in/out proj + conv + gates (input & recurrence) + per-channel a
            return 2 * d * w + self.conv_width * w + 2 * w * w + 2 * w
        if kind == "mlstm":
            inner = int(self.proj_factor * d)
            nh = self.n_heads
            ih = inner // nh
            dk = ih // 2
            qkv = nh * (2 * ih * dk + ih * ih)  # block-diagonal per head
            return 2 * d * inner + qkv + inner * d + 3 * inner  # up(z,gate)+qkv+down+gates
        if kind == "slstm":
            nh = self.n_heads
            dh = d // nh
            gates_in = 4 * d * d
            gates_rec = 4 * nh * dh * dh  # block-diagonal recurrent mats
            glu = int(2 * d * (4 * d / 3))  # post-up GLU FFN (factor 4/3)
            return gates_in + gates_rec + glu
        raise ValueError(kind)

    def layer_params(self, layer: int) -> int:
        kind = self.block_kind(layer)
        mix = self.attn_params() if kind == "attn" else self._recurrent_block_params(kind)
        if self.is_moe_layer(layer):
            ffn = self.n_experts * self.ffn_params()
            ffn += self.n_shared_experts * self.ffn_params()
            ffn += self.d_model * self.n_experts  # router
        else:
            ffn = self.ffn_params() if self.family != "ssm" else (
                0 if kind == "mlstm" else 0  # slstm GLU counted inside block
            )
        norms = 2 * self.d_model
        return mix + ffn + norms

    def layer_active_params(self, layer: int) -> int:
        kind = self.block_kind(layer)
        mix = self.attn_params() if kind == "attn" else self._recurrent_block_params(kind)
        if self.is_moe_layer(layer):
            ffn = self.top_k * self.ffn_params()
            ffn += self.n_shared_experts * self.ffn_params()
            ffn += self.d_model * self.n_experts
        else:
            ffn = self.ffn_params() if self.family != "ssm" else 0
        return mix + ffn + 2 * self.d_model

    def embed_params(self) -> int:
        e = self.vocab_size * self.d_model
        return e if self.tie_embeddings else 2 * e

    def param_count(self) -> int:
        return self.embed_params() + sum(self.layer_params(l) for l in range(self.n_layers))

    def active_param_count(self) -> int:
        return self.embed_params() + sum(
            self.layer_active_params(l) for l in range(self.n_layers)
        )

    # -- reduced config for smoke tests --------------------------------------

    def reduced(self) -> "ModelConfig":
        """Small same-family config: runs one fwd/train step on CPU."""
        d = 64
        nh = 4
        nkv = max(1, min(self.n_kv_heads, 2))
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.family in ("hybrid", "ssm") else 2),
            d_model=d,
            n_heads=nh,
            n_kv_heads=nkv,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            head_dim=16,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            rnn_width=d if self.rnn_width else 0,
            max_seq_len=128,
        )
        if self.family == "hybrid":
            kw["n_layers"] = max(kw["n_layers"], len(self.block_pattern))
        if self.slstm_every:
            kw["slstm_every"] = 2
            kw["n_layers"] = 4
        return replace(self, **kw)

    def cells(self) -> List[ShapeCell]:
        return [c for n, c in SHAPE_CELLS.items() if n not in self.skip_cells]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    # every decoder family of the reference, and ibert-base
    from repro_torch.configs import (  # noqa: F401
        deepseek_coder_33b, ibert_base, internvl2_1b,
        llama4_maverick_400b_a17b, minitron_8b, moonshot_v1_16b_a3b,
        musicgen_medium, phi3_medium_14b, recurrentgemma_2b, smollm_135m,
        xlstm_1_3b,
    )

    _LOADED = True


FULL_ATTENTION_SKIP = (
    "long_500k requires sub-quadratic sequence mixing; this arch is pure "
    "full-attention (524k-token KV prefill is quadratic) — skipped per brief, "
    "see DESIGN.md §5"
)

"""Three-term roofline against one NVIDIA H100 (port of
`repro/roofline/analysis.py`, with the card's table in place of the
reference's TPU constants).

  compute    = FLOPs_per_device / peak_FLOP/s_per_card
  memory     = bytes_per_device / HBM_bytes/s_per_card
  collective = collective_bytes_per_device / link_bytes/s_per_card

The table is the published dense peaks of one H100 SXM5 80 GB at its
700 W power limit (NVIDIA's data sheet; a card set to a lower limit runs
slower under load, so a share against these peaks is stated beside the
card's name and limit).  `core/plan_search.HardwareModel` and
`chip_smoke.py`'s kernel bounds read it.

MODEL_FLOPS (analytic useful work) = 6*N_active*tokens for training,
2*N_active*tokens for inference; the ratio MODEL_FLOPS / (FLOPs*cards)
exposes recompute and dispatch waste.  This module is the §9-style
projection the paper performs for Versal: measured proof-of-concept ->
arithmetic estimate on the target part.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

DEVICE = "NVIDIA H100 SXM5 80GB"
POWER_LIMIT_W = 700  # the peaks below assume it
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_INT8 = 1979e12  # dense int8 tensor-core op/s
PEAK_FLOPS_F32 = 67e12  # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
LINK_BW = 450e9  # NVLink 4 bytes/s, one direction (900e9 both)


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_total: float
    chips: int
    dominant: str = ""
    model_flops_ratio: float = 0.0  # useful / counted (x chips)
    roofline_fraction: float = 0.0  # bound_term / sum-ish utilization proxy

    def as_dict(self) -> Dict:
        return self.__dict__.copy()


def model_flops(cfg, cell, tokens: Optional[int] = None) -> float:
    """Analytic useful FLOPs for one step of this (arch, cell).

    Embedding parameters only do real math where the LM head matmul runs:
    every position in training, only the last position in prefill, every
    emitted token in decode."""
    n_act = cfg.active_param_count()
    n_body = n_act - cfg.embed_params()
    head = cfg.vocab_size * cfg.d_model
    if tokens is None:
        if cell.kind in ("train", "prefill"):
            tokens = cell.global_batch * cell.seq_len
        else:  # decode: one new token per sequence
            tokens = cell.global_batch
    if cell.kind == "train":
        flops = 6.0 * (n_body + head) * tokens
    elif cell.kind == "prefill":
        flops = 2.0 * n_body * tokens + 2.0 * head * cell.global_batch
    else:
        flops = 2.0 * (n_body + head) * tokens
    # attention KV term (dominant extra for decode against long caches)
    if cell.kind == "decode":
        s_kv = (min(cell.seq_len, cfg.local_window)
                if cfg.local_window else cell.seq_len)
        attn_layers = sum(1 for i in range(cfg.n_layers)
                          if cfg.block_kind(i) == "attn")
        # scores (2 flops/elt) + PV (2 flops/elt) over the whole cache
        flops += (4.0 * cell.global_batch * s_kv
                  * cfg.n_heads * cfg.head_dim * attn_layers)
    return flops


def analyze(flops_per_device: float, bytes_per_device: float,
            coll_bytes_per_device: float, chips: int,
            model_flops_total: float,
            int8: bool = False) -> RooflineTerms:
    peak = PEAK_FLOPS_INT8 if int8 else PEAK_FLOPS_BF16
    t = RooflineTerms(
        compute_s=flops_per_device / peak,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=coll_bytes_per_device / LINK_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        coll_bytes_per_device=coll_bytes_per_device,
        model_flops_total=model_flops_total,
        chips=chips,
    )
    terms = {"compute": t.compute_s, "memory": t.memory_s,
             "collective": t.collective_s}
    t.dominant = max(terms, key=terms.get)
    compiled_total = flops_per_device * chips
    t.model_flops_ratio = (model_flops_total / compiled_total
                           if compiled_total else 0.0)
    # utilization proxy: useful-compute time / dominant-term time
    useful_s = model_flops_total / (chips * peak)
    bound_s = max(terms.values())
    t.roofline_fraction = useful_s / bound_s if bound_s else 0.0
    return t


def suggest(t: RooflineTerms) -> str:
    """One sentence: what moves the dominant term down on the card."""
    if t.dominant == "compute":
        if t.model_flops_ratio < 0.5:
            return ("compute-bound with low useful-FLOP ratio: cut "
                    "recompute / dead dispatch compute before anything else")
        return ("compute-bound near peak: int8 mma (2x the bf16 tensor-core "
                "rate) or fewer FLOPs (MoE/sparsity) are the only levers")
    if t.dominant == "memory":
        return ("HBM-bound: fuse elementwise chains, keep tiles in shared "
                "memory across a block's steps (bigger kernel tiles, "
                "tensor-core fragments reused from registers), or quantize "
                "weights/KV to int8 to halve bytes")
    return ("collective-bound: reshard to shrink the largest all-gather, "
            "use hierarchical (gateway) schedules across hosts, and overlap "
            "collectives with compute (async, on another stream)")

"""I-BERT encoder — the paper's proof-of-concept model (§7), integer-only.

The port's copy of `repro.models.ibert`.  It mirrors the paper's Fig. 10
six-layer encoder decomposition:
  L0 Linear(QKV)+Quant  L1 Attention Dot-Product  L2 i-Softmax
  L3 Softmax MatMul+Quant (+output Linear+Quant)  L4 Add & i-LayerNorm
  L5 Linear+i-GELU, Linear+Quant                  L6 Add & i-LayerNorm

Activation scales are calibrated offline by a float forward pass that
records each site's amax, so the integer path uses static scales and the
INT8 GEMM fuses its requant epilogue.  The float forward is also the
accuracy oracle.

Trees keep the JAX layout (``"layers": {"0": ...}``, `LNParams` leaves),
so `models.convert.params_from_jax` carries JAX weights across.  Every
scale is a 0-d float32 tensor on the CPU: scale arithmetic is host
metadata, identical whichever device runs the encoder, and the kernels
take scales by value.  Integer weights and the embedding tables live on
the parameters' device.  The integer path runs on `kernels.ops` (the CUDA
kernels for CUDA tensors, their plain versions on the CPU); the attention
products L1 and L3, which the JAX package leaves to XLA, are
`kernels.ref.int_matmul` (exact, through float64).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ibert_ops as iops
from repro_torch.core.quant import QTensor, f32, fdiv, quantize, requantize
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import int_matmul

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# float parameters & forward (calibration + oracle)
# ---------------------------------------------------------------------------


def init_ibert_params(cfg: ModelConfig, seed: int = 0,
                      device="cuda") -> Params:
    """Random float parameters in the JAX layout, drawn from a CPU
    torch.Generator and moved to `device`, so one seed gives the same
    weights on every device: normal weights scaled 1/sqrt(d_in), zero
    biases, embeddings 0.02, LayerNorm gains 1 (other numbers than
    jax.random gives from the same seed)."""
    d, f, v, m = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq_len
    gen = torch.Generator()
    gen.manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * scale).to(device)

    def lin(d_in, d_out):
        return {"w": normal((d_in, d_out), d_in ** -0.5),
                "b": torch.zeros((d_out,), device=device)}

    def ln():
        return {"g": torch.ones((d,), device=device),
                "b": torch.zeros((d,), device=device)}

    layers = {}
    for i in range(cfg.n_layers):
        layers[str(i)] = {
            "wq": lin(d, d), "wk": lin(d, d), "wv": lin(d, d), "wo": lin(d, d),
            "ln1": ln(), "w1": lin(d, f), "w2": lin(f, d), "ln2": ln(),
        }
    return {"tok": normal((v, d), 0.02), "pos": normal((m, d), 0.02),
            "emb_ln": ln(), "layers": layers}


def _f_ln(x: torch.Tensor, p: Params) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-12) * p["g"] + p["b"]


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    s = tokens.shape[1]
    h = params["tok"][tokens.long()] + params["pos"][:s][None]
    return _f_ln(h, params["emb_ln"])


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, S, D) -> (B, nh, S, D // nh)."""
    b, s, d = x.shape
    return x.reshape(b, s, nh, d // nh).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, nh, S, hd) -> (B, S, nh * hd)."""
    b, nh, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * hd)


def ibert_float_forward(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        record: Optional[Dict[str, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """Float oracle. `record` (if a dict) collects per-site amax for
    calibration."""

    def rec(name, x):
        if record is not None:
            record[name] = x.abs().max()
        return x

    b, s = tokens.shape
    h = rec("emb", _embed(params, tokens))
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=h.device)
    amask = mask[:, None, None, :]

    for i in range(cfg.n_layers):
        lp = params["layers"][str(i)]
        q = rec(f"L{i}.q", h @ lp["wq"]["w"] + lp["wq"]["b"])
        k = rec(f"L{i}.k", h @ lp["wk"]["w"] + lp["wk"]["b"])
        v = rec(f"L{i}.v", h @ lp["wv"]["w"] + lp["wv"]["b"])
        scores = rec(f"L{i}.scores", fdiv(
            _heads(q, nh) @ _heads(k, nh).transpose(-1, -2), math.sqrt(hd)))
        scores = torch.where(amask, scores, -1e30)
        ctx = torch.softmax(scores, -1) @ _heads(v, nh)
        ctx = rec(f"L{i}.ctx", _merge(ctx))
        attn = rec(f"L{i}.attn", ctx @ lp["wo"]["w"] + lp["wo"]["b"])
        h = rec(f"L{i}.res1", h + attn)
        h = rec(f"L{i}.ln1", _f_ln(h, lp["ln1"]))
        ff = rec(f"L{i}.ff1", h @ lp["w1"]["w"] + lp["w1"]["b"])
        ff = rec(f"L{i}.gelu", iops.f_gelu(ff))
        ff = rec(f"L{i}.ff2", ff @ lp["w2"]["w"] + lp["w2"]["b"])
        h = rec(f"L{i}.res2", h + ff)
        h = rec(f"L{i}.ln2", _f_ln(h, lp["ln2"]))
    return h


def calibrate(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    record: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        ibert_float_forward(params, cfg, tokens, mask, record)
    return {k: torch.clamp(v, min=1e-3) for k, v in record.items()}


# ---------------------------------------------------------------------------
# integer parameter preparation
# ---------------------------------------------------------------------------


def _scale_of(amax) -> torch.Tensor:
    return fdiv(f32(amax), 127.0)


def _cpu_ln(prep: iops.LNParams) -> iops.LNParams:
    return prep._replace(s_gamma=prep.s_gamma.cpu(), s_out=prep.s_out.cpu())


def _q_lin(lin: Params, s_in: torch.Tensor) -> Params:
    """int8 weight (K, N) at its scale, and the int32 bias.  The weight
    keeps the reference's shape and values but is stored column-major
    (``w.t()`` contiguous): the int8_matmul kernel reads it K-major as it
    is, so the encoder's path takes no transposing copy."""
    w = quantize(lin["w"])
    b_int = torch.round(fdiv(lin["b"], s_in.to(w.scale.device) * w.scale))
    return {"w": w.values.t().contiguous().t(), "s_w": w.scale.cpu(),
            "b": b_int.to(torch.int32)}


def quantize_ibert(params: Params, cfg: ModelConfig,
                   act: Dict[str, torch.Tensor]) -> Params:
    """Float params + calibrated amaxes -> integer weights & static
    scales (scales and `act` on the CPU)."""
    act = {k: f32(v).cpu() for k, v in act.items()}
    qp: Params = {
        "tok": params["tok"], "pos": params["pos"], "emb_ln": params["emb_ln"],
        "s_emb": _scale_of(act["emb"]), "layers": {}, "act": act,
    }
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp = params["layers"][str(i)]
            s_in = _scale_of(act["emb"] if i == 0 else act[f"L{i-1}.ln2"])
            s_ln1 = _scale_of(act[f"L{i}.ln1"])
            qp["layers"][str(i)] = {
                "wq": _q_lin(lp["wq"], s_in),
                "wk": _q_lin(lp["wk"], s_in),
                "wv": _q_lin(lp["wv"], s_in),
                "wo": _q_lin(lp["wo"], _scale_of(act[f"L{i}.ctx"])),
                "w1": _q_lin(lp["w1"], s_ln1),
                "w2": _q_lin(lp["w2"], _scale_of(act[f"L{i}.gelu"])),
                "ln1": _cpu_ln(iops.layernorm_prepare(lp["ln1"]["g"],
                                                      lp["ln1"]["b"])),
                "ln2": _cpu_ln(iops.layernorm_prepare(lp["ln2"]["g"],
                                                      lp["ln2"]["b"])),
            }
    return qp


# ---------------------------------------------------------------------------
# integer forward (runs on the kernels)
# ---------------------------------------------------------------------------


def _mm(x: QTensor, ql: Params, s_out: torch.Tensor) -> QTensor:
    """int8 GEMM + bias + requant to s_out over collapsed leading dims."""
    lead = x.values.shape[:-1]
    a2 = x.values.reshape(-1, x.values.shape[-1])
    out = kops.int8_matmul(a2, ql["w"], x.scale, ql["s_w"], s_out=s_out,
                           bias=ql["b"])
    return QTensor(out.reshape(*lead, -1), s_out)


def _residual(a: QTensor, b: QTensor, s_res: torch.Tensor) -> torch.Tensor:
    """Both branches requantized to one scale and added (|r| <= 254)."""
    return (requantize(a.values.to(torch.int32), a.scale, s_res)
            .to(torch.int32)
            + requantize(b.values.to(torch.int32), b.scale, s_res)
            .to(torch.int32))


def ibert_embed(qp: Params, tokens: torch.Tensor) -> QTensor:
    """The float embedding block and the int8 entry point of the encoder
    (paper §2.3: embedding runs on the input-preprocessing FPGAs)."""
    with torch.no_grad():
        return quantize(_embed(qp, tokens), scale=qp["s_emb"])


def ibert_encode(qp: Params, cfg: ModelConfig, x: QTensor,
                 mask: Optional[torch.Tensor] = None,
                 trace: Optional[Dict[str, torch.Tensor]] = None) -> QTensor:
    """The integer encoder stack from the int8 entry tensor; returns the
    final hidden state as a QTensor.  `trace` (if a dict) receives each
    site's integer tensor, in order, under names like ``"L3.probs"``."""
    b, s = x.values.shape[:2]
    act = qp["act"]
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    dev = x.values.device
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.bool, device=dev)

    def site(name, t):
        if trace is not None:
            trace[name] = t
        return t

    def sc(name):
        return _scale_of(act[name])

    for i in range(cfg.n_layers):
        ql = qp["layers"][str(i)]
        s_q, s_k, s_v = sc(f"L{i}.q"), sc(f"L{i}.k"), sc(f"L{i}.v")
        q = _mm(x, ql["wq"], s_q)
        k = _mm(x, ql["wk"], s_k)
        v = _mm(x, ql["wv"], s_v)
        site(f"L{i}.q", q.values)
        site(f"L{i}.k", k.values)
        site(f"L{i}.v", v.values)

        # L1: attention dot-product (int8 x int8 -> int32)
        scores = int_matmul(_heads(q.values, nh),
                            _heads(k.values, nh).transpose(-1, -2))
        s_scores = fdiv(s_q * s_k, math.sqrt(hd))  # fold 1/sqrt(hd) in
        # requant scores to ACT_BITS for the i-softmax polynomial (static)
        s_sm_in = sc(f"L{i}.scores") * (127.0 / iops.ACT_QMAX)
        sc_q = torch.clamp(torch.round(scores.float()
                                       * fdiv(s_scores, s_sm_in)),
                           -iops.ACT_QMAX, iops.ACT_QMAX).to(torch.int32)
        fill = int(torch.floor(fdiv(iops._EXP_CLAMP, s_sm_in)))
        sc_q = site(f"L{i}.scores",
                    torch.where(mask[:, None, None, :], sc_q, fill))
        # L2: i-softmax
        probs = kops.i_softmax(sc_q.reshape(-1, s), s_sm_in)
        probs = site(f"L{i}.probs", probs.reshape(b, nh, s, s))
        # probs at 2^-14 -> int8 at 2^-7 (128 wraps to -128, as in JAX)
        p8 = (probs >> 7).to(torch.int8)
        s_p = f32(2.0 ** -7)
        # L3: softmax matmul (int8 probs x int8 v)
        ctx = int_matmul(p8, _heads(v.values, nh))
        s_ctx = sc(f"L{i}.ctx")
        ctx8 = site(f"L{i}.ctx", _merge(requantize(ctx, s_p * s_v, s_ctx)))
        attn = _mm(QTensor(ctx8, s_ctx), ql["wo"], sc(f"L{i}.attn"))
        site(f"L{i}.attn", attn.values)

        # L4: residual add (common scale) + i-LayerNorm
        r = _residual(x, attn, sc(f"L{i}.res1"))
        ln1, s_ln1v = kops.i_layernorm(r, ql["ln1"])
        x = QTensor(requantize(ln1, s_ln1v, sc(f"L{i}.ln1")), sc(f"L{i}.ln1"))
        site(f"L{i}.ln1", x.values)

        # L5: FFN with i-GELU
        s_ff1 = (torch.clamp(sc(f"L{i}.ff1"), min=1e-6)
                 * (127.0 / iops.ACT_QMAX))
        acc = kops.int8_matmul(x.values.reshape(-1, cfg.d_model),
                               ql["w1"]["w"], x.scale, ql["w1"]["s_w"],
                               bias=ql["w1"]["b"])
        ratio = fdiv(x.scale * ql["w1"]["s_w"], s_ff1)
        ff = torch.clamp(torch.round(acc.float() * ratio), -iops.ACT_QMAX,
                         iops.ACT_QMAX).to(torch.int32)
        g = site(f"L{i}.gelu", kops.i_gelu(ff, s_ff1))
        _, s_g = iops.i_gelu(torch.zeros((1,), dtype=torch.int32), s_ff1)
        g8 = requantize(g, s_g, sc(f"L{i}.gelu")).reshape(b, s, cfg.d_ff)
        ff2 = _mm(QTensor(g8, sc(f"L{i}.gelu")), ql["w2"], sc(f"L{i}.ff2"))
        site(f"L{i}.ff2", ff2.values)

        # L6: residual + i-LayerNorm
        r2 = _residual(x, ff2, sc(f"L{i}.res2"))
        ln2, s_ln2v = kops.i_layernorm(r2, ql["ln2"])
        x = QTensor(requantize(ln2, s_ln2v, sc(f"L{i}.ln2")), sc(f"L{i}.ln2"))
        site(f"L{i}.ln2", x.values)
    return x


def ibert_int_forward(qp: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      trace: Optional[Dict[str, torch.Tensor]] = None
                      ) -> QTensor:
    """Integer-only encoder; returns the final hidden state as a QTensor.
    Per layer it launches int8_matmul 6 times, i_softmax once,
    i_layernorm twice and i_gelu once."""
    return ibert_encode(qp, cfg, ibert_embed(qp, tokens), mask, trace)

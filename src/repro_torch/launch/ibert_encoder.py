"""Integer I-BERT encoder CLI of the PyTorch port: the paper's proof of
concept end to end (§7/§8), the counterpart of `examples/ibert_encoder.py`.

Builds ibert-base at full width with random float weights from `--seed`,
calibrates on a seeded batch at sequence length 128, quantizes, and runs
the INTEGER encoder on the port's kernels.  Prints the integer-vs-float
error on the calibration batch, then for each sequence length the median
time of one integer forward, the time per encoder, and the paper's Eq. 1
estimate for a 12-encoder pipeline (X = 0.5325 T, d = 1.1 us, as in the
example).

Runs on the CUDA device unless ``--device cpu`` is given (the kernels'
plain PyTorch versions); without a card it stops with an error instead
of falling back to the CPU.

  PYTHONPATH=src python -m repro_torch.launch.ibert_encoder
  PYTHONPATH=src python -m repro_torch.launch.ibert_encoder --device cpu \\
      --layers 1 --seq-lens 8
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.latency_model import StageTiming, total_latency
from repro_torch.models import ibert as ib

CALIB_SEQ = 128
X_FRACTION = 0.5325  # time to first output over T (paper §9)
HOP_S = 1.1e-6  # inter-cluster switch hop d
REPS = 5  # timed forwards per sequence length (median)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.ibert_encoder")
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq-lens", default="1,8,32,64,128",
                    help="comma-separated sequence lengths to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the kernels' plain "
                         "PyTorch versions")
    return ap.parse_args(argv)


def make_tokens(cfg, batch: int, seq: int, seed: int,
                device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return torch.tensor(toks, device=device)


def build(args: argparse.Namespace):
    """ibert-base at full width and `args.layers` deep: float params from
    the seed, calibrated at seq 128, quantized.  Returns (cfg, params,
    qp, calibration tokens)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ibert_encoder: no CUDA device is available; pass "
                         "--device cpu to run the plain PyTorch path")
    cfg = dataclasses.replace(get_config("ibert-base"), n_layers=args.layers)
    params = ib.init_ibert_params(cfg, seed=args.seed, device=device)
    toks = make_tokens(cfg, args.batch, CALIB_SEQ, args.seed, device)
    qp = ib.quantize_ibert(params, cfg, ib.calibrate(params, cfg, toks))
    return cfg, params, qp, toks


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_forward(qp, cfg, toks: torch.Tensor) -> float:
    """Median wall seconds of REPS integer forwards (after one warm-up),
    each ended by a device synchronize."""
    times = []
    with torch.no_grad():
        for i in range(REPS + 1):
            sync(toks.device)
            t0 = time.perf_counter()
            ib.ibert_int_forward(qp, cfg, toks)
            sync(toks.device)
            if i:
                times.append(time.perf_counter() - t0)
    return statistics.median(times)


def int_vs_float(params, qp, cfg, toks) -> Dict[str, float]:
    with torch.no_grad():
        out_f = ib.ibert_float_forward(params, cfg, toks)
        out_i = ib.ibert_int_forward(qp, cfg, toks).dequantize()
    err = (out_i - out_f).abs()
    return {"max": err.max().item(), "mean": err.mean().item(),
            "std": out_f.std().item()}


def main(argv=None) -> Dict[str, object]:
    args = parse_args(argv)
    cfg, params, qp, toks = build(args)
    print(f"ibert-base x{cfg.n_layers} on {toks.device}: calibrated "
          f"{len(qp['act'])} activation sites")
    e = int_vs_float(params, qp, cfg, toks)
    print(f"integer vs float: max={e['max']:.4f} mean={e['mean']:.4f} "
          f"(float std {e['std']:.3f})")
    print("\nseq_len  forward(ms)  T_encoder(ms)  Eq.1 12-encoder "
          "estimate(ms)")
    rows: List[Dict[str, float]] = []
    for s in (int(x) for x in args.seq_lens.split(",")):
        t_in = make_tokens(cfg, args.batch, s, args.seed + s, toks.device)
        t = time_forward(qp, cfg, t_in)
        t_enc = t / cfg.n_layers
        full = total_latency(StageTiming(T=t_enc, X=X_FRACTION * t_enc,
                                         d=HOP_S), 12)
        print(f"{s:7d}  {t * 1e3:11.3f}  {t_enc * 1e3:13.3f}  "
              f"{full * 1e3:10.3f}")
        rows.append({"seq": s, "forward_ms": t * 1e3,
                     "encoder_ms": t_enc * 1e3, "eq1_ms": full * 1e3})
    return {"error": e, "times": rows}


if __name__ == "__main__":
    main()

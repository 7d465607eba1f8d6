"""`fit_affine_lm` at its defaults (1,000 Adam steps) on smollm-135m at full
width (vocab 49,152), on the card: the measurement behind running the
card's stream gate on the reduced config (PERF.md).  Torch only.

    PYTHONPATH=src python tests/fit_full_width.py [--device cuda]

Prints the fit's seconds, its loss on a held-out batch and its greedy
accuracy on 64 affine prompts, as chip_smoke.py's fit phase does for the
reduced config.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import synthetic
from repro_torch.models.transformer import make_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device
    model = make_model(get_config("smollm-135m"), device=dev)
    vocab = model.cfg.vocab_size
    t0 = time.perf_counter()
    params = synthetic.fit_affine_lm(model)
    if dev == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    toks, labels = synthetic.affine_batch(np.random.default_rng(99), vocab,
                                          device=dev)
    with torch.no_grad():
        loss = float(model.loss(params, {"tokens": toks, "labels": labels}))
    acc = synthetic.greedy_accuracy(model, params, synthetic.affine_prompts(
        np.random.default_rng(123), 64, vocab))
    print(f"fit smollm-135m full width (vocab {vocab}): 1000 steps in "
          f"{secs:.1f} s, held-out loss={loss:.5f}, greedy accuracy on 64 "
          f"affine prompts={acc:.4f}", flush=True)


if __name__ == "__main__":
    main()

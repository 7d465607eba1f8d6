"""Deterministic synthetic-task fitting for accuracy-sensitive runs (port of
`repro/models/synthetic.py`).

A random-init model is the wrong instrument for comparing greedy token
streams across numerics: its top-2 logit gaps cluster near zero, so any
sub-percent perturbation (int8 KV noise, or only another summation order
on another device) flips some greedy steps and the streams part for good.
`fit_affine_lm` trains a model on an *affine-cycle* corpus — each
sequence follows ``t[i+1] = (t[0] + step * (i+1)) % vocab`` with a
per-sequence step — until it predicts confidently.  The step is only
recoverable from two consecutive tokens, so the model must read its KV
cache at decode time.  In-distribution prompts come from
`affine_prompts`; `greedy_accuracy` scores a fit on them.

The numpy draws are the reference's, call for call, so the same seed gives
the same corpus and prompts.  The update is the reference's plain Adam
(f32 moments, betas 0.9 / 0.99, bias correction, eps 1e-8 after the
sqrt), with gradients from torch.autograd through `Model.loss` at S = 32,
the dense attention route (no kernel).  Every family of the port fits
this way: recurrent blocks (RG-LRU, mLSTM, sLSTM) differentiate through
their plain torch forms, as the reference's through its jnp ones.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

STEP_RANGE = (1, 13)  # per-sequence affine steps drawn from [1, 13)

_FIT_CACHE: Dict[Tuple, object] = {}


def affine_batch(rng: np.random.Generator, vocab: int, batch: int = 16,
                 seq: int = 32, disagree_every: int = 0,
                 disagree_delta: int = 1, device="cpu"):
    """(tokens, labels) minibatch of affine cycles, (batch, seq) int64
    tensors on `device`.

    disagree_every=E > 0 deviates the corpus: any token whose clean affine
    value is = 0 (mod E) is replaced by value + disagree_delta.  The rule
    is a function of the predicted value, not of the position, so a model
    fits it as easily as the clean task; two models fitted with different
    E then disagree on ~1/E of greedy steps, which is how a speculative
    draft's agreement with its target is dialled."""
    t0 = rng.integers(0, vocab, (batch, 1))
    step = rng.integers(*STEP_RANGE, (batch, 1))
    toks = (t0 + step * np.arange(seq + 1)) % vocab
    if disagree_every:
        toks = np.where(toks % disagree_every == 0,
                        (toks + disagree_delta) % vocab, toks)
    toks = torch.as_tensor(toks, dtype=torch.int64, device=device)
    return toks[:, :-1], toks[:, 1:]


def affine_prompts(rng: np.random.Generator, n: int, vocab: int,
                   len_range: Tuple[int, int] = (6, 20)) -> List[np.ndarray]:
    """n in-distribution prompts (each its own start token and step)."""
    out = []
    for _ in range(n):
        t0 = int(rng.integers(0, vocab))
        step = int(rng.integers(*STEP_RANGE))
        ln = int(rng.integers(*len_range))
        out.append(((t0 + step * np.arange(ln)) % vocab).astype(np.int32))
    return out


def _leaves(tree, out: list) -> list:
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """f32(a) * x + y rounded once, as the reference's compiled step
    contracts each moment update into one fused multiply-add: the f32
    product is exact in f64."""
    a = float(np.float32(a))
    return (x.double() * a + y.double()).float()


def _autograd(model, params, leaves, tokens, labels):
    loss = model.loss(params, {"tokens": tokens, "labels": labels})
    return torch.autograd.grad(loss, leaves)


def _fit(model, params, steps: int, lr: float, seed: int,
         disagree_every: int = 0, disagree_delta: int = 1,
         grad_fn=_autograd):
    """`steps` Adam steps on the affine corpus drawn from `seed`, from the
    given starting params (left untouched); returns the fitted params.
    grad_fn(model, params, leaves, tokens, labels) gives the gradients of
    the loss, one per leaf (torch.autograd through `Model.loss`)."""
    params = _map(lambda w: w.detach().clone().requires_grad_(True), params)
    leaves = _leaves(params, [])
    m = [torch.zeros_like(w, dtype=torch.float32) for w in leaves]
    v = [torch.zeros_like(w, dtype=torch.float32) for w in leaves]
    rng = np.random.default_rng(seed)
    one = np.float32(1)
    for i in range(1, steps + 1):
        t, lab = affine_batch(rng, model.cfg.vocab_size,
                              disagree_every=disagree_every,
                              disagree_delta=disagree_delta,
                              device=model.device)
        grads = grad_fn(model, params, leaves, t, lab)
        # the bias corrections in f32, as the reference's jitted step
        # computes them from its f32 step count
        c1 = float(one - np.float32(0.9) ** np.float32(i))
        c2 = float(one - np.float32(0.99) ** np.float32(i))
        with torch.no_grad():
            for w, g, mi, vi in zip(leaves, grads, m, v):
                g = g.float()
                mi.copy_(_fma(0.9, mi, 0.1 * g))
                vi.copy_(_fma(0.99, vi, 0.01 * torch.square(g)))
                upd = lr * (mi / c1) / (torch.sqrt(vi / c2) + 1e-8)
                w.copy_((w.float() - upd).to(w.dtype))
    return _map(lambda w: w.detach(), params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def fit_affine_lm(model, steps: int = 1000, lr: float = 1e-2, seed: int = 0,
                  disagree_every: int = 0, disagree_delta: int = 1):
    """Fit `model` (a transformer.Model) to the affine-cycle task from
    `init_params(cfg, seed=seed)` on the model's device.

    The result is cached per process under (config name, device, steps,
    lr, seed, disagreement): every caller wants the same fitted
    instrument.  `disagree_every` deviates the corpus (see
    `affine_batch`), so a draft can be fitted to agree with a
    clean-fitted target on a controllable share of greedy steps.
    """
    key = (model.cfg.name, str(model.device), steps, lr, seed,
           disagree_every, disagree_delta)
    if key not in _FIT_CACHE:
        from repro_torch.models.transformer import init_params

        params = init_params(model.cfg, seed=seed, device=model.device)
        # every activation kept: at S = 32 remat saves nothing, and its
        # gradients are the same bits (tests/test_torch_train.py)
        plain = type(model)(model.cfg, model.device, remat=False)
        _FIT_CACHE[key] = _fit(plain, params, steps, lr, seed,
                               disagree_every, disagree_delta)
    return _FIT_CACHE[key]


def greedy_accuracy(model, params, prompts) -> float:
    """Share of next tokens that greedy decoding gets right inside the
    affine prompts: each position from the second on (two tokens fix the
    step) predicts the one after it, read off one `forward_logits` of the
    prompt."""
    hit = total = 0
    with torch.no_grad():
        for p in prompts:
            toks = torch.as_tensor(np.asarray(p)[None], dtype=torch.int64,
                                   device=model.device)
            pred = model.forward_logits(params, toks)[0].argmax(-1)
            want = toks[0, 2:]
            hit += int((pred[1:-1] == want).sum())
            total += want.numel()
    return hit / max(total, 1)

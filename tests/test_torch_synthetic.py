"""The port's synthetic-task fitting (`repro_torch.models.synthetic`)
against the JAX package's, on reduced smollm-135m on the CPU.

* The numpy draws (`affine_batch`, `affine_prompts`) equal the
  reference's arrays exactly, over seeds and `disagree_every`.
* Gradients at JAX's initial weights: the port's autograd through
  `Model.loss` agrees with `jax.grad` within 2^-5 of each leaf's largest
  gradient (a few bf16 ulps; the two packages sum in other orders).
* Adam: driven by JAX's own gradients, the port's update reproduces
  `repro.models.synthetic.fit_affine_lm` bit for bit after one step, and
  after two everywhere but in the tied embedding, where at most a tenth
  of the weights part by at most lr / 32 (the reference's compiled step
  keeps that leaf's gradient in f32, XLA's excess precision; the port
  rounds it to the leaf's bf16).  Past that the fits part:
  Adam's first steps move every weight by ~lr whatever the gradient's
  size, so a weight whose gradient is near zero flips its step's sign on
  any rounding difference, and later gradients inherit the flips.  After
  five steps each leaf's mean |difference| stays within lr / 20 on JAX's
  gradients, and within lr / 2 on the port's own (2.6e-3 to 4.0e-3 at
  seed 0, against a mean movement of 2.2e-2 from the start; a fit at
  20% more or less lr parts by more than lr / 2).  The port's fitted
  weights also give JAX's loss on a held-out batch within 5e-3.
* 300 steps: the port's own fit (its own initial draws) reaches a
  held-out greedy accuracy within 0.12 of the JAX fit's, either way.  The
  fit is chaotic in its start and its rounding: over seeds 0-9
  (tests/fit_seed_sweep.py) JAX's accuracy ranged 0.652-0.860 and the
  port's signed gap was +0.045, +0.081, +0.021, -0.093, -0.110, +0.030,
  -0.099, +0.035, +0.040, +0.021 (mean -0.003); started from JAX's own
  initial weights the gaps were -0.118 to +0.062 (mean -0.001).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import synthetic as jsyn
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.models import synthetic as tsyn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import make_model as tmake

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
LR = 1e-2


@pytest.fixture(scope="module")
def models():
    return jmake(CFG, remat=False), tmake(tget("smollm-135m").reduced(),
                                          device="cpu")


def _conv(p):
    return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


@pytest.mark.parametrize("seed,disagree_every",
                         [(s, e) for s in (0, 7) for e in (0, 2, 3)])
def test_affine_draws_match_jax(seed, disagree_every):
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):  # consecutive draws stay in step
        jt, jl = jsyn.affine_batch(jr, CFG.vocab_size,
                                   disagree_every=disagree_every)
        tt, tl = tsyn.affine_batch(tr, CFG.vocab_size,
                                   disagree_every=disagree_every)
        assert tt.dtype == torch.int64 and tuple(tt.shape) == (16, 32)
        assert np.array_equal(np.asarray(jt), tt.numpy())
        assert np.array_equal(np.asarray(jl), tl.numpy())
    jp = jsyn.affine_prompts(jr, 5, CFG.vocab_size, (3, 9))
    tp = tsyn.affine_prompts(tr, 5, CFG.vocab_size, (3, 9))
    assert all(a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
               for a, b in zip(jp, tp))


def test_gradients_match_jax(models):
    jm, tm = models
    p0 = jinit(CFG, jax.random.PRNGKey(0))
    t, lab = jsyn.affine_batch(np.random.default_rng(0), CFG.vocab_size)
    jg = jax.grad(lambda p: jm.loss(p, {"tokens": t, "labels": lab}))(p0)
    params = tsyn._map(lambda w: w.requires_grad_(True), _conv(p0))
    leaves = tsyn._leaves(params, [])
    tg = tsyn._autograd(tm, params, leaves, torch.tensor(np.asarray(t)),
                        torch.tensor(np.asarray(lab)))
    for want, got in zip(tsyn._leaves(_conv(jg), []), tg):
        assert got.dtype == want.dtype and got.shape == want.shape
        bound = 2 ** -5 * want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= bound


def _jax_grads(jm, p0):
    """grad_fn for the port's `_fit` that returns JAX's gradients at the
    port's current weights."""
    treedef = jax.tree.structure(p0)
    dtypes = [x.dtype for x in jax.tree.leaves(p0)]
    grad = jax.jit(jax.grad(
        lambda p, t, lab: jm.loss(p, {"tokens": t, "labels": lab})))

    def fn(model, params, leaves, tokens, labels):
        jp = jax.tree.unflatten(treedef, [
            jnp.asarray(w.detach().float().numpy()).astype(d)
            for w, d in zip(leaves, dtypes)])
        g = grad(jp, jnp.asarray(tokens.numpy()), jnp.asarray(
            labels.numpy()))
        return tsyn._leaves(_conv(g), [])

    return fn


@pytest.mark.parametrize("grads,steps", [("jax", 1), ("jax", 2),
                                         ("jax", 5), ("port", 5)])
def test_adam_steps_match_jax_fit(models, grads, steps):
    jm, tm = models
    p0 = jinit(CFG, jax.random.PRNGKey(0))  # fit_affine_lm's start, seed 0
    want = jsyn.fit_affine_lm(jm, steps=steps)
    kw = {"grad_fn": _jax_grads(jm, p0)} if grads == "jax" else {}
    got = tsyn._fit(tm, _conv(p0), steps, LR, 0, **kw)
    pairs = list(zip(tsyn._leaves(_conv(want), []),
                     tsyn._leaves(got, [])))
    assert all(g.dtype == w.dtype for w, g in pairs)
    if grads == "port":
        t, lab = jsyn.affine_batch(np.random.default_rng(99),
                                   CFG.vocab_size)
        with torch.no_grad():
            tl = tm.loss(got, {"tokens": torch.tensor(np.asarray(t)),
                               "labels": torch.tensor(np.asarray(lab))})
        jl = jm.loss(want, {"tokens": t, "labels": lab})
        assert abs(float(tl) - float(jl)) <= 5e-3
    for i, (w, g) in enumerate(pairs):
        d = (g.float() - w.float()).abs()
        if grads == "port":
            assert d.mean() <= LR / 2, i
        elif steps == 1 or (steps == 2 and i > 0):
            assert torch.equal(g, w), i
        elif steps == 2:  # the tied embedding (leaf 0): its f32 gradient
            assert d.max() <= LR / 32 and (d > 0).float().mean() <= 0.1
        else:
            assert d.mean() <= LR / 20, i


@pytest.mark.parametrize("lr", [0.8 * LR, 1.2 * LR])
def test_adam_bound_catches_a_wrong_lr(models, lr):
    """The lr / 2 bound on the port's own 5-step fit has teeth: a fit at
    20% more or less lr parts from JAX's by more in every leaf."""
    jm, tm = models
    p0 = jinit(CFG, jax.random.PRNGKey(0))
    want = tsyn._leaves(_conv(jsyn.fit_affine_lm(jm, steps=5)), [])
    got = tsyn._leaves(tsyn._fit(tm, _conv(p0), 5, lr, 0), [])
    assert all((g.float() - w.float()).abs().mean() > LR / 2
               for w, g in zip(want, got))


def test_fit_accuracy_matches_jax_fit(models):
    jm, tm = models
    prompts = tsyn.affine_prompts(np.random.default_rng(123), 64,
                                  CFG.vocab_size)
    got = tsyn.fit_affine_lm(tm, steps=300)
    assert tsyn.fit_affine_lm(tm, steps=300) is got  # cached per process
    acc = tsyn.greedy_accuracy(tm, got, prompts)
    want = tsyn.greedy_accuracy(tm, _conv(jsyn.fit_affine_lm(jm, steps=300)),
                                prompts)
    assert abs(acc - want) <= 0.12, (acc, want)
    assert acc > 0.5  # well above chance (1/256): the fit learned the task

"""How far 300-step affine fits part between the port and the JAX package,
seed by seed, on reduced smollm-135m on the CPU: the readings behind the
accuracy bound of tests/test_torch_synthetic.py.

    PYTHONPATH=src python tests/fit_seed_sweep.py [SEED ...]   # default 0-9

Prints, per seed, the held-out greedy accuracy (64 affine prompts from
seed 123) of the JAX fit, of the port's own fit (its own initial draws)
and of the port's fit from JAX's initial weights, and the signed gaps to
JAX's.  About 25 s a seed.
"""
import sys

import numpy as np
import torch

import jax

from repro.configs import get_config
from repro.models import synthetic as jsyn
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.models import synthetic as tsyn
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import make_model as tmake


def main(seeds):
    torch.set_num_threads(1)
    cfg = get_config("smollm-135m").reduced()
    jm = jmake(cfg, remat=False)
    tm = tmake(tget("smollm-135m").reduced(), device="cpu")
    prompts = tsyn.affine_prompts(np.random.default_rng(123), 64,
                                  cfg.vocab_size)

    def acc(params):
        return tsyn.greedy_accuracy(tm, params, prompts)

    def conv(p):
        return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")

    for s in seeds:
        ja = acc(conv(jsyn.fit_affine_lm(jm, steps=300, seed=s)))
        own = acc(tsyn.fit_affine_lm(tm, steps=300, seed=s))
        same = acc(tsyn._fit(tm, conv(jinit(cfg, jax.random.PRNGKey(s))),
                             300, 1e-2, s))
        print(f"seed {s}: jax {ja:.4f} port {own:.4f} (gap {own - ja:+.4f})"
              f" port from jax's init {same:.4f} (gap {same - ja:+.4f})",
              flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or range(10))

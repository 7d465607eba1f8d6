"""The attention-only families beside smollm-135m — minitron-8b
(squared-ReLU 2-matrix MLP, untied head), musicgen-medium (LayerNorm,
tanh GELU 2-matrix MLP, untied head, MHA at full width, an audio stub
frontend), internvl2-1b (a vision stub frontend) and deepseek-coder-33b
— against the JAX package at `.reduced()`, with the same weights (JAX
`init_params` or a JAX fit, through `params_from_jax`).

`.reduced()` keeps each family's norm, activation, MLP and head but
turns musicgen's 24:24 heads into 4:2, so one more case holds G = 1
(`n_kv_heads = n_heads`).  Tolerances as tests/test_torch_model.py:
prefill logits of random-init weights within 2e-2; the fused decode
loop's token block on the paged cache identical on fitted weights
(`fit_affine_lm`, 300 steps), where random-init near-ties would flip
under any summation reorder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake
from test_torch_model import _bucketed, _paged_setup

torch.set_num_threads(1)

ARCHS = ["minitron-8b", "musicgen-medium", "internvl2-1b",
         "deepseek-coder-33b"]
# the four reduced, and reduced musicgen with one kv head per query head
CASES = ARCHS + ["musicgen-medium-mha"]
STUB_FRONTENDS = ["musicgen-medium", "internvl2-1b"]


def _cfgs(case):
    """(JAX config, port config) of a case, reduced."""
    arch = case.removesuffix("-mha")
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    if case.endswith("-mha"):
        cfg, tcfg = (dataclasses.replace(c, n_kv_heads=c.n_heads,
                                         name=c.name + "-mha")
                     for c in (cfg, tcfg))
    return cfg, tcfg


def _converted(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree(arch):
    assert tget(arch).__dict__ == get_config(arch).__dict__
    cfg, tcfg = _cfgs(arch)
    assert tcfg.__dict__ == cfg.__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keeps_jax_layout(arch):
    cfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
    got = tinit(tcfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}

    def n_leaves(tree):
        return (sum(n_leaves(v) for v in tree.values())
                if isinstance(tree, dict) else 1)

    assert n_leaves(got) == len(flat)
    for path, leaf in flat:
        t = got
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == names[str(leaf.dtype)], path


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_is_bit_exact(arch):
    cfg, _ = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(1))
    tp = _converted(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        t = tp
        for p in path:
            t = t[p.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert (t.view(torch.int16).numpy() == a.view(np.int16)).all()
        else:
            assert (t.numpy() == a).all(), path
    # the families' own leaves: an untied head, a norm bias
    assert ("head" in tp["embed"]) == (not cfg.tie_embeddings)
    assert ("b" in tp["final_norm"]) == (cfg.norm == "layernorm")


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_match_jax(case):
    cfg, tcfg = _cfgs(case)
    params = jinit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 16, 11)]
    toks, pos, last = _bucketed(prompts, 16)
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")
    want, _ = jm.prefill(params, jm.init_cache(3, 16),
                         tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                         last_idx=jnp.asarray(last))
    got, _ = tm.prefill(_converted(params), tm.init_cache(3, 16),
                        torch.tensor(toks), positions=torch.tensor(pos),
                        last_idx=torch.tensor(last))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_token_block_matches_jax(case):
    cfg, tcfg = _cfgs(case)
    params = fit_affine_lm(jmake(cfg, remat=False), steps=300)
    rng = np.random.default_rng(2)
    prompts = affine_prompts(rng, 3, cfg.vocab_size, (9, 15))
    prompts[2] = np.concatenate([prompts[0][:8], prompts[2][:5]])
    ps, maxp, n = 4, 8, 8
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")

    def run(model, p, as_tensor, cast):
        big, cur, forced, flen = _paged_setup(
            model, p, prompts, 8, ps, maxp, 3 * maxp + 1, as_tensor)
        out = model.decode_steps(
            p, big, as_tensor(cur), as_tensor(np.array([True, False, True])),
            n, eos_id=as_tensor(np.full(3, -1, np.int32)),
            budget=as_tensor(np.array([n, n, 5], np.int32)),
            forced=as_tensor(forced), forced_len=as_tensor(flen),
            forced_ptr=as_tensor(np.zeros(3, np.int32)))
        toks, cur, act, rem, fptr, caches = out
        return [cast(a) for a in (toks, cur, act, rem, fptr, caches["pos"])]

    want = run(jm, params, jnp.asarray, np.asarray)
    got = run(tm, _converted(params), torch.as_tensor, lambda t: t.numpy())
    for w, g, name in zip(want, got, ("toks", "cur", "active", "remaining",
                                      "forced_ptr", "pos")):
        assert (w == g).all(), (name, w, g)
    assert (got[0][:, 1] == -1).all()  # the inactive lane emits nothing
    assert (got[0][4:, 2] >= 0).all()  # the prefix hit's suffix ingested


@pytest.mark.parametrize("arch", STUB_FRONTENDS)
def test_embeds_entry_points_match_jax(arch):
    """A stub frontend's (B, S, D) embeddings through prefill, then (B, D)
    embeddings through decode_step, on the dense slot cache."""
    cfg, tcfg = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    lens = np.array([7, 12])
    s, steps = 16, 3
    emb = rng.normal(0, 1, (2, s, cfg.d_model)).astype(np.float32)
    pos = np.where(np.arange(s)[None] < lens[:, None], np.arange(s)[None],
                   2 ** 30).astype(np.int32)
    step_emb = rng.normal(0, 1, (steps, 2, cfg.d_model)).astype(np.float32)
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")

    def run(model, p, as_tensor, cast):
        lg, caches = model.prefill(p, model.init_cache(2, s + steps),
                                   embeds=as_tensor(emb),
                                   positions=as_tensor(pos),
                                   last_idx=as_tensor(lens - 1))
        out = [cast(lg)]
        for e in step_emb:
            lg, caches = model.decode_step(p, caches, as_tensor(e))
            out.append(cast(lg))
        return out, cast(caches["pos"])

    want, wpos = run(jm, params, jnp.asarray, np.asarray)
    got, gpos = run(tm, _converted(params), torch.as_tensor,
                    lambda t: t.numpy())
    assert (wpos == gpos).all() and (gpos == lens + steps).all()
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=0,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_family(arch, capsys):
    """`--arch` serves each family (reduced, on the CPU) through the paged
    continuous-batching engine to every request's budget."""
    done = serve.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.tokens_out) == 4 for r in done)
    assert f"arch={arch}-reduced" in capsys.readouterr().out

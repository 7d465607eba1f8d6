"""The port's layers and Model against the JAX package's, on reduced
smollm-135m, with the same weights (JAX `init_params` through
`params_from_jax`) and the same numpy inputs.

Tolerances: layers in f32 agree to 1e-5; bf16 layer outputs to one bf16
ulp of their scale (XLA and PyTorch round the same bf16 products from
f32 sums taken in different orders).  Prefill logits of the random-init
model (|logit| < 1) agree to 2e-2, a few bf16 ulps after two layers.  The
fused decode loop's (n, B) token block must be identical on the fitted
model (`fit_affine_lm`, 300 steps): random-init logits carry near-ties
that any summation reorder flips.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import layers as jl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
TCFG = tget("smollm-135m").reduced()


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.fixture(scope="module")
def fitted():
    params = fit_affine_lm(jmake(CFG, remat=False), steps=300)
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


def test_configs_agree():
    assert TCFG.__dict__ == CFG.__dict__


def test_init_params_keeps_jax_layout():
    want = jax.eval_shape(lambda k: jinit(CFG, k), jax.random.PRNGKey(0))
    got = tinit(TCFG, seed=0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for path, leaf in jflat:
        t = got
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == names[str(leaf.dtype)], path


def test_params_from_jax_is_bit_exact():
    params = jinit(CFG, jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    w = np.asarray(params["scan"]["b0"]["mix"]["wq"])
    t = tp["scan"]["b0"]["mix"]["wq"]
    assert t.dtype == torch.bfloat16
    assert (t.view(torch.int16).numpy() == w.view(np.int16)).all()
    assert torch.equal(tp["final_norm"]["g"],
                       torch.tensor(np.asarray(params["final_norm"]["g"])))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layers_match_jax(dtype):
    rng = np.random.default_rng(0)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    x = rng.normal(0, 1, (2, 5, 4, 16))
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    pairs = [
        (jl.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1e4),
         tl.apply_rope(torch.tensor(x).to(tdt), torch.tensor(pos), 1e4)),
        (jl.rmsnorm(jnp.asarray(x, jdt), {"g": jnp.asarray(x[0, 0, 0])}),
         tl.rmsnorm(torch.tensor(x).to(tdt),
                    {"g": torch.tensor(x[0, 0, 0]).float()})),
        (jl.layernorm(jnp.asarray(x, jdt),
                      {"g": jnp.asarray(x[0, 0, 0]),
                       "b": jnp.asarray(x[0, 0, 1])}),
         tl.layernorm(torch.tensor(x).to(tdt),
                      {"g": torch.tensor(x[0, 0, 0]).float(),
                       "b": torch.tensor(x[0, 0, 1]).float()})),
        (jax.nn.gelu(jnp.asarray(x, jdt)),
         tl.act_fn("gelu")(torch.tensor(x).to(tdt))),
        (jax.nn.silu(jnp.asarray(x, jdt)),
         tl.act_fn("silu")(torch.tensor(x).to(tdt))),
        (jnp.square(jax.nn.relu(jnp.asarray(x, jdt))),
         tl.act_fn("relu2")(torch.tensor(x).to(tdt))),
    ]
    w = {n: rng.normal(0, 0.25, s) for n, s in
         (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    # SwiGLU (smollm-135m), and the 2-matrix MLP under tanh GELU
    # (musicgen-medium) and squared ReLU (minitron-8b)
    for style, act in (("swiglu", "silu"), ("mlp", "gelu"), ("mlp", "relu2")):
        jc, tc = (dataclasses.replace(c, mlp_style=style, act=act)
                  for c in (CFG, TCFG))
        wp = {n: a for n, a in w.items() if style == "swiglu" or n != "wg"}
        pairs.append((jl.mlp(jnp.asarray(x, jdt),
                             {n: jnp.asarray(a, jdt) for n, a in wp.items()},
                             jc),
                      tl.mlp(torch.tensor(x).to(tdt),
                             {n: torch.tensor(a).to(tdt)
                              for n, a in wp.items()}, tc)))
    emb = {"tok": rng.normal(0, 1, (32, 16))}
    pairs.append((jl.lm_head(jnp.asarray(x, jdt),
                             {"tok": jnp.asarray(emb["tok"], jdt)}),
                  tl.lm_head(torch.tensor(x).to(tdt),
                             {"tok": torch.tensor(emb["tok"]).to(tdt)})))
    for i, (want, got) in enumerate(pairs):
        want, got = _np(want), _np(got)
        ulp = 1e-5 if dtype == "f32" else 2.0 ** -7 * max(
            1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=ulp, rtol=0,
                                   err_msg=f"pair {i}")
    # lm_head returns f32 logits of a bf16 product, rounded to bf16 first
    logits = tl.lm_head(torch.tensor(x).to(tdt),
                        {"tok": torch.tensor(emb["tok"]).to(tdt)})
    assert logits.dtype == torch.float32
    assert torch.equal(logits, logits.to(tdt).float())


def _bucketed(prompts, bucket):
    toks = np.zeros((len(prompts), bucket), np.int32)
    pos = np.full((len(prompts), bucket), 2 ** 30, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        pos[i, :len(p)] = np.arange(len(p))
    last = np.array([len(p) - 1 for p in prompts], np.int32)
    return toks, pos, last


def test_prefill_logits_match_jax():
    params = jinit(CFG, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (5, 16, 11)]
    toks, pos, last = _bucketed(prompts, 16)
    jm, tm = jmake(CFG, remat=False), tmake(TCFG, device="cpu")
    want, jc = jm.prefill(params, jm.init_cache(3, 16),
                          tokens=jnp.asarray(toks),
                          positions=jnp.asarray(pos),
                          last_idx=jnp.asarray(last))
    got, tc = tm.prefill(tp, tm.init_cache(3, 16), torch.tensor(toks),
                         positions=torch.tensor(pos),
                         last_idx=torch.tensor(last))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()
    # the bucket cache: same positions, and KV within 5e-2 on the real
    # rows (|kv| ~ 1; layer 2's KV carries layer 1's bf16 rounding).  Pad
    # rows sit at position 2^30, where the two libraries' sin/cos of huge
    # angles differ — and the sentinel keeps them unread.
    jk = np.asarray(jc["scan"]["b0"]["kpos"])
    assert (tc["scan"]["b0"]["kpos"].numpy() == jk).all()
    real = jk < 2 ** 30
    for name in ("k", "v"):
        np.testing.assert_allclose(
            _np(tc["scan"]["b0"][name])[real],
            _np(jc["scan"]["b0"][name])[real], atol=5e-2, rtol=0)


def _paged_setup(model, params, prompts, hit_len, ps, maxp, num_pages,
                 as_tensor):
    """Admit each prompt into lane i of a fresh paged cache the way the
    serving executor does: lane 0..B-2 cold (bucket prefill scattered into
    its pages), the last lane a prefix hit on lane 0's first `hit_len`
    positions (its suffix queued as forced tokens)."""
    b = len(prompts)
    big = model.init_paged_cache(b, num_pages, ps, maxp)
    cur = np.zeros((b,), np.int32)
    forced = np.zeros((b, maxp * ps), np.int32)
    flen = np.zeros((b,), np.int32)
    nxt = 1
    lane0 = None
    for i, p in enumerate(prompts):
        if i == b - 1:  # prefix hit on lane 0's pages
            n_own = maxp - hit_len // ps
            pages = list(lane0[:hit_len // ps]) + list(
                range(nxt, nxt + n_own))
            own = np.array(pages[hit_len // ps:], np.int32)
            big = model.admit_lane_cache(
                big, i, as_tensor(np.array(pages, np.int32)), hit_len,
                as_tensor(own))
            suffix = p[hit_len:]
            cur[i] = suffix[0]
            forced[i, :len(suffix) - 1] = suffix[1:]
            flen[i] = len(suffix) - 1
            continue
        pages = np.arange(nxt, nxt + maxp, dtype=np.int32)
        nxt += maxp
        lane0 = pages if lane0 is None else lane0
        toks, pos, last = _bucketed([p], 16)
        logits, small = model.prefill(params, model.init_cache(1, 16),
                                      as_tensor(toks),
                                      positions=as_tensor(pos),
                                      last_idx=as_tensor(last))
        cur[i] = int(np.asarray(logits).argmax())
        big = model.admit_lane_cache(big, i, as_tensor(pages), len(p),
                                     as_tensor(pages), small=small,
                                     write_pages=as_tensor(pages[:16 // ps]))
    return big, cur, forced, flen


def test_decode_steps_token_block_matches_jax(fitted):
    params, tp = fitted
    rng = np.random.default_rng(2)
    prompts = affine_prompts(rng, 3, CFG.vocab_size, (9, 15))
    prompts[2] = np.concatenate([prompts[0][:8], prompts[2][:5]])
    ps, maxp, n = 4, 8, 8
    jm, tm = jmake(CFG, remat=False), tmake(TCFG, device="cpu")

    def run(model, p, as_tensor, cast):
        big, cur, forced, flen = _paged_setup(
            model, p, prompts, 8, ps, maxp, 3 * maxp + 1, as_tensor)
        active = np.array([True, False, True])
        budget = np.array([n, n, 5], np.int32)
        out = model.decode_steps(
            p, big, as_tensor(cur), as_tensor(active), n,
            eos_id=as_tensor(np.full(3, -1, np.int32)),
            budget=as_tensor(budget), forced=as_tensor(forced),
            forced_len=as_tensor(flen),
            forced_ptr=as_tensor(np.zeros(3, np.int32)))
        toks, cur, act, rem, fptr, caches = out
        return [cast(a) for a in (toks, cur, act, rem, fptr, caches["pos"])]

    want = run(jm, params, jnp.asarray, np.asarray)
    got = run(tm, tp, torch.as_tensor, lambda t: t.numpy())
    for w, g, name in zip(want, got, ("toks", "cur", "active", "remaining",
                                      "forced_ptr", "pos")):
        assert (w == g).all(), (name, w, g)
    toks = got[0]
    assert toks.shape == (n, 3)
    assert (toks[:, 1] == -1).all()  # the inactive lane emits nothing
    assert (toks[:4, 2] == -1).all() and (toks[4:, 2] >= 0).all()

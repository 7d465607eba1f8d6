"""moonshot-v1-16b-a3b and llama4-maverick-400b-a17b served by the port's
paged continuous-batching engine, at `.reduced()` on the CPU, on JAX's
300-step `fit_affine_lm` fits (confident logits: random-init near-ties
break under any summation reorder) loaded with `params_from_jax`.

* The fused decode loop's token block on the paged cache (a prefix hit's
  suffix through the forced queue, an inactive lane, a budget exit) is
  identical to JAX's.
* The engine's streams equal the JAX engine's on the same requests
  (kernels pinned to the jnp oracle), stats included.  A bucketed prefill
  routes the bucket's tokens (pads last) as one group at the bucket's
  capacity, in both.  The stream's seed stays clear of the 300-step
  fits' exact bf16 top-2 ties: at seed 2 moonshot's port, and at seed 3
  llama4's JAX, meets a top-2 gap of 0.0 where the other package reads
  one bf16 step (0.0625, 0.125), and the streams part there; seeds 4-7
  match in both.
* The serve CLI takes both archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving import engine as jeng
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving import engine as teng
from test_torch_model import _paged_setup

torch.set_num_threads(1)

ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]
STATS = ("prefix_hits", "pages_peak", "preemptions", "decode_dispatches",
         "decode_steps", "prefills", "admitted", "completed")


@pytest.fixture(scope="module", params=ARCHS)
def fitted(request):
    cfg = get_config(request.param).reduced()
    jm = jmake(cfg, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, jm, params, tmake(tget(request.param).reduced(),
                                  device="cpu"), tp


def test_decode_steps_token_block_matches_jax(fitted):
    cfg, jm, params, tm, tp = fitted
    rng = np.random.default_rng(2)
    prompts = affine_prompts(rng, 3, cfg.vocab_size, (9, 15))
    prompts[2] = np.concatenate([prompts[0][:8], prompts[2][:5]])
    ps, maxp, n = 4, 8, 8

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
    with torch.no_grad():
        got = run(tm, tp, torch.as_tensor, lambda t: t.numpy())
    for w, g, name in zip(want, got, ("toks", "cur", "active", "remaining",
                                      "forced_ptr", "pos")):
        assert (w == g).all(), (name, w, g)
    assert (got[0][:, 1] == -1).all()  # the inactive lane emits nothing
    assert (got[0][4:, 2] >= 0).all()  # the prefix hit's suffix ingested


def _stream(cfg, seed):
    """Affine requests, all at t = 0, one sharing another's prefix."""
    rng = np.random.default_rng(seed)
    prompts = affine_prompts(rng, 6, cfg.vocab_size, (4, 30))
    prompts[4] = np.concatenate([prompts[1][:16], prompts[4][:6]])
    return [(p, int(rng.integers(4, 14))) for p in prompts]


def _serve(pkg, model, params, stream):
    eng = pkg.ContinuousBatchingEngine(model, params, max_batch=3,
                                       buckets=(16, 32), deadline_s=0.0,
                                       page_size=4, num_pages=40,
                                       max_decode_len=32)
    for i, (p, b) in enumerate(stream):
        eng.submit(pkg.Request(rid=i, prompt=p, max_new_tokens=b))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [list(r.tokens_out) for r in done], eng


def test_engine_matches_jax_engine(fitted):
    cfg, jm, params, tm, tp = fitted
    stream = _stream(cfg, 4)
    with pinned_impl("ref"):
        want, jeng_ = _serve(jeng, jm, params, stream)
    got, eng = _serve(teng, tm, tp, stream)
    assert eng.paged and jeng_.paged
    assert got == want
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng_.stats[k] for k in STATS}
    assert [len(t) for t in got] == [b for _, b in stream]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_family(arch, capsys):
    """`--arch` serves each MoE family (reduced, on the CPU) through the
    paged continuous-batching engine to every request's budget."""
    done = serve.main(["--device", "cpu", "--reduced", "--arch", arch,
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3 and all(len(r.tokens_out) == 4 for r in done)
    assert f"arch={arch}-reduced" in capsys.readouterr().out

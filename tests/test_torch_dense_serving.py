"""The port's dense-slot and int8 serving routes against the JAX engines.

The routes: `WaveEngine` (batch-synchronous waves on dense slot rows),
`ContinuousBatchingEngine(paged=False)` (dense slot rows, one batch-1
prefill inserted per admission) and `ContinuousBatchingEngine(
kv_dtype="int8")` (an int8 page arena, quantized at admission and at
every decode write).  One cloned request stream goes through the JAX
engine (kernels pinned to the jnp oracle) and through the port's on the
CPU, with the same fitted weights (`fit_affine_lm`, 300 steps, converted
by `params_from_jax`): every token stream must be identical, and so must
the engines' stats.  Inside the port, paged == dense == wave streams, and
an int8 prefix hit equals an int8 cold prefill.  The streams follow
tests/test_torch_serving.py: affine prompts from a seed whose runs stay
clear of the fitted model's bf16 top-2 ties, rate 0, deadline 0.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving import engine as jeng
from repro_torch.configs import get_config as tget
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
SENTINEL = 2 ** 30


@pytest.fixture(scope="module")
def models():
    jm = jmake(CFG, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tmake(tget("smollm-135m").reduced(), device="cpu"), tp


def _stream(kind="poisson", seed=2):
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        prompts = affine_prompts(rng, 10, CFG.vocab_size, (4, 30))
        budgets = [int(rng.integers(4, 20)) for _ in prompts]
    else:
        prefix = affine_prompts(rng, 1, CFG.vocab_size, (24, 25))[0]
        prompts = [np.concatenate([prefix, s]).astype(np.int32) for s in
                   affine_prompts(rng, 8, CFG.vocab_size, (3, 9))]
        budgets = [int(rng.integers(8, 24)) for _ in prompts]
    return list(zip(prompts, budgets))


# route -> (engine class name, engine kwargs)
ROUTES = {"wave": ("WaveEngine", {}),
          "dense": ("ContinuousBatchingEngine", {"paged": False}),
          "paged": ("ContinuousBatchingEngine", {"page_size": 4}),
          "int8": ("ContinuousBatchingEngine", {"page_size": 4,
                                                "kv_dtype": "int8"})}


def _serve(pkg, model, params, stream, route, **kw):
    name, route_kw = ROUTES[route]
    eng = getattr(pkg, name)(model, params, max_batch=3, buckets=(16, 32),
                             deadline_s=0.0, max_decode_len=32,
                             **route_kw, **kw)
    for i, (p, b) in enumerate(stream):
        eng.submit(pkg.Request(rid=i, prompt=p, max_new_tokens=b))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [list(r.tokens_out) for r in done], eng.stats


def _port(models, stream, route, **kw):
    _, _, tm, tp = models
    return _serve(teng, tm, tp, stream, route, **kw)


@pytest.mark.parametrize("route,kind,num_pages", [
    ("wave", "poisson", None), ("dense", "poisson", None),
    ("int8", "poisson", None), ("int8", "shared-prefix", 20)])
def test_engine_matches_jax_engine(models, route, kind, num_pages):
    jm, params, _, _ = models
    stream = _stream(kind)
    kw = {} if num_pages is None else {"num_pages": num_pages}
    with pinned_impl("ref"):
        want, jstats = _serve(jeng, jm, params, stream, route, **kw)
    got, tstats = _port(models, stream, route, **kw)
    assert got == want
    assert tstats == jstats
    assert [len(t) for t in got] == [b for _, b in stream]
    if num_pages is not None:  # the tight int8 pool hits and preempts
        assert tstats["prefix_hits"] > 0 and tstats["preemptions"] > 0


def test_paged_dense_and_wave_streams_agree(models):
    stream = _stream(seed=4)
    streams = {r: _port(models, stream, r)[0] for r in ("paged", "dense",
                                                         "wave")}
    assert streams["paged"] == streams["dense"] == streams["wave"]


def test_int8_prefix_hit_equals_cold(models):
    """A hit on int8 pages (shared values and shared arena scales) gives
    the stream a cold int8 prefill gives."""
    rng = np.random.default_rng(9)
    t0, step = int(rng.integers(0, CFG.vocab_size)), 5
    prefix = ((t0 + step * np.arange(16)) % CFG.vocab_size).astype(np.int32)
    stream = [(np.concatenate([prefix, (prefix[-1] + step * np.arange(
        1, 4 + i)) % CFG.vocab_size]).astype(np.int32), 6) for i in range(3)]
    _, _, tm, tp = models

    def serve(reqs):
        eng = teng.ContinuousBatchingEngine(
            tm, tp, max_batch=1, buckets=(32,), kv_dtype="int8",
            page_size=8)
        for i, (p, b) in reqs:
            eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=b))
        return {r.rid: list(r.tokens_out) for r in eng.run()}, eng.stats

    hit, stats = serve(list(enumerate(stream)))
    assert stats["prefix_hits"] >= 1
    cold = {}
    for item in enumerate(stream):
        cold.update(serve([item])[0])
    assert hit == cold


def test_int8_streams_match_bf16_99pct(models):
    """tests/test_quant_kv.py's acceptance bar on its own stream: the int8
    arena's greedy streams agree with the bf16 arena's on >= 99% of
    tokens."""
    _, _, tm, tp = models
    rng = np.random.default_rng(5)
    prompts = affine_prompts(rng, 10, CFG.vocab_size)
    budgets = [int(b) for b in rng.integers(8, 24, len(prompts))]

    def serve(kv_dtype):
        eng = teng.ContinuousBatchingEngine(tm, tp, max_batch=4,
                                            buckets=(16, 32),
                                            kv_dtype=kv_dtype)
        for i, p in enumerate(prompts):
            eng.submit(teng.Request(rid=i, prompt=p,
                                    max_new_tokens=budgets[i]))
        return [list(r.tokens_out) for r in eng.run()]

    bf, i8 = serve("bf16"), serve("int8")
    assert [len(t) for t in i8] == budgets
    total = sum(len(t) for t in bf)
    matched = sum(a == b for x, y in zip(bf, i8) for a, b in zip(x, y))
    assert matched / total >= 0.99, (matched, total)


def test_engine_option_errors(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="paged KV pool"):
        teng.ContinuousBatchingEngine(tm, tp, paged=False, kv_dtype="int8")
    for cls in (teng.ContinuousBatchingEngine, teng.WaveEngine):
        # W8A8 is served since; smollm's projections are all stacked
        # (3-d), so quant_weights leaves its params as they are
        eng = cls(tm, tp, quant_weights=True)
        assert eng.executor.quant_weights
        assert all(not isinstance(w, dict) for w in
                   eng.executor.params["scan"]["b0"]["mix"].values())
    eng = teng.ContinuousBatchingEngine(tm, tp, kv_dtype="int8")
    assert eng.paged and eng.kv_page_bytes() < \
        teng.ContinuousBatchingEngine(tm, tp).kv_page_bytes()


def _lanes_cache(model, params, prompts, kind, as_tensor):
    """Prefill each prompt at bucket 16 and admit it into lane i: a dense
    slot cache of 32 rows (insert_prefill_cache) or an int8 page arena of
    page size 4 (admit_lane_cache)."""
    b, ps, maxp = len(prompts), 4, 8
    big = (model.init_cache(b, 32) if kind == "dense" else
           model.init_paged_cache(b, 1 + b * maxp, ps, maxp, kv_dtype="int8"))
    cur = []
    for i, p in enumerate(prompts):
        toks = np.zeros((1, 16), np.int32)
        pos = np.full((1, 16), SENTINEL, np.int32)
        toks[0, :len(p)], pos[0, :len(p)] = p, np.arange(len(p))
        logits, small = model.prefill(
            params, model.init_cache(1, 16), as_tensor(toks),
            positions=as_tensor(pos),
            last_idx=as_tensor(np.array([len(p) - 1], np.int32)))
        cur.append(int(np.asarray(logits).argmax()))
        if kind == "dense":
            big = model.insert_prefill_cache(big, small, i)
        else:
            pages = np.arange(1 + i * maxp, 1 + (i + 1) * maxp,
                              dtype=np.int32)
            big = model.admit_lane_cache(big, i, as_tensor(pages), len(p),
                                         as_tensor(pages), small=small,
                                         write_pages=as_tensor(pages[:4]))
    return big, np.array(cur, np.int32)


@pytest.mark.parametrize("kind", ["dense", "int8"])
def test_decode_steps_token_block_matches_jax(models, kind):
    """The fused decode loop on a dense slot cache and on an int8 arena:
    the same (n, B) token block, lane state and position counters as JAX's
    decode_steps, with an inactive lane and a budget that runs out."""
    jm, params, tm, tp = models
    prompts = affine_prompts(np.random.default_rng(2), 3, CFG.vocab_size,
                             (9, 15))
    n = 8

    def run(model, p, as_tensor, cast):
        big, cur = _lanes_cache(model, p, prompts, kind, as_tensor)
        toks, cur, act, rem, caches = model.decode_steps(
            p, big, as_tensor(cur), as_tensor(np.array([True, False, True])),
            n, eos_id=as_tensor(np.full(3, -1, np.int32)),
            budget=as_tensor(np.array([n, n, 5], np.int32)))
        return [cast(a) for a in (toks, cur, act, rem, caches["pos"])]

    with pinned_impl("ref"):
        want = run(jm, params, jnp.asarray, np.asarray)
    got = run(tm, tp, torch.as_tensor, lambda t: t.numpy())
    for w, g, name in zip(want, got, ("toks", "cur", "active", "remaining",
                                      "pos")):
        assert (w == g).all(), (name, w, g)
    assert (got[0][:, 1] == -1).all() and (got[0][5:, 2] == -1).all()

"""The request-skewed throughput pipeline (``--plan serve_pipeline
--no-exact``) on the port's single-controller mesh, against the JAX
package's plan-free paged engine and the port's own.

The model is the fitted synthetic LM (`fit_affine_lm`, 300 steps in JAX,
converted by `params_from_jax`): reduced smollm-135m cut to 4 layers, so
2 and 4 stages divide its periods.  Every stage sits on the CPU (one
process drives them, as on a card they share).

  * the executor's skewed loop equals `Model.decode_steps` on the same
    admitted paged state (lanes with forced-token queues included): the
    tokens, the lane state, the position counters and the arena, at
    n*S + S - 1 ticks a horizon;
  * the engine's streams, on bf16 and int8 arenas, cold and then as
    radix hits on the stage-local arenas, equal the JAX plan-free paged
    engine's (kernels pinned to the jnp oracle) and the port's plan-free
    engine's; it runs S lane groups over an S-shard page ledger, drains
    it, and each stage's arena block holds n_rep / S periods;
  * `kv_page_bytes`, the refusals and the CLI; the latency model's tick
    accounting against JAX's.

Tolerances: none, every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.core import latency_model as jlat
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.kv_manager import kv_page_bytes as jax_page_bytes
from repro_torch.configs import get_config as tget
from repro_torch.core import latency_model as tlat
from repro_torch.core.cluster_builder import build_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving.engine import ContinuousBatchingEngine as TorchEngine
from repro_torch.serving.executor import Executor
from repro_torch.serving.scheduler import Request as TorchRequest

torch.set_num_threads(1)

# the same name as tests/test_torch_sharded_serving.py's: one fit a process
CFG = dataclasses.replace(get_config("smollm-135m").reduced(), n_layers=4,
                          name="smollm-135m-reduced-4l")
TCFG = dataclasses.replace(tget("smollm-135m").reduced(), n_layers=4,
                           name=CFG.name)
ENGINE = dict(max_batch=4, buckets=(16, 32), deadline_s=0.0, page_size=4,
              num_pages=48, max_decode_len=32)


@pytest.fixture(scope="module")
def models():
    jm = jmake(CFG, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tmake(TCFG, device="cpu"), tp


def _skew_plan(cfg, n):
    return build_plan(cfg, make_mesh((n,), ("stage",), device="cpu"),
                      mode="serve_pipeline", exact=False)


def _whole(tree):
    """A placed tree with every stage `Shards` joined back (stage blocks
    are contiguous periods, so a join is a concatenation)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return torch.cat(list(tree)) if isinstance(tree, Shards) else tree.clone()


@pytest.mark.parametrize("n_stages", [2, 4])
def test_skewed_loop_equals_decode_steps(models, n_stages):
    _, _, tm, tp = models
    b, steps, ps, maxp = 8, 7, 4, 12
    ex = Executor(tm, tp, plan=_skew_plan(tm.cfg, n_stages), max_batch=b,
                  cache_len=ps * maxp, buckets=(16,))
    st = ex.fresh_state(ex.init_caches(True, ps, b * maxp + 1, maxp),
                        paged=True)
    rng = np.random.default_rng(0)
    for sl, p in enumerate(affine_prompts(rng, b, CFG.vocab_size, (9, 14))):
        pages = np.arange(1 + sl * maxp, 1 + (sl + 1) * maxp, dtype=np.int32)
        # odd lanes take the radix-hit form: an 8-token prefix in their
        # pages, the rest of the prompt through the forced-token queue
        cut = 8 if sl % 2 else len(p)
        logits, small = ex.prefill_prompts([p[:cut]], 1, bucket_cache=True)
        ex.admit_cold(st, sl, small, pages, cut, pages, pages[:4])
        tok, rest = ((int(logits[0].argmax()), p[:0]) if cut == len(p)
                     else (int(p[cut]), p[cut + 1:]))
        ex.admit_lane_paged(st, sl, tok, -1, 3 + sl % 5, rest, len(rest))
    k = st["caches"]["scan"]["b0"]["k"]
    assert isinstance(k, Shards) and [t.shape[0] for t in k] == \
        [4 // n_stages] * n_stages
    plain, full = _whole(st["caches"]), _whole(tp)
    want = tm.decode_steps(full, plain, st["cur"].clone(),
                           st["active"].clone(), steps, eos_id=st["eos"],
                           budget=st["budget"].clone(), pad_token=0,
                           forced=st["forced"], forced_len=st["flen"],
                           forced_ptr=st["fptr"].clone())
    got = ex.decode(st, steps, paged=True)
    assert torch.equal(got, want[0])
    for name, w in zip(("cur", "active", "budget", "fptr"), want[1:5]):
        assert torch.equal(st[name], w), name
    assert torch.equal(st["caches"]["pos"], plain["pos"])
    arena = _whole(st["caches"]["scan"])
    for name, t in want[5]["scan"]["b0"].items():
        assert torch.equal(arena["b0"][name], t), name
    assert ex.pipeline_ticks == steps * n_stages + n_stages - 1


def _stream(seed=6):
    """Affine prompts sharing a 24-token prefix (the radix cache's
    ingress), with their budgets.  Against JAX the seed is one whose runs
    stay clear of the fitted model's bf16 top-2 ties, as in
    tests/test_torch_serving.py: at seeds 3, 5 and 7 the port's plan-free
    engine already parts from JAX's on this 4-layer fit, while the skewed
    engine equals the port's plan-free one there too."""
    rng = np.random.default_rng(seed)
    prefix = affine_prompts(rng, 1, CFG.vocab_size, (24, 25))[0]
    prompts = [np.concatenate([prefix, s]).astype(np.int32) for s in
               affine_prompts(rng, 7, CFG.vocab_size, (3, 9))]
    return [(p, int(rng.integers(8, 20))) for p in prompts]


def _streams(eng, request_cls, stream):
    for i, (p, b) in enumerate(stream):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=b))
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}


@pytest.mark.parametrize("kv_dtype,n_stages", [("bf16", 2), ("int8", 4)])
def test_skewed_engine_equals_plan_free_engines(models, kv_dtype, n_stages):
    jm, params, tm, tp = models
    stream = _stream()
    with pinned_impl("ref"):
        jeng = JaxEngine(jm, params, kv_dtype=kv_dtype, **ENGINE)
        want = [_streams(jeng, JaxRequest, stream) for _ in range(2)]
    single = TorchEngine(tm, tp, kv_dtype=kv_dtype, **ENGINE)
    skew = TorchEngine(tm, tp, kv_dtype=kv_dtype,
                       plan=_skew_plan(tm.cfg, n_stages), **ENGINE)
    assert skew.paged and skew.sched.n_lane_groups == n_stages
    assert skew.kv.shards == n_stages
    for p, want_pass in enumerate(want):  # cold, then radix hits
        hits, steps = skew.stats["prefix_hits"], skew.stats["decode_steps"]
        disp, ticks = (skew.stats["decode_dispatches"],
                       skew.executor.pipeline_ticks)
        assert _streams(skew, TorchRequest, stream) == want_pass, p
        assert _streams(single, TorchRequest, stream) == want_pass, p
        assert skew.executor.pipeline_ticks - ticks == (
            (skew.stats["decode_steps"] - steps) * n_stages
            + (skew.stats["decode_dispatches"] - disp) * (n_stages - 1))
        if p == 1:  # every admission of the second pass hits the arena
            assert skew.stats["prefix_hits"] - hits >= len(stream) - 1
    # run() drained the pool (assert_drained): the radix tree's pages
    # alone stay, on every stage's ledger
    skew.kv.assert_drained()
    assert skew.kv.pages_in_use == skew.kv.prefix_cache.cached_pages > 0
    assert all(skew.kv.shard_pages_in_use(s) == skew.kv.pages_in_use
               for s in range(n_stages))
    arena = skew._slot_caches["scan"]["b0"]
    names = ("k", "v", "kpos") + (("k_scale", "v_scale")
                                  if kv_dtype == "int8" else ())
    for name in names:
        assert isinstance(arena[name], Shards) and len(arena[name]) == \
            n_stages
        assert [t.shape[0] for t in arena[name]] == [4 // n_stages] * \
            n_stages, name
    assert not isinstance(skew._slot_caches["pt"], Shards)
    assert skew.kv_page_bytes() == jax_page_bytes(
        CFG, ENGINE["page_size"], kv_dtype, shards=n_stages)
    assert skew.kv_page_bytes() * n_stages == single.kv_page_bytes()


def test_skewed_plan_refusals(models):
    """The reference's two ValueErrors (a batch the stages do not divide,
    speculation under the skewed schedule), and paged=False, which the
    skewed loop has no dense-slot form of."""
    _, _, tm, tp = models
    plan = _skew_plan(tm.cfg, 2)
    with pytest.raises(ValueError, match="max_batch=3"):
        TorchEngine(tm, tp, plan=plan, **dict(ENGINE, max_batch=3))
    with pytest.raises(ValueError, match="spec_config"):
        TorchEngine(tm, tp, plan=plan, spec_config=dict(
            draft_model=tm, draft_params=tp, spec_k=2), **ENGINE)
    with pytest.raises(ValueError, match="paged arena"):
        TorchEngine(tm, tp, plan=plan, paged=False, **ENGINE)


def test_cli_serves_the_skewed_pipeline(capsys):
    base = ["--device", "cpu", "--reduced", "--requests", "5", "--max-new",
            "5", "--stream", "shared-prefix", "--max-batch", "4"]
    for kv in ("bf16", "int8"):
        kvf = ["--kv-dtype", kv]
        want = [r.tokens_out for r in serve_cli.main(base + kvf + [
            "--plan", "none"])]
        got = [r.tokens_out for r in serve_cli.main(base + kvf + [
            "--plan", "serve_pipeline", "--mesh", "2", "--no-exact"])]
        assert got == want, kv
    out = capsys.readouterr().out
    assert "plan=serve_pipeline mesh={'stage': 2} exact=False" in out
    serve_cli.main(base + ["--plan", "serve_pipeline", "--mesh", "2",
                           "--no-exact", "--dryrun"])
    out = capsys.readouterr().out
    assert "paged=True" in out and "skewed(throughput)" in out


def test_latency_model_ticks_match_jax():
    for s in (1, 2, 3, 6, 8):
        for m in (1, 4, 6, 12):
            assert tlat.pipeline_bubble_fraction(m, s) == \
                jlat.pipeline_bubble_fraction(m, s)
        for exact in (True, False):
            assert tlat.pipeline_ticks_per_step(s, exact) == \
                jlat.pipeline_ticks_per_step(s, exact)
            for t_stage, d in ((1e-3, 0.0), (2.5e-3, 4e-5)):
                assert tlat.decode_step_latency(t_stage, s, d, exact) == \
                    jlat.decode_step_latency(t_stage, s, d, exact)

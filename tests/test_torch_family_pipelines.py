"""The recurrent and MoE families on the stage pipelines (``--plan
serve_pipeline``), at `.reduced()` on the CPU, every stage on the CPU (one
process drives them, as on a card they share).

The reference never serves these families under a plan in a test, so the
contract held here is the port's own: a stage's rows are bit for bit one
device's.

  * The drained loop (`Executor._pipeline_decode`, dense slot rows) equals
    `Model.decode_steps` on the same admitted state, tokens, last-step
    logits and every state leaf, on `init_params` weights: xlstm-1.3b (4
    layers in periods of 2; its mLSTM and sLSTM state cut by stage like
    the K/V leaves), moonshot-v1-16b-a3b at 4 layers on 2 and 4 stages,
    llama4-maverick's two 2-layer periods on 2 stages, and moonshot with
    64 experts at B 4 on 4 stages (one lane a microbatch).
  * The request-skewed loop (`_pipeline_skew_decode`, stage-local paged
    arenas, lanes with forced-token queues) does the same for moonshot on
    bf16 and int8 pages.
  * The widened-expert case: with 64 experts at D 64 the MoE FFN's f32
    router product gives a row other bits at 1 row than inside a 4-row
    call on this CPU with one thread; `moe_ffn` on a stage's rows
    (``lanes``) equals the 4-row call at those rows.
  * Against JAX: the engines' streams under a 2-stage plan equal the JAX
    plan-free engines' (kernels pinned to the jnp oracle) on JAX's
    300-step `fit_affine_lm` fits of reduced xlstm and moonshot: the
    drained engine against the dense-slot engine, and moonshot's skewed
    engine against the paged one.  W8A8 under the plan quantizes no leaf
    and serves the bf16 streams.
  * Refusals: recurrentgemma-2b (a 2-layer tail) keeps the reference's
    ValueError, xlstm under the skewed plan the engine's (no paged
    arena); a ``mode="serve"`` plan serves W8A8 (recurrentgemma's tail
    MLP per shard, smollm with nothing quantized), each stream one
    device's; the serve CLI and a plan search's serve_pipeline choice
    serve them, and its ``mode="serve"`` choice serves moonshot.
  * Against JAX under a ``mode="serve"`` plan: the exact (1, 2) cb
    engine's streams on the fitted moonshot equal the JAX plan-free paged
    engine's, and the fitted xlstm's dense-slot cb engine's the JAX
    dense-slot engine's.

Tolerances: none, every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving import engine as jeng
from repro_torch.configs import get_config as tget
from repro_torch.core.cluster_builder import build_plan
from repro_torch.core.pipeline import pipeline_steps
from repro_torch.core.plan_search import (Candidate, Score, engine_kwargs,
                                          realize)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.quantized import is_quantized
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import init_params, layer_plan
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving import engine as teng
from repro_torch.serving.executor import Executor

torch.set_num_threads(1)

XLSTM, MOONSHOT, LLAMA4 = ("xlstm-1.3b", "moonshot-v1-16b-a3b",
                           "llama4-maverick-400b-a17b")


def _cfg(arch, **kw):
    cfg = tget(arch).reduced()
    if kw:
        tag = "-".join(f"{k}{v}" for k, v in kw.items())
        cfg = dataclasses.replace(cfg, name=f"{cfg.name}-{tag}", **kw)
    return cfg


def _plan(cfg, n, exact=True):
    return build_plan(cfg, make_mesh((n,), ("stage",), device="cpu"),
                      mode="serve_pipeline", exact=exact)


def _whole(tree):
    """A placed tree with every stage `Shards` joined back (stage blocks
    are contiguous periods, so a join is a concatenation)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return torch.cat(list(tree)) if isinstance(tree, Shards) else tree.clone()


def _one_device(model, params, st, n, forced=False):
    """`Model.decode_steps`' n steps on a whole copy of `st`: (tokens,
    caches), and its last step's logits (n - 1 steps on another copy,
    then one `decode_step`)."""
    def run(k):
        kw = (dict(forced=st["forced"], forced_len=st["flen"],
                   forced_ptr=st["fptr"].clone()) if forced else {})
        return model.decode_steps(
            params, _whole(st["caches"]), st["cur"].clone(),
            st["active"].clone(), k, eos_id=st["eos"],
            budget=st["budget"].clone(), pad_token=0, **kw)

    with torch.no_grad():
        out = run(n)
        pre = run(n - 1)
        logits, _ = model.decode_step(params, pre[-1], pre[1],
                                      active=pre[2])
    return out[0], out[-1], logits


def _admit_dense(ex, cfg, b, seed=0):
    """A dense decode state of b - 1 admitted lanes (the last lane free),
    budgets 3-7 so that lanes leave mid-dispatch."""
    st = ex.fresh_state(ex.init_caches(False), paged=False)
    rng = np.random.default_rng(seed)
    for sl in range(b - 1):
        p = rng.integers(0, cfg.vocab_size, 5 + 3 * sl).astype(np.int32)
        logits, small = ex.prefill_prompts([p], 1, bucket_cache=True)
        st["caches"] = ex.insert(st["caches"], small, sl)
        ex.admit_lane(st, sl, int(logits[0].argmax()), -1, 3 + sl % 5)
    return st


def _stage_blocks(caches, per, n_stages):
    for blk in caches["scan"].values():
        for name, leaf in blk.items():
            assert isinstance(leaf, Shards), name
            assert [t.shape[0] for t in leaf] == [per] * n_stages, name


@pytest.mark.parametrize("arch,kw,n_stages,b", [
    pytest.param(XLSTM, {}, 2, 8, id="xlstm-2stages"),
    pytest.param(MOONSHOT, dict(n_layers=4), 2, 8, id="moonshot-2stages"),
    pytest.param(MOONSHOT, dict(n_layers=4), 4, 8, id="moonshot-4stages"),
    pytest.param(LLAMA4, dict(n_layers=4), 2, 8, id="llama4-2stages"),
    pytest.param(MOONSHOT, dict(n_layers=4, n_experts=64), 4, 4,
                 id="moonshot-e64-4stages-b4")])
def test_drained_loop_equals_decode_steps(arch, kw, n_stages, b):
    cfg = _cfg(arch, **kw)
    model = tmake(cfg, device="cpu")
    params = init_params(cfg, seed=0, device="cpu")
    steps = 6
    ex = Executor(model, params, plan=_plan(cfg, n_stages), max_batch=b,
                  cache_len=48, buckets=(16, 32))
    st = _admit_dense(ex, cfg, b)
    n_rep, _, _ = layer_plan(cfg)
    _stage_blocks(st["caches"], n_rep // n_stages, n_stages)
    want, caches, logits = _one_device(model, params, st, steps)
    got = ex.decode(st, steps, paged=False)
    assert torch.equal(got, want)
    assert torch.equal(ex.logits, logits)
    whole = _whole(st["caches"])
    for blk, leaves in caches["scan"].items():
        for name, t in leaves.items():
            assert torch.equal(whole["scan"][blk][name], t), (blk, name)
    assert torch.equal(whole["pos"], caches["pos"])
    n_micro = n_stages if b % n_stages == 0 else 1
    assert ex.pipeline_ticks == steps * pipeline_steps(n_micro, n_stages)


def _admit_paged(ex, cfg, b, ps, maxp, kv_dtype, seed=0):
    """A paged decode state of b admitted lanes: odd lanes in the
    radix-hit form (an 8-token prefix in their pages, the rest of the
    prompt through the forced-token queue)."""
    st = ex.fresh_state(ex.init_caches(True, ps, b * maxp + 1, maxp,
                                       kv_dtype=kv_dtype), paged=True)
    rng = np.random.default_rng(seed)
    for sl in range(b):
        p = rng.integers(0, cfg.vocab_size, 9 + sl).astype(np.int32)
        pages = np.arange(1 + sl * maxp, 1 + (sl + 1) * maxp, dtype=np.int32)
        cut = 8 if sl % 2 else len(p)
        logits, small = ex.prefill_prompts([p[:cut]], 1, bucket_cache=True)
        ex.admit_cold(st, sl, small, pages, cut, pages, pages[:4])
        tok, rest = ((int(logits[0].argmax()), p[:0]) if cut == len(p)
                     else (int(p[cut]), p[cut + 1:]))
        ex.admit_lane_paged(st, sl, tok, -1, 3 + sl % 5, rest, len(rest))
    return st


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_skewed_loop_equals_decode_steps(kv_dtype):
    cfg = _cfg(MOONSHOT, n_layers=4)
    model = tmake(cfg, device="cpu")
    params = init_params(cfg, seed=0, device="cpu")
    b, steps, ps, maxp, n_stages = 8, 6, 4, 12, 4
    ex = Executor(model, params, plan=_plan(cfg, n_stages, exact=False),
                  max_batch=b, cache_len=ps * maxp, buckets=(16,))
    st = _admit_paged(ex, cfg, b, ps, maxp, kv_dtype)
    _stage_blocks(st["caches"], cfg.n_layers // n_stages, n_stages)
    want, caches, logits = _one_device(model, params, st, steps, forced=True)
    got = ex.decode(st, steps, paged=True)
    assert torch.equal(got, want)
    assert torch.equal(ex.logits, logits)
    arena = _whole(st["caches"]["scan"])
    for name, t in caches["scan"]["b0"].items():
        assert torch.equal(arena["b0"][name], t), name
    assert torch.equal(st["caches"]["pos"], caches["pos"])
    assert ex.pipeline_ticks == steps * n_stages + n_stages - 1


def test_widened_experts_stage_rows_get_one_devices_bits(monkeypatch):
    """64 experts at D 64, B 4, one lane a stage's microbatch: the routing
    (f32 gates) and the FFN's output of `moe_ffn` on a lane's row, run at
    one device's 4 lanes (``lanes``), equal the 4-row call's at that row.
    Here, with one thread, the router's f32 product on a 1-row input gives
    other bits than inside the 4-row one, and its gates part with it."""
    cfg = _cfg(MOONSHOT, n_layers=4, n_experts=64)
    p = {k: v[0] for k, v in
         init_params(cfg, seed=0, device="cpu")["scan"]["b0"]["ffn"].items()}
    x = torch.randn((4, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    routes = []
    orig = moe.route

    def spy(*args, **kw):
        routes.append(orig(*args, **kw))
        return routes[-1]

    monkeypatch.setattr(moe, "route", spy)
    want, _ = moe.moe_ffn(x, p, cfg)
    full = routes[-1]
    for lane in range(4):
        rows = slice(lane, lane + 1)
        got, _ = moe.moe_ffn(x[rows], p, cfg, lanes=(rows, 4))
        assert torch.equal(got, want[rows])
        r = routes[-1]
        assert r.cap == full.cap
        for name in ("gates", "experts", "rank", "keep"):
            assert torch.equal(getattr(r, name)[rows],
                               getattr(full, name)[rows]), (lane, name)


@pytest.fixture(scope="module", params=[XLSTM, MOONSHOT])
def fitted(request):
    """JAX's 300-step fit of the reduced config (confident logits: random
    weights' near-ties part under any summation order), loaded into the
    port."""
    cfg = get_config(request.param).reduced()
    jm = jmake(cfg, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tmake(tget(request.param).reduced(), device="cpu"), tp


ENGINE = dict(max_batch=4, buckets=(16, 32), deadline_s=0.0,
              max_decode_len=32)


def _streams(pkg, model, params, seed=4, **kw):
    """Six affine requests, all at t = 0, through one engine: {rid:
    tokens}.  Seed 4 stays clear of the fits' exact bf16 top-2 ties (as
    in tests/test_torch_{hybrid,moe}_serving.py, which serve seeds 2 and
    4-7 on these fits plan-free)."""
    rng = np.random.default_rng(seed)
    prompts = affine_prompts(rng, 6, model.cfg.vocab_size, (4, 30))
    eng = pkg.ContinuousBatchingEngine(model, params, **ENGINE, **kw)
    for i, p in enumerate(prompts):
        eng.submit(pkg.Request(rid=i, prompt=p,
                               max_new_tokens=int(rng.integers(4, 14))))
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}, eng


def test_pipeline_engines_equal_jax_plan_free(fitted):
    """The drained engine (2 stages, dense slot rows) against the JAX
    plan-free dense-slot engine; moonshot's skewed engine (2 lane groups,
    stage-local paged arenas) against the port's plan-free paged engine,
    which tests/test_torch_moe_serving.py holds against JAX's."""
    jm, params, tm, tp = fitted
    with pinned_impl("ref"):
        want, _ = _streams(jeng, jm, params, paged=False)
    got, eng = _streams(teng, tm, tp, plan=_plan(tm.cfg, 2), paged=False)
    assert got == want
    assert eng.executor.pipeline_ticks == \
        eng.stats["decode_steps"] * pipeline_steps(2, 2)
    if tm.cfg.n_experts:
        want, _ = _streams(teng, tm, tp)
        got, eng = _streams(teng, tm, tp, plan=_plan(tm.cfg, 2, False))
        assert eng.paged and got == want
        # n*S + S - 1 ticks a dispatch of n steps
        assert eng.executor.pipeline_ticks == (
            2 * eng.stats["decode_steps"] + eng.stats["decode_dispatches"])


def test_serve_plan_equals_jax_plan_free(fitted):
    """The exact (1, 2) ``mode="serve"`` plan gives the JAX plan-free
    engine's streams: moonshot's paged cb engine, each shard running its
    block of the experts, and xlstm's dense-slot cb engine, each shard
    running its columns of the mLSTM's `up_z` and `up_g` (ROADMAP.md §1
    item 1, part (c))."""
    jm, params, tm, tp = fitted
    plan = build_plan(tm.cfg, make_mesh((1, 2), ("data", "model"),
                                        device="cpu"), mode="serve")
    with pinned_impl("ref"):
        want, _ = _streams(jeng, jm, params)
    got, eng = _streams(teng, tm, tp, plan=plan)
    assert eng.paged == bool(tm.cfg.n_experts) and got == want
    blk = eng.executor.params["scan"]["b0"]
    leaf = blk["ffn"]["wi"] if tm.cfg.n_experts else blk["mix"]["up_z"]
    assert isinstance(leaf, Shards) and len(leaf) == 2


def test_w8a8_under_a_pipeline_plan_serves_bf16(fitted):
    """A serve_pipeline plan needs the layers in whole periods (no tail),
    and W8A8 quantizes only 2-d (tail) projections: the quantized tree
    keeps every leaf, and the streams are the bf16 weights'."""
    _, _, tm, tp = fitted
    plan = _plan(tm.cfg, 2)
    got, eng = _streams(teng, tm, tp, plan=plan, quant_weights=True)
    want, _ = _streams(teng, tm, tp, plan=plan)
    assert got == want

    def leaves(tree):
        if is_quantized(tree):
            return 1
        return (sum(leaves(v) for v in tree.values())
                if isinstance(tree, dict) else 0)
    assert leaves(eng.executor.params) == 0


CLI = ["--device", "cpu", "--reduced", "--requests", "4", "--max-new", "5",
       "--plan", "serve_pipeline", "--mesh", "2"]


@pytest.mark.parametrize("arch,extra", [(XLSTM, []),
                                        (MOONSHOT, []),
                                        (MOONSHOT, ["--no-exact"])])
def test_cli_serves_the_families_on_stages(arch, extra, capsys):
    done = serve_cli.main(CLI + ["--arch", arch] + extra)
    assert len(done) == 4 and all(
        r.done and len(r.tokens_out) == r.max_new_tokens for r in done)
    out = capsys.readouterr().out
    assert (f"plan=serve_pipeline mesh={{'stage': 2}} "
            f"exact={not extra}") in out


def test_refusals():
    """recurrentgemma-2b's periods leave a tail (the reduced config: 4
    layers in periods of 3), which no stage holds: the reference's
    ValueError at the first decode, from the CLI too.  xlstm has no paged
    arena for the skewed loop.  A ``mode="serve"`` plan (1, 2) serves
    W8A8: recurrentgemma's tail MLP by its shards' blocks, smollm's (3-d)
    projections unquantized, each stream one device's W8A8 stream."""
    with pytest.raises(ValueError, match="periods to divide the stage"):
        serve_cli.main(CLI + ["--arch", "recurrentgemma-2b"])
    cfg = _cfg(XLSTM)
    model, params = tmake(cfg, device="cpu"), init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="decodes from the paged arena"):
        teng.ContinuousBatchingEngine(model, params, plan=_plan(cfg, 2, False),
                                      **ENGINE)
    tp_mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    for arch in ("recurrentgemma-2b", "smollm-135m"):
        cfg = _cfg(arch)
        model = tmake(cfg, device="cpu")
        params = init_params(cfg, device="cpu")
        want, _ = _streams(teng, model, params, quant_weights=True)
        got, eng = _streams(teng, model, params, quant_weights=True,
                            plan=build_plan(cfg, tp_mesh, mode="serve"))
        assert got == want, arch
        wi = eng.executor.params["tail"].get("0", {}).get("ffn", {}).get(
            "wi")
        assert isinstance(wi, Shards) == (arch == "recurrentgemma-2b")


def test_a_pipeline_choice_of_the_plan_search_serves():
    """`realize` on a serve_pipeline choice for moonshot builds an engine
    that serves (it raised `PlanRefused` before), and so does a bf16
    ``mode="serve"`` choice."""
    cfg = _cfg(MOONSHOT)
    model, params = tmake(cfg, device="cpu"), init_params(cfg, device="cpu")
    for cand, mesh in (
            (Candidate("serve_pipeline", stages=2, exact=False, page_size=4),
             make_mesh((2,), ("stage",), device="cpu")),
            (Candidate("serve_pipeline", stages=2, page_size=0),
             make_mesh((2,), ("stage",), device="cpu")),
            (Candidate("serve", tp=2, page_size=4),
             make_mesh((1, 2), ("data", "model"), device="cpu"))):
        score = Score(cand=cand, feasible=True)
        eng = teng.ContinuousBatchingEngine(
            model, params, plan=realize(cfg, score, mesh),
            **engine_kwargs(score), **ENGINE)
        assert eng.paged == cand.paged
        rng = np.random.default_rng(0)
        for i, p in enumerate(affine_prompts(rng, 3, cfg.vocab_size, (4, 20))):
            eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=4))
        assert [len(r.tokens_out) for r in eng.run()] == [4] * 3

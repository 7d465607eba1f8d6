"""Serve plans on the port's single-controller mesh, against the JAX
package's single-device engines.

The model is the fitted synthetic LM (`fit_affine_lm`, 300 steps in JAX,
converted by `params_from_jax`): reduced smollm-135m, 4 query heads over
2 kv heads, so a (1, 2) `model` axis divides them.  Its shards all sit on
the CPU (one process drives them, as on a card they share).

  * serve plan, exact (gather-form TP): the paged engine's streams, on
    bf16 and int8 arenas, cold and then as radix hits on the sharded
    arena, equal the JAX single-device engine's (and the port's own
    plan-free engine's); each shard's arena holds its one kv head;
  * serve plan, --no-exact (psum-form TP): token match >= 0.98 against
    the exact streams (the reference's band);
  * speculation under the serve plan (the target drafting for itself):
    its streams equal the plan's plain streams, the port's one-device
    spec streams and the JAX plain engine's, on bf16 and int8 arenas;
  * the wave engine under the serve plan equals the JAX wave engine's
    streams and one device's, its prefill run in request blocks of at
    most EXACT_ROWS_MAX rows (patched down so that the blocks run);
  * serve_pipeline (4 stages of one layer each, n_layers=4): the
    executor's pipelined loop equals `Model.decode_steps` bit for bit,
    and the engine's streams equal the JAX dense-slot engine's (the
    request-skewed form: tests/test_torch_throughput_serving.py);
  * what plans do not take yet refuses by name, and the --dryrun CLI
    prints the reference's markers.
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
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.wave import WaveEngine as JaxWave
from repro_torch.configs import get_config as tget
from repro_torch.core.cluster_builder import build_plan
from repro_torch.core.pipeline import pipeline_steps
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving.engine import ContinuousBatchingEngine as TorchEngine
from repro_torch.serving.executor import Executor
from repro_torch.serving.scheduler import Request as TorchRequest
from repro_torch.serving.wave import WaveEngine

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
# its own name: the fit is cached per config name
CFG4 = dataclasses.replace(CFG, n_layers=4, name=CFG.name + "-4l")
ENGINE = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0, page_size=4,
              num_pages=40, max_decode_len=32)


def _fit(cfg, tcfg):
    jm = jmake(cfg, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tmake(tcfg, device="cpu"), tp


@pytest.fixture(scope="module")
def models():
    return _fit(CFG, tget("smollm-135m").reduced())


@pytest.fixture(scope="module")
def models4():
    return _fit(CFG4, dataclasses.replace(tget("smollm-135m").reduced(),
                                          n_layers=4, name=CFG4.name))


def _stream(seed=3):
    """Affine prompts sharing a 24-token prefix (the radix cache's
    ingress), with their budgets.  Against JAX the seed is one whose runs
    stay clear of the fitted model's bf16 top-2 ties, as in
    tests/test_torch_serving.py: at seed 2 the port's plan-free int8
    engine already parts from JAX's on a second-pass hit, where its top
    two logits are 19.25 and 19.125 (one bf16 ulp), while the sharded
    engine equals the port's plan-free one there too."""
    rng = np.random.default_rng(seed)
    prefix = affine_prompts(rng, 1, CFG.vocab_size, (24, 25))[0]
    prompts = [np.concatenate([prefix, s]).astype(np.int32) for s in
               affine_prompts(rng, 6, CFG.vocab_size, (3, 9))]
    return [(p, int(rng.integers(8, 20))) for p in prompts]


def _streams(eng, request_cls, stream):
    for i, (p, b) in enumerate(stream):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=b))
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}


def _plan(cfg, shape=(1, 2), exact=True):
    return build_plan(cfg, make_mesh(shape, ("data", "model"), device="cpu"),
                      mode="serve", exact=exact)


@pytest.fixture(scope="module")
def jax_paged(models):
    """kv_dtype -> the JAX plan-free paged engine's streams over
    `_stream()`, a cold pass then one of radix hits (computed once)."""
    jm, params, _, _ = models
    held = {}

    def get(kv_dtype):
        if kv_dtype not in held:
            with pinned_impl("ref"):
                jeng = JaxEngine(jm, params, kv_dtype=kv_dtype, **ENGINE)
                held[kv_dtype] = [_streams(jeng, JaxRequest, _stream())
                                  for _ in range(2)]
        return held[kv_dtype]

    return get


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_serve_plan_equals_jax_single_device(models, jax_paged, kv_dtype):
    _, _, tm, tp = models
    stream = _stream()
    want = jax_paged(kv_dtype)
    single = TorchEngine(tm, tp, kv_dtype=kv_dtype, **ENGINE)
    shard = TorchEngine(tm, tp, kv_dtype=kv_dtype, plan=_plan(tm.cfg),
                        **ENGINE)
    assert shard.paged
    for p, want_pass in enumerate(want):  # cold, then radix hits
        hits = shard.stats["prefix_hits"]
        assert _streams(shard, TorchRequest, stream) == want_pass, p
        assert _streams(single, TorchRequest, stream) == want_pass, p
        if p == 1:  # every admission of the second pass hits the arena
            assert shard.stats["prefix_hits"] - hits >= len(stream) - 1
    arena = shard._slot_caches["scan"]["b0"]
    names = ("k", "v") + (("k_scale", "v_scale") if kv_dtype == "int8"
                          else ())
    for name in names:
        assert isinstance(arena[name], Shards) and len(arena[name]) == 2
        assert all(t.shape[3] == 1 for t in arena[name])  # one kv head
    assert isinstance(arena["kpos"], Shards)
    assert arena["kpos"][0] is arena["kpos"][1]  # one device: one tensor
    from repro_torch.models.shard_hints import paged_shard_ctx
    with shard.executor._ctx():
        mesh, axis, n = paged_shard_ctx()
        assert (axis, n) == ("model", 2) and mesh is shard.plan.mesh
    assert paged_shard_ctx() is None
    wq = shard.executor.params["scan"]["b0"]["mix"]["wq"]
    assert [t.shape[-1] for t in wq] == [32, 32]
    assert not isinstance(shard.executor.params["scan"]["b0"]["mix"]["wo"],
                          Shards)  # exact: replicated reduction projection


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_under_serve_plan(models, jax_paged, kv_dtype):
    """Speculation under the (1, 2) plan, the target drafting for itself:
    the draft whole on the controller, the verify pass per shard.  Cold,
    then radix hits, its streams equal the plan's plain engine's, the
    port's one-device spec engine's and the JAX plain engine's, and its
    acceptance counters the one-device spec engine's."""
    _, _, tm, tp = models
    stream, want = _stream(), jax_paged(kv_dtype)
    spec = dict(draft_model=tm, draft_params=tp, spec_k=2)
    engines = {
        "spec plan": TorchEngine(tm, tp, kv_dtype=kv_dtype, plan=_plan(
            tm.cfg), spec_config=spec, **ENGINE),
        "spec one device": TorchEngine(tm, tp, kv_dtype=kv_dtype,
                                       spec_config=spec, **ENGINE),
        "plain plan": TorchEngine(tm, tp, kv_dtype=kv_dtype,
                                  plan=_plan(tm.cfg), **ENGINE)}
    for p, want_pass in enumerate(want):  # cold, then radix hits
        for name, eng in engines.items():
            assert _streams(eng, TorchRequest, stream) == want_pass, (p, name)
    eng, one = engines["spec plan"], engines["spec one device"]
    assert eng.stats["spec_accepted"] > 0
    assert {k: v for k, v in eng.stats.items() if k.startswith("spec")} == \
        {k: v for k, v in one.stats.items() if k.startswith("spec")}
    assert not isinstance(eng._draft_slot_caches["scan"]["b0"]["k"], Shards)
    assert isinstance(eng._slot_caches["scan"]["b0"]["k"], Shards)


def test_wave_under_serve_plan(models, monkeypatch):
    """The wave engine on (1, 2), kernel 3 per shard over kv-head-sharded
    dense rows, equals the JAX wave engine's streams and one device's.
    EXACT_ROWS_MAX patched to 32: a wave of 3 prompts at bucket 32 (96
    rows) prefills in blocks of one request, at bucket 16 (48 rows) in
    blocks of two and one."""
    from repro_torch.models import layers
    jm, params, tm, tp = models
    rng = np.random.default_rng(2)
    stream = [(p[:n], int(rng.integers(4, 12))) for p, n in zip(
        affine_prompts(rng, 7, CFG.vocab_size, (30, 31)),
        (25, 12, 30, 9, 14, 6, 20))]
    kw = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0,
              max_decode_len=32)
    with pinned_impl("ref"):
        want = _streams(JaxWave(jm, params, **kw), JaxRequest, stream)
    monkeypatch.setattr(layers, "EXACT_ROWS_MAX", 32)
    sizes = []
    real = tm.prefill

    def spy(params_, caches, tokens=None, **k):
        sizes.append(tokens.shape)
        return real(params_, caches, tokens=tokens, **k)

    eng = WaveEngine(tm, tp, plan=_plan(tm.cfg), **kw)
    monkeypatch.setattr(tm, "prefill", spy)
    assert _streams(eng, TorchRequest, stream) == want
    monkeypatch.undo()
    assert sorted(set(sizes)) == [(1, 16), (1, 32), (2, 16)], sizes
    assert _streams(WaveEngine(tm, tp, **kw), TorchRequest, stream) == want
    assert isinstance(eng.executor.params["scan"]["b0"]["mix"]["wq"], Shards)


def test_no_exact_token_match_band(models):
    _, _, tm, tp = models
    stream = _stream(seed=5)
    exact = _streams(TorchEngine(tm, tp, plan=_plan(tm.cfg), **ENGINE),
                     TorchRequest, stream)
    eng = TorchEngine(tm, tp, plan=_plan(tm.cfg, exact=False), **ENGINE)
    assert isinstance(eng.executor.params["scan"]["b0"]["mix"]["wo"],
                      Shards)  # psum form: row-sharded reduction
    thr = _streams(eng, TorchRequest, stream)
    pairs = [(a, b) for k in exact for a, b in zip(exact[k], thr[k])]
    match = sum(a == b for a, b in pairs) / len(pairs)
    assert match >= 0.98, match


def test_indivisible_heads_run_unsharded_attention(models):
    """4 shards over 2 kv heads: the reference's rule keeps attention
    unsharded over a replicated arena (logged); the MLP still shards."""
    _, _, tm, tp = models
    stream = _stream(seed=3)
    want = _streams(TorchEngine(tm, tp, **ENGINE), TorchRequest, stream)
    eng = TorchEngine(tm, tp, plan=_plan(tm.cfg, (1, 4)), **ENGINE)
    assert _streams(eng, TorchRequest, stream) == want
    assert any("do not divide" in n for n in eng.executor.notes)
    assert not isinstance(eng._slot_caches["scan"]["b0"]["k"], Shards)
    assert isinstance(eng.executor.params["scan"]["b0"]["ffn"]["wi"],
                      Shards)


def test_one_wide_plan_runs_the_plain_programs(models):
    _, _, tm, tp = models
    eng = TorchEngine(tm, tp, plan=_plan(tm.cfg, (1, 1)), **ENGINE)
    assert eng.executor.params is tp
    stream = _stream(seed=4)
    assert _streams(eng, TorchRequest, stream) == _streams(
        TorchEngine(tm, tp, **ENGINE), TorchRequest, stream)


def _pipeline_plan(cfg, n=4):
    return build_plan(cfg, make_mesh((n,), ("stage",), device="cpu"),
                      mode="serve_pipeline")


def test_pipelined_loop_equals_decode_steps(models4):
    _, _, tm, tp = models4
    b, steps = 8, 8
    ex = Executor(tm, tp, plan=_pipeline_plan(tm.cfg), max_batch=b,
                  cache_len=40, buckets=(16,))
    st = ex.fresh_state(ex.init_caches(False), paged=False)
    rng = np.random.default_rng(0)
    for sl, p in enumerate(affine_prompts(rng, b, CFG.vocab_size, (5, 12))):
        logits, small = ex.prefill_prompts([p], 1, bucket_cache=True)
        st["caches"] = ex.insert(st["caches"], small, sl)
        ex.admit_lane(st, sl, int(logits[0].argmax()), -1, 4 + sl % 5)
    scan = st["caches"]["scan"]["b0"]["k"]
    assert isinstance(scan, Shards) and [t.shape[0] for t in scan] == [1] * 4
    # the same state, whole, through the plain fused loop
    plain = {"scan": {"b0": {n: torch.cat(list(t)) for n, t
                             in st["caches"]["scan"]["b0"].items()}},
             "tail": {}, "pos": st["caches"]["pos"].clone()}
    full = {k: (v if k != "scan" else
                {blk: {grp: {n: (torch.cat(list(t)) if isinstance(t, Shards)
                                 else t) for n, t in leaves.items()}
                       for grp, leaves in sub.items()}
                 for blk, sub in v.items()})
            for k, v in tp.items()}
    want, *_ = tm.decode_steps(full, plain, st["cur"].clone(),
                               st["active"].clone(), steps, eos_id=st["eos"],
                               budget=st["budget"].clone(), pad_token=0)
    got = ex.decode(st, steps, paged=False)
    assert torch.equal(got, want)
    assert ex.pipeline_ticks == steps * pipeline_steps(4, 4)


def test_pipeline_engine_equals_jax_dense_engine(models4):
    jm, params, tm, tp = models4
    rng = np.random.default_rng(1)
    stream = [(p, int(rng.integers(3, 9))) for p in
              affine_prompts(rng, 6, CFG.vocab_size, (5, 14))]
    kw = dict(max_batch=4, buckets=(16,), deadline_s=0.0, paged=False)
    with pinned_impl("ref"):
        want = _streams(JaxEngine(jm, params, **kw), JaxRequest, stream)
    eng = TorchEngine(tm, tp, plan=_pipeline_plan(tm.cfg), **kw)
    assert not eng.paged
    assert _streams(eng, TorchRequest, stream) == want
    assert eng.executor.pipeline_ticks == \
        eng.stats["decode_steps"] * pipeline_steps(4, 4)


def test_unported_plan_options_refuse(models):
    """W8A8 weights under the (1, 2) plan serve: smollm's projections are
    all stacked over layers (3-d), so nothing is quantized and the streams
    are the bf16 plan's.  The wave engine under a serve_pipeline plan
    still refuses, as the reference does."""
    _, _, tm, tp = models
    plan = _plan(tm.cfg)
    stream = _stream()
    eng = TorchEngine(tm, tp, plan=plan, quant_weights=True, **ENGINE)
    assert _streams(eng, TorchRequest, stream) == _streams(
        TorchEngine(tm, tp, plan=plan, **ENGINE), TorchRequest, stream)

    def quantized(tree):
        return isinstance(tree, dict) and ("q" in tree or any(
            quantized(v) for v in tree.values()))
    assert not quantized(eng.executor.params)
    for exact in (True, False):  # the reference's refusal, by ValueError
        pipe = build_plan(tm.cfg, make_mesh((2,), ("stage",), device="cpu"),
                          mode="serve_pipeline", exact=exact)
        with pytest.raises(ValueError, match="wave baseline"):
            WaveEngine(tm, tp, plan=pipe, max_batch=2, buckets=(16,))


def test_tp_plan_refuses_products_past_exact_rows(models):
    """A tensor-parallel serve plan runs products of at most
    EXACT_ROWS_MAX rows (the K-ordered gemm's, whose column blocks equal
    the whole product): an engine whose bucket prefills more refuses at
    construction, and a longer product inside the plan's context raises;
    a one-device plan and no plan take any bucket."""
    from repro_torch.models import layers, shard_hints
    _, _, tm, tp = models
    big = (16, layers.EXACT_ROWS_MAX + 8)
    with pytest.raises(ValueError, match="EXACT_ROWS_MAX"):
        TorchEngine(tm, tp, plan=_plan(tm.cfg), max_batch=2, buckets=big)
    TorchEngine(tm, tp, plan=build_plan(
        tm.cfg, make_mesh((1, 1), ("data", "model"), device="cpu"),
        mode="serve"), max_batch=2, buckets=big)
    TorchEngine(tm, tp, max_batch=2, buckets=big)
    x = torch.zeros((layers.EXACT_ROWS_MAX + 1, 8), dtype=torch.bfloat16)
    w = torch.zeros((8, 4), dtype=torch.bfloat16)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with shard_hints.hints(mesh, serve_exact=True):
        with pytest.raises(ValueError, match="EXACT_ROWS_MAX"):
            layers.product(x, w)
        layers.product(x[:layers.EXACT_ROWS_MAX], w)
    assert torch.equal(layers.product(x, w), x @ w)


def test_cli_plans_and_dryrun(capsys):
    base = ["--device", "cpu", "--reduced", "--requests", "3",
            "--max-new", "3"]
    serve_cli.main(base + ["--plan", "serve", "--mesh", "1,2", "--dryrun"])
    out = capsys.readouterr().out
    assert "mode=serve" in out and "paged arena" in out
    assert "scan/b0/mix/wq" in out and "'model'" in out
    assert "gather(exact)" in out
    serve_cli.main(base + ["--plan", "serve_pipeline", "--mesh", "2",
                           "--dryrun"])
    out = capsys.readouterr().out
    assert "mode=serve_pipeline" in out and "'stage'" in out
    done = {}
    for plan in (["--plan", "none"], ["--plan", "serve", "--mesh", "1,2"],
                 ["--plan", "serve_pipeline", "--mesh", "2"]):
        done[plan[1]] = [r.tokens_out for r in serve_cli.main(base + plan)]
    out = capsys.readouterr().out
    assert "plan=serve mesh={'data': 1, 'model': 2}" in out
    assert done["serve"] == done["none"] == done["serve_pipeline"]


def test_shards_index_map_and_zip():
    """The plan's leaf container: a pipeline leaf (cut over periods) gives
    the owning stage's period, a tensor-parallel one each shard's; shared
    parts stay shared through `map`; `zip_parts` lists each combination
    of distinct tensors once; the GMI points gather and sum in shard
    order."""
    from repro_torch.models.shard_hints import hint, zip_parts
    from repro_torch.models.transformer import _index

    full = torch.arange(6 * 4 * 2, dtype=torch.float32).reshape(6, 4, 2)
    stage = Shards(list(full.split(2)), "stage", 0)
    for i in range(6):
        assert torch.equal(_index({"w": stage}, i)["w"], full[i])
    tp = Shards(list(full.split(1, dim=2)), "model", 2)
    got = _index(tp, 4)
    assert isinstance(got, Shards) and got.dim == 1
    assert torch.equal(torch.cat(list(got), 1), full[4])
    rep = Shards([full, full], "model", None)
    m = rep.map(lambda t: t + 1)
    assert m[0] is m[1] and m.dim is None and len(rep.distinct()) == 1
    assert len(zip_parts(rep, tp)) == 2 and len(zip_parts(rep, None)) == 1
    parts = [torch.tensor([1.0, 2.0]), torch.tensor([3.0])]
    assert torch.equal(hint(parts, "gather"), torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(hint([parts[0], parts[0]], "psum"),
                       torch.tensor([2.0, 4.0]))
    assert hint(parts, "btd") is parts and hint(parts[:1], "gather") is \
        parts[0]

"""The MoE families under a tensor-parallel ``mode="serve"`` plan, at
`.reduced()` on the CPU, every shard on the CPU (one process drives them,
as on a card they share).

The reference never serves a MoE family under a plan in a test, so the
contract held here is the port's own: an exact plan's streams and logits
are bit for bit one device's.

  * Placement: a MoE layer's `wi` and `wg` are `Shards` of E / n experts,
    the shared experts' `shared_wi` and `shared_wg` column blocks; in an
    exact plan `wo`, the router and `shared_wo` stay whole on the
    controller; under ``exact=False`` `wo` is cut by expert and
    `shared_wo` by row.  Experts that do not divide the axis run whole,
    with a placement note.
  * `moe_ffn` on the placed leaves equals the plan-free `moe_ffn` at a
    decode step (S 1) and a bucket (S 32), with the verify pass's
    `columns` on and off; under ``exact=False`` the routed sum alone (no
    shared experts) does too: no expert's contraction is cut.
  * The paged cb engine under an exact (1, 2) plan gives the plan-free
    engine's streams, and its prefill and decode-step logits are one
    device's: moonshot-v1-16b-a3b on bf16 and int8 pages,
    llama4-maverick's two periods (4 layers) on bf16, and moonshot with
    64 experts on (1, 4), 16 experts a shard.
  * Speculation, dense slot rows and the wave engine under the exact plan
    equal their plan-free streams; ``--no-exact`` keeps a token match of
    at least 0.98 against the exact plan's streams.
  * The serve CLI serves moonshot under ``--plan serve --mesh 1,2``, with
    and without ``--no-exact``, and recurrentgemma-2b with W8A8
    weights; a plan search's bf16 ``mode="serve"`` choice serves, and so
    does its W8A8 one, with the bf16 choice's streams.
  * An exact plan keeps its reductions whole only where it drops FSDP
    (at most 8 GB of weights a shard): llama4's full-width period keeps
    FSDP on (1, 2) and not on (1, 8), the mesh the card run gates.  A
    plan that keeps FSDP says in its placement notes that its streams are
    the psum form's.

Weights are `init_params`' (seed 0).  Tolerances: none, every comparison
but the ``--no-exact`` band is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.cluster_builder import build_plan
from repro_torch.core.plan_search import (Candidate, Score, engine_kwargs,
                                          realize)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import _index, init_params, make_model
from repro_torch.serving import engine as teng
from repro_torch.serving.executor import Executor
from repro_torch.serving.wave import WaveEngine

torch.set_num_threads(1)

MOONSHOT, LLAMA4 = "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"
ENGINE = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0, page_size=4,
              num_pages=60, max_decode_len=32)
_BUILT = {}


def _model(arch, **kw):
    """(model, params) of the reduced config with `kw` replaced, built
    once a module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _BUILT:
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        _BUILT[key] = (make_model(cfg, device="cpu"),
                       init_params(cfg, seed=0, device="cpu"))
    return _BUILT[key]


def _plan(cfg, shape=(1, 2), exact=True):
    return build_plan(cfg, make_mesh(shape, ("data", "model"), device="cpu"),
                      mode="serve", exact=exact)


def _prompts(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32),
             int(rng.integers(4, 12))) for m in rng.integers(5, 30, n)]


def _streams(eng, prompts):
    for i, (p, budget) in enumerate(prompts):
        eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=budget))
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}


def _ffn(params, i=0):
    """The first MoE block's ffn leaves at layer i."""
    blk = next(b for b in params["scan"].values() if "router" in
               b.get("ffn", {}))
    return _index(blk["ffn"], i)


def _step_logits(ex, kv_dtype, prompts, teacher=None, steps=4):
    """Each prompt prefilled and admitted into its lane of a paged arena
    through `ex`, then `steps` decode steps, each fed its own argmax, or
    `teacher`'s tokens where given: the prefill logits, then each step's
    (B, V) logits."""
    cfg, ps, maxp = ex.model.cfg, 4, 12
    b = len(prompts)
    st = ex.fresh_state(ex.init_caches(True, ps, b * maxp + 1, maxp,
                                       kv_dtype=kv_dtype), paged=True)
    out = []
    with torch.no_grad():
        for sl, (p, _) in enumerate(prompts):
            pages = np.arange(1 + sl * maxp, 1 + (sl + 1) * maxp,
                              dtype=np.int32)
            lg, small = ex.prefill_prompts([p], 1, bucket_cache=True)
            ex.admit_cold(st, sl, small, pages, len(p), pages,
                          pages[:-(-32 // ps)])
            out.append(lg[0])
        out = [torch.stack(out)]
        act = torch.ones((b,), dtype=torch.bool)
        caches = st["caches"]
        for j in range(steps):
            tok = (out[-1].argmax(-1).to(torch.int32) if teacher is None
                   else teacher[j])
            with ex._ctx():
                lg, caches = ex.model.decode_step(ex.params, caches, tok,
                                                  active=act)
            out.append(lg)
    assert cfg.vocab_size == out[0].shape[-1]
    return out


@pytest.mark.parametrize("arch,kw,shape,kv_dtype", [
    pytest.param(MOONSHOT, {}, (1, 2), "bf16", id="moonshot-bf16"),
    pytest.param(MOONSHOT, {}, (1, 2), "int8", id="moonshot-int8"),
    pytest.param(LLAMA4, dict(n_layers=4), (1, 2), "bf16", id="llama4-bf16"),
    pytest.param(MOONSHOT, dict(n_experts=64), (1, 4), "bf16",
                 id="moonshot-e64-1x4")])
def test_streams_and_logits_equal_one_device(arch, kw, shape, kv_dtype):
    model, params = _model(arch, **kw)
    cfg = model.cfg
    plan = _plan(cfg, shape)
    prompts = _prompts(cfg)
    want = _streams(teng.ContinuousBatchingEngine(
        model, params, kv_dtype=kv_dtype, **ENGINE), prompts)
    eng = teng.ContinuousBatchingEngine(model, params, kv_dtype=kv_dtype,
                                        plan=plan, **ENGINE)
    assert eng.paged and _streams(eng, prompts) == want
    n = shape[1]
    wi = _ffn(eng.executor.params)["wi"]
    assert isinstance(wi, Shards) and [t.shape[0] for t in wi] == \
        [cfg.n_experts // n] * n
    one = Executor(model, params, max_batch=3)
    sharded = Executor(model, params, max_batch=3, plan=plan)
    base = _step_logits(one, kv_dtype, prompts[:3])
    got = _step_logits(sharded, kv_dtype, prompts[:3], teacher=[
        lg.argmax(-1).to(torch.int32) for lg in base[:-1]])
    for j, (a, b) in enumerate(zip(base, got)):
        assert torch.equal(a, b), j


@pytest.mark.parametrize("exact", [True, False])
def test_placement(exact):
    model, params = _model(MOONSHOT)
    cfg = model.cfg
    ex = Executor(model, params, plan=_plan(cfg, exact=exact))
    ffn = ex.params["scan"]["b0"]["ffn"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    fs = f * cfg.n_shared_experts
    for name in ("wi", "wg"):  # (L, E, D, F) by expert
        assert ffn[name].dim == 1
        assert [tuple(t.shape[1:]) for t in ffn[name]] == [(e // 2, d, f)] * 2
    for name in ("shared_wi", "shared_wg"):  # (L, D, Fs) by column
        assert [tuple(t.shape[1:]) for t in ffn[name]] == [(d, fs // 2)] * 2
    assert not isinstance(ffn["router"], Shards)
    if exact:
        for name in ("wo", "shared_wo"):
            assert not isinstance(ffn[name], Shards), name
            assert ffn[name] is params["scan"]["b0"]["ffn"][name]
    else:
        assert ffn["wo"].dim == 1 and [tuple(t.shape[1:]) for t in
                                       ffn["wo"]] == [(e // 2, f, d)] * 2
        assert ffn["shared_wo"].dim == 1 and [
            tuple(t.shape[1:]) for t in ffn["shared_wo"]] == [(fs // 2, d)] * 2
    assert not any("experts" in note or "FSDP" in note for note in ex.notes)


def test_an_exact_plan_that_keeps_fsdp_notes_its_cut_reductions():
    """A plan that keeps FSDP (the capacity rule's, forced here at the
    reduced width) cuts the reductions even when exact: the experts' `wo`
    by expert, `shared_wo` and attention's `wo` by row.  The placement
    says that its streams are the psum form's, not one device's bits."""
    model, params = _model(MOONSHOT)
    plan = dataclasses.replace(_plan(model.cfg), fsdp=True)
    ex = Executor(model, params, plan=plan)
    blk = ex.params["scan"]["b0"]
    for leaf in (blk["ffn"]["wo"], blk["ffn"]["shared_wo"], blk["mix"]["wo"]):
        assert isinstance(leaf, Shards)
    assert [n for n in ex.notes if "FSDP" in n] == [
        "plan: over 8 GB of weights a shard keeps FSDP, so the reductions"
        " are cut over 'model' (2) even in an exact plan: the streams are"
        " the psum form's, not one device's bits"]


def test_indivisible_experts_run_whole():
    """6 experts on 4 shards: the experts stay whole on the controller
    (noted), the shared experts' columns still cut, and the streams are
    one device's."""
    model, params = _model(MOONSHOT, n_experts=6)
    prompts = _prompts(model.cfg, 4, seed=1)
    eng = teng.ContinuousBatchingEngine(model, params,
                                        plan=_plan(model.cfg, (1, 4)),
                                        **ENGINE)
    ffn = eng.executor.params["scan"]["b0"]["ffn"]
    assert not isinstance(ffn["wi"], Shards)
    assert isinstance(ffn["shared_wi"], Shards)
    assert any("6 experts do not divide 'model' (4)" in n
               for n in eng.executor.notes)
    assert _streams(eng, prompts) == _streams(teng.ContinuousBatchingEngine(
        model, params, **ENGINE), prompts)


@pytest.mark.parametrize("seq", [1, 32])
@pytest.mark.parametrize("arch,kw,shape,exact", [
    pytest.param(MOONSHOT, {}, (1, 2), True, id="moonshot-exact"),
    pytest.param(MOONSHOT, dict(n_experts=64), (1, 4), True,
                 id="moonshot-e64-1x4-exact"),
    pytest.param(MOONSHOT, dict(n_shared_experts=0), (1, 2), False,
                 id="moonshot-routed-no-exact")])
def test_moe_ffn_per_shard(arch, kw, shape, exact, seq):
    model, params = _model(arch, **kw)
    cfg = model.cfg
    ex = Executor(model, params, plan=_plan(cfg, shape, exact))
    whole, placed = _ffn(params, 1), _ffn(ex.params, 1)
    assert isinstance(placed["wi"], Shards)
    assert isinstance(placed["wo"], Shards) == (not exact)
    gen = torch.Generator().manual_seed(seq)
    x = torch.randn((2, seq, cfg.d_model), generator=gen).bfloat16()
    for columns in (False, True):
        want, aux = moe.moe_ffn(x, whole, cfg, columns=columns)
        with ex._ctx():
            got, aux2 = moe.moe_ffn(x, placed, cfg, columns=columns)
        assert torch.equal(got, want), columns
        assert torch.equal(aux, aux2)


def test_spec_under_exact_plan():
    """moonshot drafting for itself (spec_k 2) under the exact (1, 2)
    plan: the draft whole on the controller, the verify pass per shard.
    Its streams equal the plan-free speculative engine's (not plain
    greedy's: a MoE verify block routes its tokens as one group,
    tests/test_torch_moe.py)."""
    model, params = _model(MOONSHOT)
    prompts = _prompts(model.cfg, seed=2)
    spec = dict(draft_model=model, draft_params=params, spec_k=2)
    want = _streams(teng.ContinuousBatchingEngine(
        model, params, spec_config=spec, **ENGINE), prompts)
    eng = teng.ContinuousBatchingEngine(model, params, spec_config=spec,
                                        plan=_plan(model.cfg), **ENGINE)
    assert _streams(eng, prompts) == want
    assert eng.stats["spec_accepted"] > 0
    assert isinstance(eng._slot_caches["scan"]["b0"]["k"], Shards)


def test_dense_slots_and_wave_under_exact_plan():
    model, params = _model(MOONSHOT)
    prompts = _prompts(model.cfg, seed=3)
    kw = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0,
              max_decode_len=32)
    plan = _plan(model.cfg)
    dense = teng.ContinuousBatchingEngine(model, params, paged=False,
                                          plan=plan, **kw)
    assert not dense.paged
    assert _streams(dense, prompts) == _streams(
        teng.ContinuousBatchingEngine(model, params, paged=False, **kw),
        prompts)
    wave = WaveEngine(model, params, plan=plan, **kw)
    assert isinstance(_ffn(wave.executor.params)["wi"], Shards)
    assert _streams(wave, prompts) == _streams(
        WaveEngine(model, params, **kw), prompts)


def test_no_exact_token_match_band():
    model, params = _model(MOONSHOT)
    prompts = _prompts(model.cfg, seed=5)
    exact = _streams(teng.ContinuousBatchingEngine(
        model, params, plan=_plan(model.cfg), **ENGINE), prompts)
    thr = _streams(teng.ContinuousBatchingEngine(
        model, params, plan=_plan(model.cfg, exact=False), **ENGINE),
        prompts)
    pairs = [(a, b) for k in exact for a, b in zip(exact[k], thr[k])]
    match = sum(a == b for a, b in pairs) / len(pairs)
    assert match >= 0.98, match


CLI = ["--device", "cpu", "--reduced", "--requests", "3", "--max-new", "4",
       "--plan", "serve", "--mesh", "1,2"]


@pytest.mark.parametrize("extra", [[], ["--no-exact"]])
def test_cli_serves_moonshot_under_a_serve_plan(extra, capsys):
    done = serve_cli.main(CLI + ["--arch", MOONSHOT] + extra)
    assert len(done) == 3 and all(
        r.done and len(r.tokens_out) == r.max_new_tokens for r in done)
    out = capsys.readouterr().out
    assert f"plan=serve mesh={{'data': 1, 'model': 2}} exact={not extra}" \
        in out


def test_cli_still_refuses_a_recurrent_family(capsys):
    """A recurrent family serves under the plan, with W8A8 weights too:
    recurrentgemma's tail MLP runs per shard (`int8_matmul` on each
    shard's block of `wi` and `wg`, `wo` whole on the controller)."""
    done = serve_cli.main(CLI + ["--arch", "recurrentgemma-2b",
                                 "--quant-weights"])
    assert len(done) == 3 and all(
        r.done and len(r.tokens_out) == r.max_new_tokens for r in done)
    out = capsys.readouterr().out
    assert "quant_weights=True" in out and "W8A8 s cut by its q's" in out


def test_plan_search_serve_choices():
    """`realize` on a bf16 ``mode="serve"`` choice for moonshot builds an
    engine that serves; so does the same choice with W8A8 weights, which
    quantizes none of moonshot's (stacked) leaves and gives the bf16
    choice's streams."""
    model, params = _model(MOONSHOT)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    score = Score(cand=Candidate("serve", tp=2, page_size=4), feasible=True)
    eng = teng.ContinuousBatchingEngine(
        model, params, plan=realize(model.cfg, score, mesh),
        **engine_kwargs(score), max_batch=3, buckets=(16, 32),
        deadline_s=0.0)
    done = _streams(eng, _prompts(model.cfg, 3, seed=6))
    assert eng.paged and len(done) == 3
    q = Score(cand=Candidate("serve", tp=2, page_size=4, quant_weights=True),
              feasible=True)
    qeng = teng.ContinuousBatchingEngine(
        model, params, plan=realize(model.cfg, q, mesh), quant_weights=True,
        **engine_kwargs(q), max_batch=3, buckets=(16, 32), deadline_s=0.0)
    assert _streams(qeng, _prompts(model.cfg, 3, seed=6)) == done


@pytest.mark.parametrize("tp,fsdp", [(2, True), (8, False)])
def test_an_exact_plan_keeps_reductions_whole_only_without_fsdp(tp, fsdp):
    """llama4-maverick's 2-layer period at full width (specs only, on meta
    tensors): on (1, 2) a shard would hold 18.6 GB of weights, so the
    plan keeps FSDP (the reference's capacity rule) and its exact plan
    cuts the reductions (the experts' `wo` by expert, `shared_wo` by row);
    on (1, 8), 4.6 GB, FSDP goes and they stay whole."""
    from repro_torch.core.cluster_builder import spec_axes
    from repro_torch.launch.mesh import make_abstract_mesh
    cfg = dataclasses.replace(get_config(LLAMA4), n_layers=2)
    plan = build_plan(cfg, make_abstract_mesh((1, tp), ("data", "model")),
                      mode="serve")
    assert plan.fsdp == fsdp
    specs = plan.specs_for_params(init_params(cfg, device="meta"))
    ffn = specs["scan"]["b1"]["ffn"]

    def cut(spec):
        return any("model" in spec_axes(e) for e in spec)

    assert cut(ffn["wi"]) and cut(ffn["shared_wi"])
    assert cut(ffn["wo"]) == fsdp and cut(ffn["shared_wo"]) == fsdp
    assert cut(specs["scan"]["b0"]["mix"]["wo"]) == fsdp

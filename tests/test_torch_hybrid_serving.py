"""recurrentgemma-2b (RG-LRU blocks and windowed attention, MQA) and
xlstm-1.3b (mLSTM and sLSTM blocks) served by the port on the dense-slot
path, at `.reduced()` on the CPU.

Neither model can use the paged arena (recurrent state and ring buffers
have no paged form), so `ContinuousBatchingEngine(paged="auto")` takes
dense slot rows: a bucketed batch-1 prefill, `insert_prefill_cache`, then
the fused decode loop; `WaveEngine` prefills each wave into dense rows.
The weights are JAX's 300-step `fit_affine_lm` fits (confident logits:
random-init near-ties would break under any summation reorder), loaded
with `params_from_jax`:

* the port's streams equal the JAX engine's on the same requests, with a
  prompt in the 64 bucket — wider than the reduced window of 32, where a
  prefill keeps only the bucket's last 32 rows (the reference's rule,
  kept: `models/attention.py`);
* the port's streams equal greedy decoding read off one `forward_logits`
  of each finished sequence; here the buckets stay at or below the
  window, since a wider bucket drops rows `forward_logits` still sees,
  and the stream's seed stays clear of the 300-step fit's exact bf16
  top-2 ties (seed 5 meets one in recurrentgemma, where the cached
  decode and the full forward sum in other orders);
* a parked lane's state and KV rows are untouched by decode steps;
* W8A8 weights (recurrentgemma's two tail MLPs through `int8_matmul`)
  keep the streams within 1% of the bf16 ones, as the reference holds
  itself (tests/test_quant_kv.py);
* under a tensor-parallel ``mode="serve"`` plan on (1, 2) the exact
  streams equal the JAX plan-free engine's (with W8A8 weights, the
  plan-free W8A8 engine's), and ``exact=False`` keeps a
  token match of at least 0.98 against them.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving import engine as jeng
from repro_torch.configs import get_config as tget
from repro_torch.models.convert import params_from_jax
from repro_torch.models.quantized import is_quantized
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving import engine as teng

torch.set_num_threads(1)

ARCHS = ["recurrentgemma-2b", "xlstm-1.3b"]


@pytest.fixture(scope="module", params=ARCHS)
def fitted(request):
    arch = request.param
    cfg = get_config(arch).reduced()
    jm = jmake(cfg, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return cfg, jm, params, tmake(tget(arch).reduced(), device="cpu"), tp


def _stream(cfg, seed, long=False):
    """Affine requests, all at t = 0; with `long`, one prompt of 40
    tokens (the 64 bucket)."""
    rng = np.random.default_rng(seed)
    prompts = affine_prompts(rng, 6, cfg.vocab_size, (4, 30))
    if long:
        prompts[2] = affine_prompts(rng, 1, cfg.vocab_size, (40, 41))[0]
    budgets = [int(rng.integers(4, 14)) for _ in prompts]
    return list(zip(prompts, budgets))


def _serve(pkg, model, params, stream, engine="cb", buckets=(16, 32),
           **kw):
    cls = (pkg.ContinuousBatchingEngine if engine == "cb"
           else pkg.WaveEngine)
    eng = cls(model, params, max_batch=3, buckets=buckets, deadline_s=0.0,
              max_decode_len=32, **kw)
    for i, (p, b) in enumerate(stream):
        eng.submit(pkg.Request(rid=i, prompt=p, max_new_tokens=b))
    done = sorted(eng.run(), key=lambda r: r.rid)
    return [list(r.tokens_out) for r in done], eng


def test_configs_agree():
    for arch in ARCHS:
        assert tget(arch).__dict__ == get_config(arch).__dict__
        assert tget(arch).reduced().__dict__ == \
            get_config(arch).reduced().__dict__


def test_engine_matches_jax_engine(fitted):
    """The dense-slot cb engine against the JAX engine (kernels pinned to
    the jnp oracle), buckets 16 / 32 / 64: identical streams and stats."""
    cfg, jm, params, tm, tp = fitted
    stream = _stream(cfg, 2, long=True)
    buckets = (16, 32, 64)
    with pinned_impl("ref"):
        want, jeng_ = _serve(jeng, jm, params, stream, buckets=buckets)
    got, eng = _serve(teng, tm, tp, stream, buckets=buckets)
    assert not eng.paged and not jeng_.paged
    assert got == want
    assert eng.stats == jeng_.stats
    assert [len(t) for t in got] == [b for _, b in stream]


def test_serve_plan_equals_jax_plan_free(fitted):
    """The port's dense-slot cb engine under a ``mode="serve"`` plan on
    (1, 2) against the JAX plan-free engine, the stream and buckets of
    `test_engine_matches_jax_engine`: the exact plan's streams are
    identical; ``exact=False`` (the reductions' row blocks summed in
    shard order) keeps a token match of at least 0.98."""
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.launch.mesh import make_mesh
    cfg, jm, params, tm, tp = fitted
    stream = _stream(cfg, 2, long=True)
    buckets = (16, 32, 64)
    with pinned_impl("ref"):
        want, _ = _serve(jeng, jm, params, stream, buckets=buckets)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    got = {}
    for exact in (True, False):
        plan = build_plan(tm.cfg, mesh, mode="serve", exact=exact)
        got[exact], eng = _serve(teng, tm, tp, stream, buckets=buckets,
                                 plan=plan)
        assert not eng.paged and eng.executor.notes
    assert got[True] == want
    pairs = [(a, b) for x, y in zip(got[False], want) for a, b in zip(x, y)]
    match = sum(a == b for a, b in pairs) / len(pairs)
    assert match >= 0.98, match


@pytest.mark.parametrize("engine", ["cb", "wave"])
def test_streams_equal_forward_logits_greedy(fitted, engine):
    """Each finished stream is the greedy argmax chain of one
    `forward_logits` over prompt + output (buckets <= the window)."""
    cfg, _, _, tm, tp = fitted
    stream = _stream(cfg, 4)
    got, _ = _serve(teng, tm, tp, stream, engine=engine)
    with torch.no_grad():
        for (prompt, _), toks in zip(stream, got):
            seq = np.concatenate([prompt, toks[:-1]]).astype(np.int64)
            logits = tm.forward_logits(tp, torch.tensor(seq)[None])[0]
            want = logits[len(prompt) - 1:].argmax(-1).tolist()
            assert toks == want, (prompt, toks, want)


def test_parked_lane_keeps_its_state(fitted):
    """decode_step with lane 1 inactive: every state leaf and KV row of
    lane 1 keeps its bits, and the active lanes' leaves move."""
    cfg, _, _, tm, tp = fitted
    rng = np.random.default_rng(3)
    with torch.no_grad():
        caches = tm.init_cache(3, 32)
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (3, 8)))
        tm.prefill(tp, caches, toks)
        before = _leaves(caches)
        act = torch.tensor([True, False, True])
        for j in range(3):
            tm.decode_step(tp, caches, toks[:, j].to(torch.int32),
                           active=act)
    after = _leaves(caches)
    for (name, axis, old), (_, _, new) in zip(before, after):
        lane = lambda t, i: t.select(axis, i)  # noqa: E731
        assert torch.equal(lane(old, 1), lane(new, 1)), name
    moved = [name for name, axis, old in before
             if not torch.equal(old.select(axis, 0),
                                dict((n, t) for n, _, t in after)[name]
                                .select(axis, 0))]
    assert any("h" in n or "C" in n for n in moved), moved


def _leaves(caches):
    """(path, batch axis, a copy) of every cache leaf but "pos"."""
    out = []
    for key, axis in (("scan", 1), ("tail", 0)):
        for blk, leaves in caches[key].items():
            for name, t in leaves.items():
                out.append((f"{key}/{blk}/{name}", axis, t.clone()))
    return out


def test_w8a8_streams_match_bf16(fitted):
    """quant_weights=True: recurrentgemma's tail MLPs run W8A8 and its
    streams agree with the bf16 weights' on >= 99% of tokens; xlstm has
    no 2-d projection, so nothing is quantized and the streams are
    equal.  Under an exact ``mode="serve"`` plan on (1, 2) the W8A8
    streams are one device's (each shard its blocks of the tail MLPs)."""
    from repro_torch.core.cluster_builder import build_plan
    from repro_torch.launch.mesh import make_mesh
    cfg, _, _, tm, tp = fitted
    stream = _stream(cfg, 13)
    bf, _ = _serve(teng, tm, tp, stream)
    qq, eng = _serve(teng, tm, tp, stream, quant_weights=True)
    plan = build_plan(tm.cfg, make_mesh((1, 2), ("data", "model"),
                                        device="cpu"), mode="serve")
    assert _serve(teng, tm, tp, stream, quant_weights=True,
                  plan=plan)[0] == qq
    quantized = [n for n, w in eng.executor.params["tail"].get(
        "0", {}).get("ffn", {}).items() if is_quantized(w)]
    assert [len(t) for t in qq] == [b for _, b in stream]
    total = sum(len(t) for t in bf)
    matched = sum(a == b for x, y in zip(bf, qq) for a, b in zip(x, y))
    if cfg.name.startswith("recurrentgemma"):
        assert sorted(quantized) == ["wg", "wi", "wo"]
        assert matched / total >= 0.99, (matched, total)
    else:
        assert quantized == [] and bf == qq


def test_refusals(fitted):
    """int8 KV pages and speculation need the paged arena, as in the
    reference; these models never get one."""
    _, _, _, tm, tp = fitted
    with pytest.raises(ValueError, match="paged"):
        teng.ContinuousBatchingEngine(tm, tp, kv_dtype="int8")
    with pytest.raises(ValueError, match="paged"):
        teng.ContinuousBatchingEngine(tm, tp, paged=True)
    with pytest.raises(ValueError, match="paged"):
        teng.ContinuousBatchingEngine(
            tm, tp, spec_config={"draft_model": tm, "draft_params": tp})


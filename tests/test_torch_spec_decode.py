"""The port's greedy speculative decoding against its own plain decoding and
against the JAX package's, on reduced smollm-135m on the CPU.

Tolerances: none — every comparison is exact.  `spec_acceptance` equals
JAX's output for output; `verify_block`'s (B, T, V) logits are
`torch.equal` to T chained `decode_step` calls on bf16 and int8 arenas;
the port's speculative streams equal its own `decode_steps` streams token
for token (random-init pairs: near-zero acceptance, and the target as its
own draft: acceptance 1.0; a fitted pair whose draft disagrees on every
value = 0 mod 2: partial acceptance); one `spec_decode_step` stream and
one spec-engine run equal JAX's (kernels pinned to the jnp oracle, on
JAX-fitted weights converted by `params_from_jax`), streams and `spec_*`
stats alike.  The draft-arena page accounting repeats the reference's
cases on the port's `KVManager`.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models import transformer as jtr
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config as tget
from repro_torch.models import synthetic as tsyn
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ContinuousBatchingEngine as TorchEngine
from repro_torch.serving.kv_manager import (KVManager, kv_page_bytes,
                                            spec_pool_split)
from repro_torch.serving.scheduler import Request as TorchRequest

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
TCFG = tget("smollm-135m").reduced()
DCFG = dataclasses.replace(TCFG, name=TCFG.name + "-draft", n_layers=1)
JDCFG = dataclasses.replace(CFG, name=CFG.name + "-draft", n_layers=1)
NUM_PAGES = 20
SPEC_STATS = ("spec_accepted", "spec_proposed", "spec_dispatches",
              "spec_draft_prefills", "spec_catchup_tokens")


def _i32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32)


# ---------------------------------------------------------------------------
# spec_acceptance
# ---------------------------------------------------------------------------

# the reference's four unit cases (tests/test_spec_decode.py): full and
# divergent acceptance, EOS and budget exits, a forced queue swallowing
# then emitting, an inactive lane
UNIT_CASES = {
    "full_and_divergent": dict(ins=[[5, 10, 11], [5, 20, 99]],
                               tgt=[[10, 11, 12], [20, 21, 22]]),
    "eos_and_budget": dict(ins=[[5, 10, 7], [5, 20, 21]],
                           tgt=[[10, 7, 12], [20, 21, 22]],
                           rem=[100, 1], eos=[7, -1]),
    "forced_queue": dict(ins=[[5, 8, 9]], tgt=[[50, 51, 52]],
                         forced=[[8, 9, 0, 0]], flen=[2], fptr=[0],
                         rem=[10]),
    "inactive_lane": dict(ins=[[5, 6, 7]], tgt=[[1, 2, 3]],
                          active=[False]),
}


def _random_block(seed):
    """A random block: B=6 lanes, T=5, tokens from a 4-symbol alphabet (so
    drafts match often), mixed budgets, EOS ids, forced queues and
    inactive lanes."""
    rng = np.random.default_rng(seed)
    b, t, fcap = 6, 5, 4
    tgt = rng.integers(0, 4, (b, t))
    ins = np.concatenate([rng.integers(0, 4, (b, 1)),
                          np.where(rng.random((b, t - 1)) < 0.7, tgt[:, :-1],
                                   rng.integers(0, 4, (b, t - 1)))], 1)
    return dict(ins=ins, tgt=tgt, active=rng.random(b) < 0.8,
                rem=rng.integers(1, 6, b), eos=rng.integers(-1, 4, b),
                forced=rng.integers(0, 4, (b, fcap)),
                flen=rng.integers(0, fcap + 1, b),
                fptr=rng.integers(0, 2, b))


def _acceptance_args(c):
    b = len(c["ins"])
    return (c["ins"], c["tgt"], c.get("active", [True] * b),
            c.get("rem", [100] * b), c.get("eos", [-1] * b),
            c.get("forced", [[0]] * b), c.get("flen", [0] * b),
            c.get("fptr", [0] * b))


@pytest.mark.parametrize("case", list(UNIT_CASES) + [f"random{s}"
                                                     for s in range(6)])
def test_spec_acceptance_matches_jax(case):
    c = (UNIT_CASES[case] if case in UNIT_CASES
         else _random_block(int(case[len("random"):])))
    ins, tgt, act, rem, eos, forced, flen, fptr = _acceptance_args(c)
    want = jtr.spec_acceptance(
        jnp.asarray(ins, jnp.int32), jnp.asarray(tgt, jnp.int32),
        jnp.asarray(act, bool), jnp.asarray(rem, jnp.int32),
        jnp.asarray(eos, jnp.int32), 0, jnp.asarray(forced, jnp.int32),
        jnp.asarray(flen, jnp.int32), jnp.asarray(fptr, jnp.int32))
    got = ttr.spec_acceptance(
        _i32(ins), _i32(tgt), torch.as_tensor(np.asarray(act, bool)),
        _i32(rem), _i32(eos), 0, _i32(forced), _i32(flen), _i32(fptr))
    for name, w, g in zip(("emit", "cur", "alive", "remaining", "fptr",
                           "n_consumed"), want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), (case, name)


# ---------------------------------------------------------------------------
# the port against itself: verify == chained steps, spec == decode_steps
# ---------------------------------------------------------------------------

B, PS, MAXP = 2, 4, 16
PROMPT = np.array([[5, 7, 9], [11, 3, 2]], np.int32)


def _paged(model, kv_dtype):
    """The reference test's arena: lanes 0 and 1 own pages 1-8 and 9-16."""
    c = model.init_paged_cache(B, B * 8 + 1, PS, MAXP, kv_dtype)
    pt = np.zeros((B, MAXP), np.int32)
    pt[0, :8] = np.arange(1, 9)
    pt[1, :8] = np.arange(9, 17)
    c["pt"] = _i32(pt)
    return c


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_verify_block_equals_chained_decode_steps(kv_dtype):
    model = ttr.make_model(TCFG, device="cpu")
    params = ttr.init_params(TCFG, seed=0, device="cpu")
    tokens = _i32(np.random.default_rng(3).integers(0, 256, (B, 5)))
    active = torch.tensor([True, True])
    with torch.no_grad():
        seq = _paged(model, kv_dtype)
        steps = []
        for j in range(tokens.shape[1]):
            lg, seq = model.decode_step(params, seq, tokens[:, j], active)
            steps.append(lg)
        ver = _paged(model, kv_dtype)
        logits, ver = model.verify_block(params, ver, tokens, active)
    assert torch.equal(logits, torch.stack(steps, 1))
    assert torch.equal(ver["pos"], torch.zeros(B, dtype=torch.int32))
    for name in seq["scan"]["b0"]:  # the same rows, scales and kpos
        assert torch.equal(seq["scan"]["b0"][name], ver["scan"]["b0"][name])


def _spec_vs_sequential(model, params, draft, dparams, k, kv_dtype,
                        budgets=(9, 6)):
    """Drive spec_decode_step to drain and return (its streams, the
    decode_steps streams), a 3-token prompt ingested through the forced
    queue on both paths."""
    forced = np.zeros((B, 32), np.int32)
    forced[:, :2] = PROMPT[:, 1:]
    forced, flen = _i32(forced), torch.full((B,), 2, dtype=torch.int32)
    token, active = _i32(PROMPT[:, 0]), torch.ones((B,), dtype=torch.bool)
    eos = torch.full((B,), -1, dtype=torch.int32)
    budget = _i32(budgets)
    zero = torch.zeros((B,), dtype=torch.int32)
    with torch.no_grad():
        ref, *_ = model.decode_steps(
            params, _paged(model, kv_dtype), token, active, 16, eos_id=eos,
            budget=budget, forced=forced, forced_len=flen, forced_ptr=zero)
        st_c, st_d = _paged(model, kv_dtype), _paged(draft, kv_dtype)
        cur, act, rem, fptr = token, active, budget, zero
        out = [[] for _ in range(B)]
        for _ in range(24):
            toks, cur, act, rem, fptr, st_c, st_d, _ = \
                model.spec_decode_step(
                    params, st_c, cur, act, k, draft, dparams, st_d,
                    eos_id=eos, budget=rem, forced=forced, forced_len=flen,
                    forced_ptr=fptr)
            for lane in range(B):
                out[lane].extend(int(t) for t in toks[:, lane] if t >= 0)
            if not bool(act.any()):
                break
    want = [[int(t) for t in ref[:, lane] if t >= 0] for lane in range(B)]
    return out, want


# the reference's trimmed cross-product: every k in {1, 2, 4, 8}, both
# draft kinds and both arena dtypes
@pytest.mark.parametrize("k,draft_kind,kv_dtype", [
    (1, "random", "bf16"), (8, "random", "bf16"), (4, "self", "bf16"),
    (2, "random", "int8"), (4, "self", "int8"),
])
def test_spec_stream_equals_decode_steps(k, draft_kind, kv_dtype):
    model = ttr.make_model(TCFG, device="cpu")
    params = ttr.init_params(TCFG, seed=0, device="cpu")
    if draft_kind == "self":  # acceptance exactly 1.0: the bonus path
        draft, dparams = model, params
    else:  # random init: near-zero acceptance, the all-rejected path
        draft = ttr.make_model(DCFG, device="cpu")
        dparams = ttr.init_params(DCFG, seed=1, device="cpu")
    out, want = _spec_vs_sequential(model, params, draft, dparams, k,
                                    kv_dtype)
    assert out == want


def test_spec_stream_equals_decode_steps_mid_acceptance():
    """The port's own fits: a clean target and a 1-layer draft fitted on
    a corpus deviated at every value = 0 (mod 2), which agree on only
    part of the greedy steps: partial-acceptance blocks."""
    model = ttr.make_model(TCFG, device="cpu")
    params = tsyn.fit_affine_lm(model, steps=300)
    draft = ttr.make_model(DCFG, device="cpu")
    dparams = tsyn.fit_affine_lm(draft, steps=300, disagree_every=2)
    out, want = _spec_vs_sequential(model, params, draft, dparams, 4,
                                    "bf16", budgets=(12, 9))
    assert out == want


def test_verify_products_run_at_decode_rows(monkeypatch):
    """Reduced minitron-8b (squared-ReLU 2-matrix MLP, untied head): every
    product of a verify pass — q/k/v/o, the MLP and the head — runs once
    over its B*T rows (a contiguous (B, T, d) input), each row summed as
    the decode step's row of a B-row product is (the K-ordered gemm
    kernel on the card; torch.matmul here), and its logits equal the
    chained decode steps' bit for bit."""
    cfg = tget("minitron-8b").reduced()
    model = ttr.make_model(cfg, device="cpu")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    t = 5
    tokens = _i32(np.random.default_rng(4).integers(0, 256, (B, t)))
    rows = []
    matmul = torch.matmul

    def spy(a, b, *args, **kw):
        rows.append((tuple(a.shape), a.is_contiguous()))
        return matmul(a, b, *args, **kw)

    with torch.no_grad():
        seq = _paged(model, "bf16")
        steps = [model.decode_step(params, seq, tokens[:, j])[0]
                 for j in range(t)]
        monkeypatch.setattr(torch, "matmul", spy)
        logits, _ = model.verify_block(params, _paged(model, "bf16"),
                                       tokens)
        monkeypatch.setattr(torch, "matmul", matmul)
    products = cfg.n_layers * (4 + 2) + 1  # attention, MLP, head
    assert len(rows) == products
    assert all(shape[:2] == (B, t) and contiguous
               for shape, contiguous in rows), rows
    assert torch.equal(logits, torch.stack(steps, 1))


def test_self_draft_spec_engine_equals_plain_minitron():
    """Reduced minitron-8b drafting for itself through the spec engine:
    every stream equals the plain engine's (acceptance is 1.0 but for
    blocks a budget cuts short)."""
    cfg = tget("minitron-8b").reduced()
    model = ttr.make_model(cfg, device="cpu")
    params = ttr.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    stream = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
               int(rng.integers(6, 14))) for n in rng.integers(4, 20, 5)]

    def serve(spec):
        kw = (dict(spec_config=dict(draft_model=model, draft_params=params,
                                    spec_k=3)) if spec else {})
        eng = TorchEngine(model, params, max_batch=3, buckets=(16, 32),
                          deadline_s=0.0, page_size=4, max_decode_len=32,
                          **kw)
        for i, (p, b) in enumerate(stream):
            eng.submit(TorchRequest(rid=i, prompt=p, max_new_tokens=b))
        return [r.tokens_out for r in eng.run()], eng.stats

    plain, _ = serve(False)
    spec, stats = serve(True)
    assert spec == plain
    assert stats["spec_dispatches"] > 0
    assert 0 < stats["spec_accepted"] <= stats["spec_proposed"]


# ---------------------------------------------------------------------------
# the port against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted():
    """JAX-fitted target and mid-acceptance draft (disagree_every=2), in
    both packages' layouts."""
    jm, jd = jtr.make_model(CFG, remat=False), jtr.make_model(JDCFG,
                                                              remat=False)
    jp = fit_affine_lm(jm, steps=300)
    jdp = fit_affine_lm(jd, steps=300, disagree_every=2)

    def conv(p):
        return params_from_jax(jax.tree.map(np.asarray, p), device="cpu")

    return (jm, jp, jd, jdp, ttr.make_model(TCFG, device="cpu"), conv(jp),
            ttr.make_model(DCFG, device="cpu"), conv(jdp))


def test_spec_decode_step_matches_jax(fitted):
    jm, jp, jd, jdp, tm, tp, td, tdp = fitted
    k, n_blocks = 4, 4
    pt = np.zeros((B, MAXP), np.int32)
    pt[0, :8], pt[1, :8] = np.arange(1, 9), np.arange(9, 17)
    forced = np.zeros((B, 32), np.int32)
    forced[:, :2] = PROMPT[:, 1:]
    state = dict(token=PROMPT[:, 0], active=np.ones(B, bool),
                 budget=np.array([12, 9], np.int32),
                 eos=np.full(B, -1, np.int32), forced=forced,
                 flen=np.full(B, 2, np.int32), fptr=np.zeros(B, np.int32))

    def jax_run():
        def fresh(m):
            return dict(m.init_paged_cache(B, B * 8 + 1, PS, MAXP),
                        pt=jnp.asarray(pt))
        c, d = fresh(jm), fresh(jd)
        cur, act, rem, fptr = (jnp.asarray(state[n]) for n in
                               ("token", "active", "budget", "fptr"))
        blocks = []
        with pinned_impl("ref"):
            for _ in range(n_blocks):
                toks, cur, act, rem, fptr, c, d, v = jm.spec_decode_step(
                    jp, c, cur, act, k, jd, jdp, d,
                    eos_id=jnp.asarray(state["eos"]), budget=rem,
                    forced=jnp.asarray(forced),
                    forced_len=jnp.asarray(state["flen"]), forced_ptr=fptr)
                blocks.append((np.asarray(toks), np.asarray(v)))
        return blocks

    def torch_run():
        c, d = _paged(tm, "bf16"), _paged(td, "bf16")
        cur, act, rem, fptr = (torch.as_tensor(state[n]) for n in
                               ("token", "active", "budget", "fptr"))
        blocks = []
        with torch.no_grad():
            for _ in range(n_blocks):
                toks, cur, act, rem, fptr, c, d, v = tm.spec_decode_step(
                    tp, c, cur, act, k, td, tdp, d,
                    eos_id=torch.as_tensor(state["eos"]), budget=rem,
                    forced=torch.as_tensor(forced),
                    forced_len=torch.as_tensor(state["flen"]),
                    forced_ptr=fptr)
                blocks.append((toks.numpy(), v.numpy()))
        return blocks

    want, got = jax_run(), torch_run()
    for (wt, wv), (gt, gv) in zip(want, got):
        assert np.array_equal(wt, gt) and np.array_equal(wv, gv)
    # partial acceptance happened: some block consumed fewer than k + 1
    assert any((v < k + 1).any() and (v > 1).any() for _, v in got[1:])


def _stream(seed=6):
    """Affine requests (the fitted model's own distribution), then
    shared-prefix ones whose suffixes ride the forced queue, FIFO.  The
    300-step fits still emit exact or one-ulp bf16 top-2 ties on some
    streams (target and draft alike), which the two packages' summation
    orders break differently: a draft tie moves only the acceptance
    count, a target tie the stream.  The seed is one whose runs stay
    clear of them, as in tests/test_torch_serving.py; in the tight pool
    (NUM_PAGES) lanes starve, are preempted and catch their drafts up."""
    rng = np.random.default_rng(seed)
    prompts = affine_prompts(rng, 6, CFG.vocab_size, (4, 20))
    prefix = affine_prompts(rng, 1, CFG.vocab_size, (16, 17))[0]
    prompts += [np.concatenate([prefix, s]).astype(np.int32) for s in
                affine_prompts(rng, 4, CFG.vocab_size, (3, 9))]
    return [(p, int(rng.integers(6, 18))) for p in prompts]


def _serve(engine_cls, request_cls, model, params, draft, dparams, stream):
    eng = engine_cls(model, params, max_batch=3, buckets=(16, 32),
                     deadline_s=0.0, page_size=4, num_pages=NUM_PAGES,
                     max_decode_len=32,
                     spec_config=dict(draft_model=draft,
                                      draft_params=dparams, spec_k=2))
    for i, (p, b) in enumerate(stream):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=b))
    return eng.run(), eng.stats


def test_spec_engine_matches_jax_engine(fitted):
    jm, jp, jd, jdp, tm, tp, td, tdp = fitted
    stream = _stream()
    with pinned_impl("ref"):
        jdone, jstats = _serve(JaxEngine, JaxRequest, jm, jp, jd, jdp,
                               stream)
    tdone, tstats = _serve(TorchEngine, TorchRequest, tm, tp, td, tdp,
                           stream)
    assert [r.tokens_out for r in tdone] == [r.tokens_out for r in jdone]
    assert all(r.done and len(r.tokens_out) == b
               for r, (_, b) in zip(tdone, stream))
    assert {k: tstats[k] for k in SPEC_STATS} == \
        {k: jstats[k] for k in SPEC_STATS}
    assert tstats["prefix_hits"] > 0 and tstats["preemptions"] > 0
    assert tstats["spec_catchup_tokens"] > 0
    assert 0 < tstats["spec_accepted"] < tstats["spec_proposed"]


# ---------------------------------------------------------------------------
# the draft arena's page accounting (the reference's cases)
# ---------------------------------------------------------------------------


def test_kv_manager_draft_arena_alloc_release_drain():
    kv = KVManager(num_pages=16, page_size=4, max_batch=2, max_pages=8,
                   draft_num_pages=8)
    g = kv.admit(np.arange(6, dtype=np.int32), rem_budget=6,
                 max_hit_suffix=8, spec_margin=4)
    assert g is not None
    # 6 prompt + 6 budget + 4 spec margin = 16 positions = 4 pages each
    assert len(g.pages) == 4 and len(g.draft_pages) == 4
    assert g.draft_pt_row[:4].tolist() == g.draft_pages
    assert g.draft_reset[:4].tolist() == g.draft_pages
    kv.commit(0, g)
    assert kv.draft_pool.pages_in_use == 4
    kv.release(0)
    assert kv.draft_pool.pages_in_use == 0
    kv.assert_drained()


def test_kv_manager_draft_starvation_rolls_back_admission():
    kv = KVManager(num_pages=64, page_size=4, max_batch=4, max_pages=16,
                   draft_num_pages=6)
    prompt = np.arange(8, dtype=np.int32)
    g = kv.admit(prompt, rem_budget=8, max_hit_suffix=16, spec_margin=0)
    assert g is not None and len(g.draft_pages) == 4
    kv.commit(0, g)
    kv.register_prefix(prompt, g.pages)
    in_use_before = kv.pool.pages_in_use
    # a radix hit that finds only 2 free draft pages of the 4 it needs
    # declines as a unit, its hit references dropped
    assert kv.admit(prompt, rem_budget=8, max_hit_suffix=16,
                    spec_margin=0) is None
    assert kv.pool.pages_in_use == in_use_before
    assert kv.draft_pool.pages_in_use == 4
    kv.release(0)
    kv.assert_drained()


def test_spec_pool_split_partitions_budget():
    ps = 16
    per = kv_page_bytes(TCFG, ps, "bf16") + kv_page_bytes(DCFG, ps, "bf16")
    budget = 64 * kv_page_bytes(TCFG, ps, "bf16")
    n = spec_pool_split(TCFG, DCFG, ps, "bf16", budget)
    assert n * per <= budget < (n + 1) * per
    assert n > 64 // 4  # the 1-layer draft's pages are cheaper


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_serve_cli_speculates_on_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--draft-config", "smollm-135m", "--spec-k", "4",
         "--requests", "6"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300,
        check=True).stdout
    line = out.strip().splitlines()[-1]
    assert line.startswith("serve[cb]:") and "requests=6" in line
    for key in ("'spec_dispatches'", "'spec_accepted'", "'spec_proposed'",
                "'spec_draft_prefills'", "'spec_catchup_tokens'"):
        assert key in line, key

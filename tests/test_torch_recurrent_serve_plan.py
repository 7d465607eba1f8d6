"""The recurrent families under a tensor-parallel ``mode="serve"`` plan,
at `.reduced()` on the CPU, every shard on the CPU (one process drives
them, as on a card they share).

The reference never serves a recurrent family under a plan in a test, so
the contract held here is the port's own: an exact plan's streams and
logits are bit for bit one device's.

  * Placement (`Executor._tp_dim`, `cluster_builder.DEPARTURES`): the RG-LRU's
    `w_gate_in`, `w_x_in`, `conv`, `lam` and state by width, `w_rgate` and
    `w_igate` by column (the reference cuts their rows); the mLSTM's
    `up_z`, `up_g` by column, its cell, `wq`, `wk`, `wv` and state whole
    on the controller (the reference cuts `ih`, `dk` and heads); the
    sLSTM cell and its state whole on the controller, `glu_wi` by column;
    recurrentgemma's one-kv-head attention whole.  The reductions are whole in an exact plan and cut
    by row under ``exact=False``.  Params, slot caches and bucket caches
    alike, each departure noted.
  * `rglru_block`, `mlstm_block` and `slstm_block` on the placed leaves
    equal the plan-free blocks, output and state, at a decode step and a
    bucket of 32 with trailing pads, from a state; one mLSTM block at
    xlstm-1.3b's full width on (1, 4), one head's columns a shard, too.
  * The dense-slot cb engine under an exact plan gives the plan-free
    engine's streams, and its decode steps' logits are one device's
    (recurrentgemma on (1, 2), xlstm on (1, 2) and (1, 4)); the wave
    engine too; a parked lane keeps its RG-LRU state on every shard.
  * The serve CLI serves both families under ``--plan serve --mesh 1,2``,
    with and without ``--no-exact``; a plan search's bf16 choice serves,
    and so does its W8A8 one, with one device's W8A8 streams.
  * W8A8 (recurrentgemma's tail MLP, `models/quantized.py`): each shard
    holds its column block of `wi` and `wg` (`q` column-major, with its
    columns of `s`), `wo` whole in an exact plan and by row (with the
    whole `s`) under ``exact=False``; an exact plan's streams and logits
    are one device's, and under ``exact=False`` the quantized MLP is one
    device's too (int32 partial sums); `int8_matmul` runs 2n + 1 times a
    MLP in an exact plan on n shards and 3n times under ``exact=False``.

Weights are `init_params`' (seed 0).  Tolerances: none, every comparison
is exact.
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
from repro_torch.models import recurrent as rec
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import (_index, cache_map, init_params,
                                            make_model)
from repro_torch.serving import engine as teng
from repro_torch.serving.executor import Executor
from repro_torch.serving.wave import WaveEngine

torch.set_num_threads(1)

RG, XLSTM = "recurrentgemma-2b", "xlstm-1.3b"
ENGINE = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0,
              max_decode_len=32)
BLOCKS = {"rglru": rec.rglru_block, "mlstm": rec.mlstm_block,
          "slstm": rec.slstm_block}
_BUILT = {}


def _model(arch, **kw):
    """(model, params) of the reduced config (or `arch`'s full config
    with `kw` replaced, when kw names `full`), built once a module."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _BUILT:
        full = kw.pop("full", False)
        cfg = get_config(arch) if full else get_config(arch).reduced()
        cfg = dataclasses.replace(cfg, **kw)
        _BUILT[key] = (make_model(cfg, device="cpu"),
                       init_params(cfg, seed=0, device="cpu"))
    return _BUILT[key]


def _plan(cfg, shape=(1, 2), exact=True):
    return build_plan(cfg, make_mesh(shape, ("data", "model"), device="cpu"),
                      mode="serve", exact=exact)


def _whole(t):
    """A placed leaf as one tensor: a cut `Shards`' parts joined on its
    dim, a whole one's first part."""
    if not isinstance(t, Shards):
        return t
    return t[0] if t.dim is None else torch.cat(list(t), t.dim)


def _dims(tree):
    """{path: the dim a leaf is cut on, or None} over a placed tree."""
    if isinstance(tree, dict):
        return {(k,) + p: d for k, v in tree.items()
                for p, d in _dims(v).items()}
    return {(): tree.dim if isinstance(tree, Shards) else None}


# the port's cut, per (block kind, leaf), past the layer axis: exact /
# exact=False; None is whole
RG_WANT = {"w_gate_in": 1, "w_x_in": 1, "conv": 1, "lam": 0, "w_rgate": 1,
           "w_igate": 1, "w_out": (None, 0), "wo": (None, 0), "wi": 1,
           "wg": 1}
XLSTM_WANT = {"up_z": 1, "up_g": 1, "wq": None, "wk": None, "wv": None,
              "w_if": None, "down": (None, 0), "w_in": None, "r": None,
              "glu_wi": 1, "glu_wo": None}
STATE_WANT = {"rglru": {"h": 1, "conv": 2}, "attn": {},
              "mlstm": {"C": None, "n": None, "m": None},
              "slstm": {"h": None, "c": None, "n": None, "m": None}}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("arch,shape", [(RG, (1, 2)), (XLSTM, (1, 2)),
                                        (XLSTM, (1, 4))])
def test_placement(arch, shape, exact):
    model, params = _model(arch)
    cfg, n = model.cfg, shape[1]
    ex = Executor(model, params, max_batch=3, cache_len=48,
                  plan=_plan(cfg, shape, exact))
    want = RG_WANT if arch == RG else XLSTM_WANT
    for path, dim in _dims(ex.params).items():
        if path[0] not in ("scan", "tail") or path[2] == "norm1" or \
                path[2] == "norm2":
            continue
        off = 1 if path[0] == "scan" else 0
        attn = cfg.block_kind(int(path[1].lstrip("b"))) == "attn"
        w = None if attn and path[2] == "mix" else want[path[-1]]
        w = w[0 if exact else 1] if isinstance(w, tuple) else w
        leaf = _index_path(ex.params, path)
        if w is not None and _whole(leaf).shape[w + off] % n:  # 170 GLU
            w = None
        assert dim == (None if w is None else w + off), (path, dim)
    for caches in (ex.init_caches(False), ex.place_caches(
            model.init_cache(1, 32), False, slot_table=False)):
        for path, dim in _dims(caches).items():
            if path[0] not in ("scan", "tail"):
                continue
            off = 1 if path[0] == "scan" else 0
            kind = cfg.block_kind(int(path[1].lstrip("b")))
            w = STATE_WANT[kind].get(path[-1])
            assert dim == (None if w is None else w + off), (path, dim)
    notes = " ".join(ex.notes)
    if arch == RG:
        assert "4 heads / 1 kv heads do not divide 'model' (2)" in notes
        assert "rglru w_rgate by column" in notes
    else:
        for leaf in ("C", "n", "m", "wq", "wk", "wv"):
            assert f"mlstm {leaf} whole on the controller" in notes
        assert "slstm h whole on the controller" in notes


def _index_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _random_caches(model, b, seed):
    """A dense cache tree of `b` lanes whose recurrent states hold random
    values (n >= 0, as a cell's normaliser is)."""
    caches = model.init_cache(b, 32)
    gen = torch.Generator().manual_seed(seed)

    def fill(axis, t):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
        return t
    cache_map(fill, caches)
    for blk in list(caches["scan"].values()) + list(caches["tail"].values()):
        if "C" in blk or "c" in blk:
            blk["n"].abs_()
    return caches


def _block_case(model, params, shape, seq, seed=0):
    """Each recurrent block of the first layer period on its placed leaves
    against the plan-free block, from a random state: B 3, `seq` steps,
    lane 1 padded after 3 steps (at S 1: a pad step)."""
    cfg = model.cfg
    ex = Executor(model, params, max_batch=3, plan=_plan(cfg, shape))
    caches = _random_caches(model, 3, seed)
    placed = ex.place_caches(cache_map(lambda a, t: t.clone(), caches),
                             False, slot_table=False)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((3, seq, cfg.d_model), generator=gen).bfloat16()
    valid = torch.ones((3, seq), dtype=torch.bool)
    valid[1, min(3, seq - 1) if seq > 1 else 0:] = False
    checked = []
    for j in range(len(params["scan"])):
        kind = cfg.block_kind(j)
        if kind not in BLOCKS:
            continue
        want_p = _index(params["scan"][f"b{j}"], 0)["mix"]
        got_p = _index(ex.params["scan"][f"b{j}"], 0)["mix"]
        want_s = _index(caches["scan"][f"b{j}"], 0)
        got_s = _index(placed["scan"][f"b{j}"], 0)
        y, st = BLOCKS[kind](x, want_p, cfg, dict(want_s), valid)
        with ex._ctx():
            y2, st2 = BLOCKS[kind](x, got_p, cfg, dict(got_s), valid)
        assert torch.equal(y, y2), (kind, seq)
        for k in st:
            assert isinstance(st2[k], Shards) == isinstance(got_s[k],
                                                            Shards), k
            assert torch.equal(st[k], _whole(st2[k])), (kind, k, seq)
        checked.append(kind)
    return checked


@pytest.mark.parametrize("seq", [1, 32])
@pytest.mark.parametrize("arch,shape", [(RG, (1, 2)), (XLSTM, (1, 2)),
                                        (XLSTM, (1, 4))])
def test_blocks_per_shard(arch, shape, seq):
    model, params = _model(arch)
    kinds = _block_case(model, params, shape, seq)
    assert set(kinds) == ({"rglru"} if arch == RG else {"mlstm", "slstm"})


@pytest.mark.parametrize("seq", [1, 32])
def test_full_width_mlstm_one_head_a_shard(seq):
    """One mLSTM block at xlstm-1.3b's full width (D 2048, 4 heads of ih
    1024, dk 512; a vocabulary of 256 to keep the embeddings small), B 8,
    on (1, 4): one head's columns of `up_z` and `up_g` a shard, gathered
    before the cell runs whole on the controller, give one device's
    bits, output and state (the state stays whole)."""
    model, params = _model(XLSTM, full=True, n_layers=1, vocab_size=256)
    cfg = model.cfg
    ex = Executor(model, params, max_batch=8, plan=_plan(cfg, (1, 4)))
    p, placed = params["tail"]["0"]["mix"], ex.params["tail"]["0"]["mix"]
    assert [tuple(t.shape) for t in placed["up_z"]] == [(2048, 1024)] * 4
    caches = _random_caches(model, 8, seq)
    state = caches["tail"]["0"]
    got_state = ex.place_caches(cache_map(lambda a, t: t.clone(), caches),
                                False, slot_table=False)["tail"]["0"]
    gen = torch.Generator().manual_seed(seq)
    x = torch.randn((8, seq, cfg.d_model), generator=gen).bfloat16()
    valid = torch.ones((8, seq), dtype=torch.bool)
    valid[3, seq // 2:] = False
    y, st = rec.mlstm_block(x, p, cfg, dict(state), valid)
    with ex._ctx():
        y2, st2 = rec.mlstm_block(x, placed, cfg, dict(got_state), valid)
    assert torch.equal(y, y2)
    for k in st:
        assert not isinstance(st2[k], Shards), k
        assert torch.equal(st[k], st2[k]), k


def _prompts(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(m)).astype(np.int32),
             int(rng.integers(4, 12))) for m in rng.integers(5, 30, n)]


def _streams(eng, prompts):
    for i, (p, budget) in enumerate(prompts):
        eng.submit(teng.Request(rid=i, prompt=p, max_new_tokens=budget))
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}


def _step_logits(ex, prompts, teacher=None, steps=4, park=None):
    """Each prompt prefilled and inserted into its dense slot row through
    `ex`, then `steps` decode steps, each fed its own argmax, or
    `teacher`'s tokens where given; lane `park` inactive throughout.
    Returns (the prefill logits, then each step's (B, V) logits; the
    cache tree)."""
    b = len(prompts)
    st = ex.fresh_state(ex.init_caches(False), paged=False)
    out = []
    with torch.no_grad():
        for sl, (p, _) in enumerate(prompts):
            lg, small = ex.prefill_prompts([p], 1, bucket_cache=True)
            st["caches"] = ex.insert(st["caches"], small, sl)
            out.append(lg[0])
        out = [torch.stack(out)]
        act = torch.ones((b,), dtype=torch.bool)
        if park is not None:
            act[park] = False
        caches = st["caches"]
        for j in range(steps):
            tok = (out[-1].argmax(-1).to(torch.int32) if teacher is None
                   else teacher[j])
            with ex._ctx():
                lg, caches = ex.model.decode_step(ex.params, caches, tok,
                                                  active=act)
            out.append(lg)
    return out, caches


@pytest.mark.parametrize("arch,shape", [(RG, (1, 2)), (XLSTM, (1, 2)),
                                        (XLSTM, (1, 4))])
def test_streams_and_logits_equal_one_device(arch, shape):
    model, params = _model(arch)
    cfg = model.cfg
    plan = _plan(cfg, shape)
    prompts = _prompts(cfg)
    want = _streams(teng.ContinuousBatchingEngine(model, params, **ENGINE),
                    prompts)
    eng = teng.ContinuousBatchingEngine(model, params, plan=plan, **ENGINE)
    assert not eng.paged and _streams(eng, prompts) == want
    one = Executor(model, params, max_batch=3, cache_len=48)
    sharded = Executor(model, params, max_batch=3, cache_len=48, plan=plan)
    base, _ = _step_logits(one, prompts[:3])
    got, _ = _step_logits(sharded, prompts[:3], teacher=[
        lg.argmax(-1).to(torch.int32) for lg in base[:-1]])
    for j, (a, b) in enumerate(zip(base, got)):
        assert torch.equal(a, b), j


def test_a_parked_lane_keeps_its_state_on_every_shard():
    """recurrentgemma on (1, 2): a lane held inactive for 3 decode steps
    keeps its RG-LRU state (`h` and `conv`, cut by width) on both shards,
    while an active lane's moves."""
    model, params = _model(RG)
    cfg = model.cfg
    ex = Executor(model, params, max_batch=3, cache_len=48,
                  plan=_plan(cfg))
    prompts = _prompts(cfg, 3, seed=1)
    _, before = _step_logits(ex, prompts, steps=0)
    kept = cache_map(lambda a, t: t.map(lambda p: p.clone())
                     if isinstance(t, Shards) else t.clone(), before)
    _, after = _step_logits(ex, prompts, steps=3, park=1)
    h = after["scan"]["b0"]["h"]
    assert isinstance(h, Shards) and len(h) == 2
    for blk in after["scan"]:
        if cfg.block_kind(int(blk.lstrip("b"))) != "rglru":
            continue
        for k, leaf in after["scan"][blk].items():
            for p, q in zip(leaf if isinstance(leaf, Shards) else [leaf],
                            kept["scan"][blk][k] if isinstance(
                                leaf, Shards) else [kept["scan"][blk][k]]):
                assert torch.equal(p[:, 1], q[:, 1]), (blk, k)
                assert not torch.equal(p[:, 0], q[:, 0]), (blk, k)


def test_indivisible_mlstm_heads_run_whole():
    """4 mLSTM heads on 3 shards: neither the heads nor `up_z`'s 128
    columns divide the axis, so the mLSTM's leaves and state stay whole
    on the controller, where its cell runs at every mesh, and the
    streams are one device's."""
    model, params = _model(XLSTM)
    prompts = _prompts(model.cfg, 4, seed=2)
    eng = teng.ContinuousBatchingEngine(model, params,
                                        plan=_plan(model.cfg, (1, 3)),
                                        **ENGINE)
    mix = eng.executor.params["scan"]["b0"]["mix"]
    assert not any(isinstance(v, Shards) for v in mix.values())
    state = eng.executor.init_caches(False)["scan"]["b0"]
    assert not any(isinstance(v, Shards) for v in state.values())
    assert _streams(eng, prompts) == _streams(
        teng.ContinuousBatchingEngine(model, params, **ENGINE), prompts)


def test_wave_under_exact_plan():
    model, params = _model(RG)
    prompts = _prompts(model.cfg, seed=3)
    kw = dict(max_batch=3, buckets=(16, 32), deadline_s=0.0,
              max_decode_len=32)
    wave = WaveEngine(model, params, plan=_plan(model.cfg), **kw)
    assert isinstance(wave.executor.params["scan"]["b0"]["mix"]["w_rgate"],
                      Shards)
    assert _streams(wave, prompts) == _streams(
        WaveEngine(model, params, **kw), prompts)


CLI = ["--device", "cpu", "--reduced", "--requests", "3", "--max-new", "4",
       "--plan", "serve", "--mesh", "1,2"]


@pytest.mark.parametrize("extra", [[], ["--no-exact"]])
@pytest.mark.parametrize("arch", [XLSTM, RG])
def test_cli_serves_under_a_serve_plan(arch, extra, capsys):
    done = serve_cli.main(CLI + ["--arch", arch] + extra)
    assert len(done) == 3 and all(
        r.done and len(r.tokens_out) == r.max_new_tokens for r in done)
    out = capsys.readouterr().out
    assert f"plan=serve mesh={{'data': 1, 'model': 2}} exact={not extra}" \
        in out


def test_plan_search_serve_choices():
    """`realize` on a bf16 ``mode="serve"`` choice (dense slots) for
    recurrentgemma builds an engine that serves; the same choice with
    W8A8 weights (its tail MLPs) serves one device's W8A8 streams."""
    model, params = _model(RG)
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    score = Score(cand=Candidate("serve", tp=2, page_size=0), feasible=True)
    eng = teng.ContinuousBatchingEngine(
        model, params, plan=realize(model.cfg, score, mesh),
        **engine_kwargs(score), max_batch=3, buckets=(16, 32),
        deadline_s=0.0)
    done = _streams(eng, _prompts(model.cfg, 3, seed=6))
    assert not eng.paged and len(done) == 3
    q = Score(cand=Candidate("serve", tp=2, page_size=0, quant_weights=True),
              feasible=True)
    kw = dict(**engine_kwargs(q), max_batch=3, buckets=(16, 32),
              deadline_s=0.0, quant_weights=True)
    qeng = teng.ContinuousBatchingEngine(
        model, params, plan=realize(model.cfg, q, mesh), **kw)
    prompts = _prompts(model.cfg, 3, seed=6)
    assert _streams(qeng, prompts) == _streams(
        teng.ContinuousBatchingEngine(model, params, **kw), prompts)


def _int8_launches(monkeypatch):
    """A list that grows by one at every `ops.int8_matmul` call."""
    from repro_torch.kernels import ops
    calls, real = [], ops.int8_matmul

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)
    monkeypatch.setattr(ops, "int8_matmul", spy)
    return calls


@pytest.mark.parametrize("exact", [True, False])
def test_w8a8_under_a_serve_plan(exact, monkeypatch):
    """recurrentgemma's tail MLP with W8A8 weights on (1, 2): the
    placement of each {"q", "s"} block, `layers.mlp` on the placed leaves
    equal to one device's W8A8 MLP bit for bit with 2n + 1 (exact) or 3n
    `int8_matmul` calls, and (exact) the engine's streams and the decode
    steps' logits equal one device's."""
    from repro_torch.models.layers import mlp
    model, params = _model(RG)
    cfg, n = model.cfg, 2
    plan = _plan(cfg, (1, n), exact)
    one = Executor(model, params, max_batch=3, cache_len=48,
                   quant_weights=True)
    ex = Executor(model, params, max_batch=3, cache_len=48, plan=plan,
                  quant_weights=True)
    ffn, whole = ex.params["tail"]["0"]["ffn"], one.params["tail"]["0"]["ffn"]
    for name in ("wi", "wg"):
        leaf = ffn[name]
        assert isinstance(leaf, Shards) and leaf.dim == 1
        for i, blk in enumerate(leaf):
            cols = slice(i * cfg.d_ff // n, (i + 1) * cfg.d_ff // n)
            assert blk["q"].t().is_contiguous(), name
            assert torch.equal(blk["q"], whole[name]["q"][:, cols])
            assert torch.equal(blk["s"], whole[name]["s"][:, cols])
    wo = ffn["wo"]
    if exact:
        assert not isinstance(wo, Shards) and torch.equal(
            wo["q"], whole["wo"]["q"])
    else:
        assert isinstance(wo, Shards) and wo.dim == 0
        for i, blk in enumerate(wo):
            rows = slice(i * cfg.d_ff // n, (i + 1) * cfg.d_ff // n)
            assert blk["q"].t().is_contiguous()
            assert torch.equal(blk["q"], whole["wo"]["q"][rows])
            assert torch.equal(blk["s"], whole["wo"]["s"])
    gen = torch.Generator().manual_seed(5)
    for seq in (1, 32):
        x = torch.randn((3, seq, cfg.d_model), generator=gen).bfloat16()
        want = mlp(x, whole, cfg)
        calls = _int8_launches(monkeypatch)
        with ex._ctx():
            got = mlp(x, ffn, cfg)
        assert torch.equal(want, got), seq
        assert len(calls) == (2 * n + 1 if exact else 3 * n), calls
        monkeypatch.undo()
    if not exact:
        return
    prompts = _prompts(cfg)
    kw = dict(ENGINE, quant_weights=True)
    assert _streams(teng.ContinuousBatchingEngine(
        model, params, plan=plan, **kw), prompts) == _streams(
        teng.ContinuousBatchingEngine(model, params, **kw), prompts)
    base, _ = _step_logits(one, prompts[:3])
    got, _ = _step_logits(ex, prompts[:3], teacher=[
        lg.argmax(-1).to(torch.int32) for lg in base[:-1]])
    for j, (a, b) in enumerate(zip(base, got)):
        assert torch.equal(a, b), j


def test_mlstm_head_probe():
    """chip_smoke.py's mLSTM head probe, run on the CPU: at xlstm-1.3b's
    widths it runs every form of the cell over blocks of nh/2 and nh/4
    heads at a decode step and prefill chunks of 32 and 128 steps, and
    counts, within each form's outputs, those that part from the nh-head
    call (logged: the plan runs the cell whole, so no count is held)."""
    import chip_smoke
    table = chip_smoke.mlstm_head_probe(torch.device("cpu"))
    want = [(name, b, s) for b, s in chip_smoke.MLSTM_PROBE
            for name, _, _ in chip_smoke.MLSTM_FORMS]
    assert [row[:3] for row in table] == want
    for name, b, s, p2, p4, outputs in table:
        assert 0 <= p2 <= outputs and 0 <= p4 <= outputs, (name, b, s)

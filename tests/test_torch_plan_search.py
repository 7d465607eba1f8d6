"""The port's plan search (`repro_torch.core.plan_search`) and the rest of
its latency model against the reference's, on the CPU.

(a) Given the same `BlockCosts` and hardware table, the port's search
    equals the reference's field for field, for every decoder config x
    four profiles: every `Score`, the frontier, the choice and the
    snapshot.  Both sides are fed the reference's costs, counted under
    `pinned_impl("ref")` (the port's kernels are counted through their
    plain versions, so that is the impl the port is held to), through
    `block_costs.__wrapped__` so the reference's cache never holds
    ref-impl counts; the table is the reference's TPU v5e one.
(b) The reference's own cases (tests/test_plan_search.py) against the
    port's functions, with the port's own counts and the H100 table, at
    the reference's default budget of 8 x 16 GB.
(c) The latency model, port equal to the reference, on the paper's
    Table 1/2 fixtures (tests/test_latency_model.py).
"""
import dataclasses
import functools

import pytest

from repro.configs import get_config as jget
from repro.core import latency_model as jlat
from repro.core import plan_search as jps
from repro.kernels.ops import pinned_impl
from repro.roofline import analysis as janalysis
from repro_torch.configs import get_config, list_archs
from repro_torch.core import latency_model as tlat
from repro_torch.core import plan_search as tps
from repro_torch.core.latency_model import (StageTiming,
                                            decode_step_latency,
                                            pipeline_ticks_per_step,
                                            total_latency)
from repro_torch.core.plan_search import (Candidate, DeviceCalibration,
                                          HardwareModel, PlanSearchError,
                                          TrafficProfile, X_FRACTION, choose,
                                          diff_snapshots, engine_kwargs,
                                          enumerate_candidates,
                                          pareto_frontier,
                                          predict_engine_tok_s, realize,
                                          search, to_snapshot)
from repro_torch.roofline import analysis as tanalysis

DECODERS = [a for a in list_archs() if a != "ibert-base"]
# the reference's default profile, and devices 1, 2 and 4 at 80 GB each
PROFILES = [{}] + [dict(devices=n, hbm_gb=80.0) for n in (1, 2, 4)]


@functools.lru_cache(maxsize=None)
def _jax_costs(arch: str):
    with pinned_impl("ref"):
        return jps.block_costs.__wrapped__(jget(arch))


def _jax_search(cfg, profile, hw, costs):
    """The reference's search, from its own parts, on the costs given."""
    scores = [jps.score_candidate(cfg, c, profile, hw, costs)
              for c in jps.enumerate_candidates(cfg, profile)]
    return jps.SearchResult(profile=profile, scores=scores,
                            frontier=jps.pareto_frontier(scores),
                            chosen=jps.choose(scores, profile))


def _fields(score):
    return None if score is None else dataclasses.asdict(score)


def test_hardware_table_is_the_h100s():
    hw = HardwareModel()
    assert hw.peak_flops == 989e12 and hw.peak_flops_int8 == 1979e12
    assert hw.hbm_bw == 3.35e12 and hw.link_bw == 450e9
    assert hw.hop_s == pytest.approx(1.1e-6)  # the paper's d, not the card's
    # measured on the card: below the spread of a host-bound step
    assert hw.dispatch_s == tps.DISPATCH_S == 0.0
    assert TrafficProfile().hbm_bytes == tps.CARD_HBM_BYTES  # the card's
    assert TrafficProfile().devices == 8  # the reference's declared budget
    assert tps.COST_MODEL_VERSION == jps.COST_MODEL_VERSION == 3


@pytest.mark.parametrize("arch", DECODERS)
def test_search_equals_reference_on_equal_costs(arch, monkeypatch):
    jcfg, cfg = jget(arch), get_config(arch)
    jcosts = _jax_costs(arch)
    costs = tps.BlockCosts(**dataclasses.asdict(jcosts))
    monkeypatch.setattr(tps, "block_costs", lambda c, cache_len=512: costs)
    jhw = jps.HardwareModel()
    assert (jhw.peak_flops, jhw.hbm_bw, jhw.link_bw) == (
        janalysis.PEAK_FLOPS_BF16, janalysis.HBM_BW, janalysis.ICI_BW)
    hw = HardwareModel(**dataclasses.asdict(jhw))
    for over in PROFILES:
        jprof = dataclasses.replace(jps.TrafficProfile(), **over)
        prof = TrafficProfile.from_dict(jprof.to_dict())
        want = _jax_search(jcfg, jprof, jhw, jcosts)
        got = search(cfg, prof, hw)
        assert [_fields(s) for s in got.scores] == \
            [_fields(s) for s in want.scores], over
        assert [s.key for s in got.frontier] == \
            [s.key for s in want.frontier], over
        assert _fields(got.chosen) == _fields(want.chosen), over
        assert to_snapshot(cfg, got) == jps.to_snapshot(jcfg, want), over


def test_helpers_equal_reference():
    for arch in DECODERS:
        jcfg, cfg = jget(arch), get_config(arch)
        assert tps._reduction_frac(cfg) == jps._reduction_frac(jcfg)
        for c in enumerate_candidates(cfg, TrafficProfile(devices=8)):
            jc = jps.Candidate(**dataclasses.asdict(c))
            assert tps._kv_shards(cfg, c) == jps._kv_shards(jcfg, jc)
            assert c.key == jc.key and c.width == jc.width
    for kw in (dict(t_step_s=2e-3, t_dispatch_s=5e-3, t_prefill_s=3e-3),
               dict(t_step_s=1e-3, t_dispatch_s=0.0)):
        a = predict_engine_tok_s(DeviceCalibration(**kw), n_requests=16,
                                 total_tokens=800, prompt_tokens=640,
                                 max_batch=4, horizon=8)
        b = jps.predict_engine_tok_s(jps.DeviceCalibration(**kw),
                                     n_requests=16, total_tokens=800,
                                     prompt_tokens=640, max_batch=4,
                                     horizon=8)
        assert a == b
    assert DeviceCalibration.from_two_point(0.011, 1, 0.025, 8, 0.004) == \
        DeviceCalibration(**dataclasses.asdict(
            jps.DeviceCalibration.from_two_point(0.011, 1, 0.025, 8, 0.004)))
    assert tps.PREDICTION_BAND == jps.PREDICTION_BAND
    for r in (0.4, 0.5, 1.3, 2.0, 2.1):
        assert tps.prediction_ratio_ok(r) == jps.prediction_ratio_ok(r)


# ---------------------------------------------------------------------------
# (b) the reference's cases, against the port's functions
# ---------------------------------------------------------------------------

SMALL = get_config("smollm-135m")
PROFILE = TrafficProfile(hbm_gb=16.0)  # the reference's 8 x 16 GB


@pytest.fixture(scope="module")
def result():
    return search(SMALL, PROFILE)


def test_search_deterministic(result):
    again = search(SMALL, PROFILE)
    assert to_snapshot(SMALL, result) == to_snapshot(SMALL, again)
    assert [s.key for s in result.frontier] == [s.key for s in again.frontier]
    assert result.chosen.key == again.chosen.key


def test_snapshot_diff_clean_and_drifted(result):
    snap = to_snapshot(SMALL, result)
    hard, info = diff_snapshots(snap, snap)
    assert hard == [] and info == []
    drifted = dict(snap, chosen=dict(snap["chosen"], key="serve.tp8.other"))
    hard, _ = diff_snapshots(snap, drifted)
    assert any("chosen.key" in line for line in hard)
    # predicted-number movement alone is informational, not hard drift
    wobble = dict(snap, chosen=dict(
        snap["chosen"],
        predicted={k: v * 1.5 for k, v in snap["chosen"]["predicted"].items()}))
    hard, info = diff_snapshots(snap, wobble)
    assert hard == [] and info


def test_profile_rejects_unknown_keys(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"arrival_rate": 2.0, "hbm_gigs": 99}')
    with pytest.raises(PlanSearchError, match="hbm_gigs"):
        TrafficProfile.from_json(str(p))


def test_400b_on_small_budget_never_selects_oom_plan():
    """A 400B-class config on an 8 x 16 GB budget cannot fit even int8
    weights on any enumerated candidate: every candidate is pruned."""
    big = get_config("llama4-maverick-400b-a17b")
    res = search(big, PROFILE)
    assert res.chosen is None
    assert res.n_feasible == 0
    assert res.frontier == []
    assert all("weights" in s.reason or "KV" in s.reason
               for s in res.scores)


def test_feasible_candidates_fit_the_budget(result):
    for s in result.scores:
        if s.feasible:
            assert 0.0 < s.hbm_frac <= 1.0, s.key
            assert s.lanes >= 1
            assert s.cand.width * s.replicas <= PROFILE.devices


def test_bigger_budget_is_monotone():
    """Growing the HBM budget can only keep or grow the feasible set."""
    big = get_config("phi3-medium-14b")
    lo = search(big, dataclasses.replace(PROFILE, hbm_gb=8.0))
    hi = search(big, dataclasses.replace(PROFILE, hbm_gb=32.0))
    feas_lo = {s.key for s in lo.scores if s.feasible}
    feas_hi = {s.key for s in hi.scores if s.feasible}
    assert feas_lo <= feas_hi


def _dominates(a, b):
    ge = (a.tok_s >= b.tok_s and a.ttft_ms <= b.ttft_ms
          and a.hbm_frac <= b.hbm_frac)
    gt = (a.tok_s > b.tok_s or a.ttft_ms < b.ttft_ms
          or a.hbm_frac < b.hbm_frac)
    return ge and gt


def test_frontier_is_nondominated_and_covers_chosen(result):
    front = result.frontier
    assert front, "the profile must admit at least one candidate"
    for s in front:
        assert s.feasible
        assert not any(_dominates(o, s) for o in front if o is not s)
    # every feasible non-frontier point is dominated by some frontier point
    feas = [s for s in result.scores if s.feasible]
    fkeys = {s.key for s in front}
    for s in feas:
        if s.key not in fkeys:
            assert any(_dominates(f, s) for f in front), s.key
    # the chosen plan is itself Pareto-optimal
    assert result.chosen.key in fkeys


def test_choose_respects_ttft_target(result):
    tight = min(s.ttft_ms for s in result.scores if s.feasible) * 1.01
    prof = dataclasses.replace(PROFILE, ttft_target_ms=tight)
    ch = choose(result.scores, prof)
    assert ch.ttft_ms <= tight
    # unconstrained choice is the global tok/s argmax
    best = max(s.tok_s for s in result.scores if s.feasible)
    assert choose(result.scores, PROFILE).tok_s == best


def test_pareto_frontier_empty_when_nothing_feasible():
    assert pareto_frontier([]) == []


def test_exact_and_throughput_both_enumerated():
    cands = enumerate_candidates(SMALL, PROFILE)
    serve = [c for c in cands if c.mode == "serve"]
    pipe = [c for c in cands if c.mode == "serve_pipeline"]
    assert {c.exact for c in serve if c.tp > 1} == {True, False}
    assert {c.exact for c in pipe} == {True, False}
    # the declared grid axes all vary
    assert {c.page_size for c in cands} >= {8, 16, 32}
    assert {c.kv_dtype for c in cands} == {"bf16", "int8"}
    assert {c.quant_weights for c in cands} == {True, False}
    assert len({c.tp for c in serve}) > 1
    # exact pipelines stream dense slots (the engine turns paging off)
    assert all(c.page_size == 0 and c.kv_dtype == "bf16"
               for c in pipe if c.exact)
    # int8 KV only rides the paged pool
    assert all(c.page_size > 0 for c in cands if c.kv_dtype == "int8")
    assert len(cands) == len(set(cands))


def test_stage_depths_divide_the_layer_stack():
    cands = enumerate_candidates(SMALL, PROFILE)  # 30-layer stack
    depths = {c.stages for c in cands if c.mode == "serve_pipeline"}
    assert depths == {2}  # of divisors(8), only 2 divides 30
    cfg48 = get_config("moonshot-v1-16b-a3b")  # 48 layers
    depths48 = {c.stages for c in enumerate_candidates(cfg48, PROFILE)
                if c.mode == "serve_pipeline"}
    assert depths48 == {2, 4, 8}


def test_realize_and_engine_kwargs(result):
    plan = realize(SMALL, result.chosen)
    cand = result.chosen.cand
    assert plan.mode == cand.mode
    assert plan.exact == cand.exact
    assert plan.mesh.abstract
    kw = engine_kwargs(result.chosen)
    assert kw["paged"] == cand.paged
    if cand.paged:
        assert kw["page_size"] == cand.page_size
        assert kw["kv_dtype"] == cand.kv_dtype


def test_realize_refuses_a_disagg_candidate(result):
    cand = Candidate(mode="serve", page_size=8, disagg_prefill=1,
                     disagg_decode=1)
    score = dataclasses.replace(result.chosen, cand=cand)
    with pytest.raises(PlanSearchError, match="--disagg 1:1 --plan none"):
        realize(SMALL, score)
    assert engine_kwargs(score)["disagg"] == (1, 1)


def test_pipeline_fill_matches_table2_fixture():
    """The search prices pipeline TTFT with the same Eq. 1 the paper's
    Table 2 validates: T=209789cy, X=111708cy @5ns, d=1.1us, L=12
    -> 7.193 ms within 2%."""
    cyc = 5e-9
    t = StageTiming(T=209789 * cyc, X=111708 * cyc, d=1.1e-6)
    assert abs(total_latency(t, 12) - 7.193e-3) / 7.193e-3 < 0.02
    # the X~=0.53T §9 fit the search substitutes when only T is known
    fitted = StageTiming(T=t.T, X=X_FRACTION * t.T, d=t.d)
    assert abs(total_latency(fitted, 12)
               - total_latency(t, 12)) / total_latency(t, 12) < 0.02


def test_pipeline_ticks_per_step_schedules():
    assert pipeline_ticks_per_step(1, exact=True) == 1
    assert pipeline_ticks_per_step(6, exact=True) == 11   # drained 2S-1
    assert pipeline_ticks_per_step(6, exact=False) == 6   # skewed S
    t_stage, d = 209789 * 5e-9, 1.1e-6
    drained = decode_step_latency(t_stage, 6, d, exact=True)
    skewed = decode_step_latency(t_stage, 6, d, exact=False)
    assert drained == pytest.approx(11 * (t_stage + d))
    assert skewed == pytest.approx(6 * (t_stage + d))
    assert skewed < drained


def test_hardware_model_hop_is_the_papers_d():
    hw = HardwareModel()
    assert hw.hop_s == pytest.approx(1.1e-6)
    # int8 tensor-core mma: ~2x the bf16 rate on the card
    assert hw.peak(True) == tanalysis.PEAK_FLOPS_INT8
    assert hw.peak(False) == tanalysis.PEAK_FLOPS_BF16
    assert hw.peak(True) == pytest.approx(2 * hw.peak(False), rel=1e-3)


def test_search_prices_exact_pipeline_above_skewed():
    """Same knobs, drained vs skewed schedule: the 2S-1 tick exact
    pipeline can never out-throughput the S-tick skewed one under the
    same profile."""
    cfg = get_config("moonshot-v1-16b-a3b")
    res = search(cfg, PROFILE)
    by_key = {s.key: s for s in res.scores}
    for s in res.scores:
        c = s.cand
        if (c.mode == "serve_pipeline" and not c.exact and s.feasible
                and c.kv_dtype == "bf16" and not c.quant_weights):
            twin = dataclasses.replace(c, exact=True, page_size=0)
            ex = by_key.get(twin.key)
            if ex is not None and ex.feasible:
                assert s.tok_s >= ex.tok_s, (s.key, ex.key)


def test_two_point_calibration_recovers_costs():
    step, disp = 2e-3, 5e-3
    cal = DeviceCalibration.from_two_point(disp + 1 * step, 1,
                                           disp + 8 * step, 8)
    assert cal.t_step_s == pytest.approx(step)
    assert cal.t_dispatch_s == pytest.approx(disp)


def test_predict_engine_tok_s_scales_sanely():
    cal = DeviceCalibration(t_step_s=2e-3, t_dispatch_s=0.0,
                            t_prefill_s=3e-3)
    kw = dict(n_requests=16, total_tokens=800, prompt_tokens=640,
              max_batch=4, horizon=8)
    base = predict_engine_tok_s(cal, **kw)
    faster = predict_engine_tok_s(
        DeviceCalibration(1e-3, 0.0, 3e-3), **kw)
    assert faster > base > 0
    # dispatch overhead can only slow the prediction down
    lossy = predict_engine_tok_s(
        DeviceCalibration(2e-3, 5e-3, 3e-3), **kw)
    assert lossy < base


# ---------------------------------------------------------------------------
# (c) the latency model, port equal to the reference
# ---------------------------------------------------------------------------

CYC = 5e-9  # Table 1/2's cycles at 200 MHz
TIMINGS = [(209789 * CYC, 111708 * CYC, 1.1e-6),  # seq 128
           (6936 * CYC, 6936 * CYC, 1.1e-6),      # seq 1
           (494e-6, 260e-6, 1.1e-6), (1 / 2023.47, 0.0, 0.0)]


@pytest.mark.parametrize("t,x,d", TIMINGS)
def test_latency_model_equals_reference(t, x, d):
    a, b = tlat.StageTiming(T=t, X=x, d=d), jlat.StageTiming(T=t, X=x, d=d)
    assert a.I == b.I == 0.0
    for n in (1, 6, 12):
        assert tlat.total_latency(a, n) == jlat.total_latency(b, n)
    for items in (1, 4):
        assert tlat.throughput(a, items) == jlat.throughput(b, items)
    assert tlat.fit_x_fraction([x], [t]) == jlat.fit_x_fraction([x], [t])


def test_latency_model_fixtures_equal_reference():
    t_by_seq = {1: 6936 * CYC, 128: 209789 * CYC}
    x_by_seq = {1: 6936 * CYC, 128: 111708 * CYC}
    got = tlat.estimate_table2(t_by_seq, x_by_seq, d=1.1e-6, n_stages=12)
    assert got == jlat.estimate_table2(t_by_seq, x_by_seq, d=1.1e-6,
                                       n_stages=12)
    assert set(got) == {1, 128} and got[128] > got[1]
    assert abs(got[128] - 7.193e-3) / 7.193e-3 < 0.02
    assert abs(got[1] - 0.416e-3) / 0.416e-3 < 0.03
    f = tlat.fit_x_fraction([111708.0], [209789.0])
    assert f == jlat.fit_x_fraction([111708.0], [209789.0])
    assert abs(f - 0.5325) < 0.01
    xs, ts = [1.0, 2.0, 3.5], [2.0, 3.0, 7.0]
    assert tlat.fit_x_fraction(xs, ts) == jlat.fit_x_fraction(xs, ts)
    assert tlat.throughput(tlat.StageTiming(T=494e-6, X=260e-6, d=1.1e-6)) \
        == 1 / 494e-6
    assert tlat.StageTiming(T=1.0, X=0.5, d=0.0, I=0.25).I == \
        jlat.StageTiming(T=1.0, X=0.5, d=0.0, I=0.25).I

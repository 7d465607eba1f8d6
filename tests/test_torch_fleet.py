"""The port's fleet (`serving/replica.py`, `serving/router.py`) and its
stream generators, against the JAX package's and against the port's own
plain engine.

* The four generators (`multi_prefix_requests`, `bursty_requests`,
  `clone_requests`, `replay`'s clones) draw the reference's requests for
  one `np.random.default_rng(seed)`: the same prompts, budgets and
  arrivals, exactly.
* The router's decisions (kind, replica, expected_hit_tokens, shed
  reason) equal the JAX router's on the same request sequence, with
  engines built and nothing run: placement reads only the schedulers'
  host-side load signals.
* A fleet only chooses where a request runs: the 1- and 2-replica
  fleets' streams equal the plain engine's bit for bit, also with each
  replica under its own 1x1 plan on a device group.
* On the fitted synthetic LM (`fit_affine_lm`, JAX-fitted params
  converted by `params_from_jax`) the 2-replica fleet's greedy streams
  match the JAX fleet's at token match rate 1.0, with the same decisions
  and prefix hits.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro.serving import router as jrouter
from repro.serving import stream as jstream
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as tget
from repro_torch.core.cluster_builder import build_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params, make_model
from repro_torch.serving import stream as tstream
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.replica import (Replica, make_group_mesh,
                                         replica_device_groups)
from repro_torch.serving.router import (AffinityIndex, FleetConfig,
                                        build_fleet)
from repro_torch.serving.scheduler import Request

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
ENGINE_KW = dict(max_batch=2, buckets=(16, 32, 64), num_pages=64)


@pytest.fixture(scope="module")
def setup():
    cfg = tget("smollm-135m").reduced()
    return cfg, make_model(cfg, device="cpu"), init_params(cfg, seed=0,
                                                            device="cpu")


@pytest.fixture(scope="module")
def jax_setup():
    return jmake(CFG, remat=False), jinit(CFG, jax.random.PRNGKey(0))


def _clone(reqs):
    return tstream.clone_requests(reqs)


def _streams(fleet_or_engine, reqs):
    for r in _clone(reqs):
        fleet_or_engine.submit(r)
    return {r.rid: tuple(r.tokens_out) for r in fleet_or_engine.run()}


# -- the stream generators against the reference's ----------------------------


def _fields(reqs):
    return [(r.rid, r.prompt.dtype, tuple(r.prompt.tolist()),
             r.max_new_tokens, r.eos_id, r.t_arrival) for r in reqs]


@pytest.mark.parametrize("name,kw", [
    ("multi_prefix_requests", dict(n=12, n_prefixes=3, prefix_len=24,
                                   suffix_range=(2, 6), budgets=(3, 7))),
    ("multi_prefix_requests", dict(n=16, n_prefixes=4, prefix_len=64,
                                   suffix_range=(4, 12), budgets=16,
                                   rate=20.0)),
    ("bursty_requests", dict(n=12, short_range=(10, 16),
                             long_range=(180, 240), burst_every=4,
                             burst_size=2, budgets=(8, 16))),
    ("bursty_requests", dict(n=20, rate=50.0)),
    ("bursty_requests", dict(n=9, burst_every=3, burst_size=5, budgets=4,
                             rate=5.0)),
])
def test_stream_generators_match_the_reference(name, kw, seed=3):
    n = kw.pop("n")
    want = getattr(jstream, name)(np.random.default_rng(seed), n,
                                  CFG.vocab_size, **kw)
    got = getattr(tstream, name)(np.random.default_rng(seed), n,
                                 CFG.vocab_size, **kw)
    assert len(got) == n
    assert _fields(got) == _fields(want)
    assert all(isinstance(r, Request) for r in got)
    clones = tstream.clone_requests(got)
    assert _fields(clones) == _fields(jstream.clone_requests(want))
    assert all(c is not r and not c.tokens_out for c, r in zip(clones, got))


def test_bursty_refuses_overlapping_ranges():
    with pytest.raises(ValueError, match="overlap"):
        tstream.bursty_requests(np.random.default_rng(0), 4, 100,
                                short_range=(8, 40), long_range=(30, 60))


def test_replay_measures_a_second_pass(setup):
    cfg, model, params = setup
    reqs = tstream.shared_prefix_requests(np.random.default_rng(0), 3,
                                          cfg.vocab_size, prefix_len=24,
                                          budgets=3)
    eng = ContinuousBatchingEngine(model, params, **ENGINE_KW)
    done, wall, tok_s, ttft = tstream.replay(eng, reqs)
    assert [r.rid for r in done] == [0, 1, 2]
    assert wall > 0 and tok_s == pytest.approx(9 / wall)
    assert len(ttft) == 3 and min(ttft) >= 0
    assert eng.stats["admitted"] == 6  # the warm-up pass, then the measured
    assert eng.stats["prefix_hits"] >= 3  # the second pass hits the first


# -- config + index units ------------------------------------------------------


def test_fleet_config_validates_route():
    with pytest.raises(ValueError, match="route"):
        FleetConfig(route="random")
    with pytest.raises(ValueError, match="index_block"):
        FleetConfig(index_block=0)
    assert FleetConfig(shed_depth=3, shed_budget=1.5).shed_limit == 5
    assert FleetConfig(shed_depth=0).shed_limit == 0  # shedding disabled


def test_affinity_index_caps_match_at_len_minus_one():
    """The radix tree's always-re-ingest-the-last-token rule: an exactly
    block-aligned prompt matches one block short."""
    idx = AffinityIndex(block=4)
    toks = np.arange(12, dtype=np.int32)
    idx.insert(toks, replica=1)
    assert idx.lookup(toks) == (1, 8)  # (12-1)//4 = 2 blocks, not 3
    assert idx.lookup(np.arange(13, dtype=np.int32)) == (1, 12)
    assert idx.lookup(np.arange(3, dtype=np.int32)) == (-1, 0)
    assert idx.nodes == 3


def test_affinity_index_last_writer_wins():
    idx = AffinityIndex(block=4)
    toks = np.arange(8, dtype=np.int32)
    idx.insert(toks, replica=0)
    idx.insert(toks, replica=2)
    assert idx.lookup(np.arange(9, dtype=np.int32)) == (2, 8)


# -- device groups -------------------------------------------------------------


def test_replica_device_groups_partition_and_overflow():
    devs = [torch.device("cpu")] * 6
    groups = replica_device_groups(3, 2, devices=devs)
    assert [len(g) for g in groups] == [2, 2, 2]
    assert [d for g in groups for d in g] == devs
    with pytest.raises(ValueError, match="7 devices, host has 6"):
        replica_device_groups(7, 1, devices=devs)
    # the default list is the visible cards, cuda:i
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if cards:
        assert replica_device_groups(len(cards), 1) == [[c] for c in cards]
    else:
        with pytest.raises(ValueError, match="host has 0"):
            replica_device_groups(1, 1)


def test_replica_device_groups_take_an_explicit_list():
    """A one-card host shares its card by listing it twice."""
    groups = replica_device_groups(2, 1, devices=["cuda:0", "cuda:0"])
    assert groups == [[torch.device("cuda", 0)], [torch.device("cuda", 0)]]
    mesh = make_group_mesh(groups[1], (1, 1), ("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device(0) == torch.device("cuda", 0)


# -- routing policies against the JAX router (engines built, nothing run) -----


def _req(cls, rid, prompt_len, budget=4, prefix=None):
    rng = np.random.default_rng(rid)
    tail = rng.integers(0, 100, prompt_len).astype(np.int32)
    prompt = tail if prefix is None else np.concatenate([prefix, tail])
    return cls(rid=rid, prompt=prompt, max_new_tokens=budget)


def _decisions(fleet):
    return [(d.rid, d.replica, d.kind, d.expected_hit_tokens, d.reason)
            for d in fleet.decisions]


def _scenario(name):
    """(FleetConfig kwargs, [(rid, prompt_len, budget, prefixed)] routed
    through the fleet, {step: [(replica, rid, prompt_len)]} submitted
    straight to a replica before that step)."""
    mixed = [(i, ln, b, i % 3 != 0) for i, (ln, b) in enumerate(
        [(60, 4), (8, 4), (8, 4), (20, 9), (5, 2), (40, 3), (12, 6),
         (30, 4), (9, 9)])]
    if name == "rebalance":
        return (dict(route="affinity", rebalance_margin=50),
                [(0, 2, 4, True), (1, 3, 4, True), (2, 4, 4, True)],
                {2: [(None, 90, 60), (None, 91, 60)]})
    if name == "shed":
        return (dict(route="least-loaded", shed_depth=2),
                [(i, 8, 4, False) for i in range(6)], {})
    if name == "shed-budget":
        return (dict(route="affinity", shed_depth=2, shed_budget=1.5),
                [(i, 8 + i, 4, True) for i in range(9)], {})
    return dict(route=name), mixed, {}


@pytest.mark.parametrize("name", ["affinity", "round-robin", "least-loaded",
                                  "rebalance", "shed", "shed-budget"])
def test_router_decisions_equal_the_jax_router(setup, jax_setup, name):
    _, model, params = setup
    jm, jp = jax_setup
    cfg_kw, routed, direct = _scenario(name)
    prefix = np.random.default_rng(0).integers(0, 100, 30).astype(np.int32)
    fleets = {"jax": jrouter.build_fleet(
                  jm, jp, 2, config=jrouter.FleetConfig(**cfg_kw),
                  **ENGINE_KW),
              "torch": build_fleet(model, params, 2,
                                   config=FleetConfig(**cfg_kw), **ENGINE_KW)}
    for which, fleet in fleets.items():
        cls = JaxRequest if which == "jax" else Request
        for step, (rid, ln, b, prefixed) in enumerate(routed):
            for _, drid, dlen in direct.get(step, []):
                # pile work onto the replica the first request went to
                fleet.replicas[fleet.decisions[0].replica].submit(
                    _req(cls, drid, dlen))
            fleet.submit(_req(cls, rid, ln, b, prefix if prefixed else None))
    got, want = _decisions(fleets["torch"]), _decisions(fleets["jax"])
    assert got == want
    kinds = {d[2] for d in got}
    if name == "rebalance":
        assert "rebalanced" in kinds and "affinity" in kinds
        assert want[1][3] == 16  # (30-1)//16 blocks of the prefix
    if name.startswith("shed"):
        assert "shed" in kinds
        assert len(fleets["torch"].shed) == len(fleets["jax"].shed) > 0
    for a, b in zip(fleets["torch"].replicas, fleets["jax"].replicas):
        assert a.queue_depth() == b.queue_depth()
        assert a.projected_occupancy() == b.projected_occupancy()
    st, sj = fleets["torch"].stats(), fleets["jax"].stats()
    for k in ("route", "submitted", "shed", "by_kind",
              "expected_hit_tokens", "index_nodes"):
        assert st[k] == sj[k], k


def test_shed_requests_never_reach_an_engine(setup):
    _, model, params = setup
    fleet = build_fleet(model, params, 2,
                        config=FleetConfig(route="least-loaded",
                                           shed_depth=2), **ENGINE_KW)
    kinds = [fleet.submit(_req(Request, rid, 8)).kind for rid in range(5)]
    assert kinds == ["least-loaded"] * 4 + ["shed"]
    assert "saturated" in fleet.decisions[-1].reason
    assert "2 replicas" in fleet.decisions[-1].reason
    done = fleet.run()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert fleet.stats()["shed"] == 1 and fleet.shed[0][0].rid == 4


# -- end to end: streams, hits, staleness --------------------------------------


def _shared(cfg, n, seed, budgets=(3, 7)):
    return tstream.shared_prefix_requests(
        np.random.default_rng(seed), n, cfg.vocab_size, prefix_len=24,
        suffix_range=(2, 6), budgets=budgets)


@pytest.mark.parametrize("n", [1, 2])
def test_fleet_streams_equal_the_plain_engine(setup, n):
    cfg, model, params = setup
    stream = _shared(cfg, 6, seed=0)
    want = _streams(ContinuousBatchingEngine(model, params, **ENGINE_KW),
                    stream)
    fleet = build_fleet(model, params, n, **ENGINE_KW)
    assert _streams(fleet, stream) == want  # the router is placement-only
    if n == 1:
        assert {d.replica for d in fleet.decisions} == {0}
    else:
        assert sum(r.routed for r in fleet.replicas) == 6


def test_plan_placed_fleet_equals_the_plain_engine(setup):
    """Each replica under a 1x1 mode="serve" plan on its own device group
    (both groups the CPU here; on a card host `devices=[cuda:0, cuda:0]`):
    the plain programs run on the group's device, and the streams equal
    the plain engine's."""
    cfg, model, params = setup
    groups = replica_device_groups(2, 1, devices=["cpu", "cpu"])
    plans = [build_plan(cfg, make_group_mesh(g, (1, 1), ("data", "model")),
                        mode="serve") for g in groups]
    stream = _shared(cfg, 4, seed=4, budgets=4)
    want = _streams(ContinuousBatchingEngine(model, params, **ENGINE_KW),
                    stream)
    fleet = build_fleet(model, params, 2, plans=plans, **ENGINE_KW)
    assert _streams(fleet, stream) == want
    for rep, g in zip(fleet.replicas, groups):
        assert rep.engine.plan is not None
        assert rep.engine.executor.device == g[0]
        assert rep.engine.executor.params is params  # already there
    with pytest.raises(ValueError, match="2 replicas but 1 plans"):
        build_fleet(model, params, 2, plans=plans[:1], **ENGINE_KW)


def test_affinity_concentrates_prefixes_and_beats_round_robin(setup):
    cfg, model, params = setup
    stream = tstream.multi_prefix_requests(
        np.random.default_rng(1), 12, cfg.vocab_size, n_prefixes=2,
        prefix_len=24, suffix_range=(2, 6), budgets=(3, 7))
    hits, out = {}, {}
    for route in ("affinity", "round-robin"):
        # a high margin isolates pure placement (the rebalance override
        # has its own case above)
        fleet = build_fleet(model, params, 2,
                            config=FleetConfig(route=route,
                                               rebalance_margin=10_000),
                            **ENGINE_KW)
        out[route] = _streams(fleet, stream)
        hits[route] = fleet.stats()["prefix_hits"]
    assert out["affinity"] == out["round-robin"]
    # affinity: one cold per prefix; round-robin: up to one cold per
    # (replica, prefix) pair on the same stream
    assert hits["affinity"] == 10
    assert hits["affinity"] > hits["round-robin"]


def test_stale_affinity_entry_falls_back_to_cold_prefill(setup):
    """The index records where a prefix was sent, not whether the replica
    still caches it: evict the tree behind the router's back and the
    re-routed request pays one cold prefill — same tokens, no error."""
    cfg, model, params = setup
    stream = _shared(cfg, 4, seed=2, budgets=4)
    fleet = build_fleet(model, params, 2, **ENGINE_KW)
    first = _streams(fleet, stream)
    target = fleet.decisions[0].replica
    hits0 = fleet.stats()["prefix_hits"]
    prefills0 = fleet.replicas[target].stats()["prefills"]
    assert fleet.replicas[target].engine.kv.evict_cached(10 ** 6) > 0
    again = _clone(stream)[:1]
    d = fleet.submit(again[0])
    assert d.kind == "affinity" and d.replica == target
    assert d.expected_hit_tokens > 0  # the index's (stale) promise
    done = fleet.run()
    assert tuple(done[0].tokens_out) == first[done[0].rid]
    assert fleet.stats()["prefix_hits"] == hits0  # a cold prefill, no hit
    assert fleet.replicas[target].stats()["prefills"] == prefills0 + 1


def test_replica_stats_deltas_and_router_aggregation(setup):
    cfg, model, params = setup
    stream = _shared(cfg, 4, seed=3, budgets=4)
    fleet = build_fleet(model, params, 2, **ENGINE_KW)
    _streams(fleet, stream)
    st = fleet.stats()
    assert st["submitted"] == 4 and st["shed"] == 0
    assert sum(p["routed"] for p in st["replicas"]) == 4
    assert sum(p["admitted"] for p in st["replicas"]) == 4
    assert sum(p["completed"] for p in st["replicas"]) == 4
    assert st["by_kind"].get("affinity", 0) + \
        st["by_kind"].get("least-loaded", 0) == 4
    rep = st["replicas"][fleet.decisions[0].replica]
    assert rep["prefix_hit_rate"] == pytest.approx(
        rep["prefix_hits"] / rep["admitted"])
    assert st["prefix_hits"] == sum(p["prefix_hits"] for p in st["replicas"])
    eng = fleet.replicas[0].engine
    assert eng.hit_stats()["admitted"] == eng.stats["admitted"]
    # a fresh Replica wrapper sees only the deltas after it joined
    wrapped = Replica(9, eng)
    assert wrapped.stats()["admitted"] == 0
    assert wrapped.stats()["prefix_hit_rate"] == 0.0


# -- the fitted LM: the port's fleet against the JAX fleet ---------------------


@pytest.fixture(scope="module")
def fitted():
    jm = jmake(CFG, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, make_model(tget("smollm-135m").reduced(),
                                  device="cpu"), tp


def _affine_multi_prefix(seed=2):
    """multi_prefix_requests' shape over affine runs (the fitted model's
    own distribution): 3 prefixes of 24 tokens, tails of 3-8."""
    rng = np.random.default_rng(seed)
    prefixes = affine_prompts(rng, 3, CFG.vocab_size, (24, 25))
    which = rng.integers(0, 3, 10)
    tails = affine_prompts(rng, 10, CFG.vocab_size, (3, 9))
    return [(np.concatenate([prefixes[w], t]).astype(np.int32),
             int(rng.integers(6, 16))) for w, t in zip(which, tails)]


def _fleet_streams(fleet, cls, stream):
    for i, (p, b) in enumerate(stream):
        fleet.submit(cls(rid=i, prompt=p, max_new_tokens=b))
    return fleet.run()


def test_two_replica_fleet_matches_the_jax_fleet(fitted):
    jm, jp, tm, tp = fitted
    stream = _affine_multi_prefix()
    kw = dict(max_batch=2, buckets=(16, 32, 64), num_pages=40, page_size=8,
              deadline_s=0.0, max_decode_len=32)
    with pinned_impl("ref"):
        jfleet = jrouter.build_fleet(jm, jp, 2, **kw)
        jdone = _fleet_streams(jfleet, JaxRequest, stream)
    tfleet = build_fleet(tm, tp, 2, **kw)
    tdone = _fleet_streams(tfleet, Request, stream)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    total = sum(len(r.tokens_out) for r in jdone)
    matched = sum(int(a == b) for jr, tr in zip(jdone, tdone)
                  for a, b in zip(jr.tokens_out, tr.tokens_out))
    assert [len(r.tokens_out) for r in tdone] == \
        [len(r.tokens_out) for r in jdone]
    assert matched / total == 1.0, (matched, total)
    assert _decisions(tfleet) == _decisions(jfleet)
    st, sj = tfleet.stats(), jfleet.stats()
    assert st["prefix_hits"] > 0
    for k in ("by_kind", "prefix_hits", "prefix_hit_tokens"):
        assert st[k] == sj[k], k
    for a, b in zip(st["replicas"], sj["replicas"]):
        assert {k: a[k] for k in a if k != "wall_s"} == \
            {k: b[k] for k in b if k != "wall_s"}


# -- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--plan", "none",
                                        "--route", "round-robin"]])
def test_cli_serves_a_fleet(capsys, extra):
    done = serve_cli.main(["--device", "cpu", "--reduced", "--requests", "6",
                           "--replicas", "2", "--stream", "shared-prefix"]
                          + extra)
    out = capsys.readouterr().out
    assert len(done) == 6 and all(r.done for r in done)
    assert "serve[fleet]" in out and "replicas=2" in out
    assert "replica 0:" in out and "replica 1:" in out


def test_cli_sheds_and_refuses_what_the_reference_refuses(capsys):
    done = serve_cli.main(["--device", "cpu", "--reduced", "--requests", "8",
                           "--plan", "none", "--replicas", "2",
                           "--shed-depth", "1", "--route", "least-loaded"])
    out = capsys.readouterr().out
    assert "shed rid=" in out and "saturated" in out
    assert len(done) < 8
    with pytest.raises(SystemExit, match="drop --engine wave"):
        serve_cli.main(["--device", "cpu", "--reduced", "--replicas", "2",
                        "--engine", "wave"])
    with pytest.raises(SystemExit, match="per replica"):
        serve_cli.main(["--device", "cpu", "--reduced", "--replicas", "2",
                        "--mesh", "2"])

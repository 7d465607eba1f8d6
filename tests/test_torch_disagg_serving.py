"""The port's disaggregated prefill/decode pools (`disagg=(P, D)`) against
colocated serving, and their host-side pieces against the JAX package.

* The scheduler's split queues and their pool-aware occupancy signals
  equal the reference scheduler's on the same queue (host-side, no
  devices).
* `_init_disagg` refuses what the reference refuses: dense slot rows, a
  plan, `spec_config`, and P < 1 or D < 1.  Where the reference raises
  for a host with fewer than P + D devices, the port takes the pools'
  devices by `make_mesh`'s rule (all on the CPU here, both on the one
  card of a one-card host), so it serves.
* Disaggregated streams equal colocated serving's bit for bit, in bf16
  and int8: every cold admission ships once (`ship_dispatches ==
  prefills`, `shipped_bytes == shipped_pages * kv_page_bytes()`), a
  replay of the same prompts admits by prefix hits alone and ships
  nothing, and both ledgers drain.
* On the fitted synthetic LM the disaggregated streams and ship counters
  equal the JAX engine's (`disagg=(1, 1)` on 2 host devices, in a
  subprocess), in bf16 and int8, cold and on a replay.
* `kv_page_bytes()` equals the JAX engine's for the same config.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.models.synthetic import affine_prompts
from repro.serving.scheduler import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config as tget
from repro_torch.core.cluster_builder import build_plan
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import paged_cache_map
from repro_torch.models.transformer import init_params, make_model
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.stream import bursty_requests, clone_requests

torch.set_num_threads(1)

KW = dict(max_batch=2, buckets=(32, 64), max_decode_len=8, num_pages=64,
          page_size=8)


@pytest.fixture(scope="module")
def setup():
    cfg = tget("smollm-135m").reduced()
    return cfg, make_model(cfg, device="cpu"), init_params(cfg, seed=0,
                                                            device="cpu")


# -- the scheduler's split queues against the reference's ---------------------


def _req(cls, rid, n_prompt, budget=4, t=0.0):
    r = cls(rid=rid, prompt=np.zeros(n_prompt, np.int32),
            max_new_tokens=budget, t_arrival=t)
    r.t_enqueue = time.perf_counter()
    return r


def _signals(sched):
    return ([sched.queue_depth(p) for p in (None, "prefill", "decode")],
            [sched.projected_occupancy(p)
             for p in (None, "prefill", "decode")])


def test_queue_depth_and_occupancy_split_by_pool_as_the_reference():
    """With a classifier installed the signals split per pool: hits count
    toward decode ingest (decode budget + un-hit suffix), colds toward
    the prefill pool (bucketed prompt cost); the combined calls keep
    their meaning (the fleet router's `Replica` reads them)."""
    hits = {0: 16, 1: 0, 2: 48}  # rid -> advisory cached-prefix length
    got = {}
    for name, sched_cls, req_cls in (("jax", JaxScheduler, JaxRequest),
                                     ("torch", Scheduler, Request)):
        sched = sched_cls(buckets=(16, 32, 64), deadline_s=60.0,
                          decode_horizon=8, max_batch=4)
        for rid, n, b in ((0, 20, 4), (1, 40, 8), (2, 60, 2)):
            sched.enqueue(_req(req_cls, rid, n, b))
        before = _signals(sched)
        sched.set_disagg(lambda r: hits[r.rid])
        got[name] = (before, _signals(sched))
    assert got["torch"] == got["jax"]
    (depth, occ), (depth2, occ2) = got["torch"]
    assert depth == [3, 3, 0]
    assert occ == [(32 + 4) + (64 + 8) + (64 + 2),
                   occ[0] - (4 + 8 + 2), 4 + 8 + 2]
    assert depth2 == [3, 1, 2]
    assert occ2 == [occ[0], 64, (4 + (20 - 16)) + 8 + (2 + (60 - 48))]


@pytest.mark.parametrize("chunk", [2, 8])
def test_admission_order_ingest_first_then_overdue_then_sjf(chunk):
    """Decode-ingest hits first (FIFO), then deadline-overdue colds FIFO,
    then at most `prefill_chunk` colds shortest-bucket-first, as the
    reference orders them."""
    hits = {0: 16, 3: 16}
    order = {}
    for name, sched_cls, req_cls in (("jax", JaxScheduler, JaxRequest),
                                     ("torch", Scheduler, Request)):
        sched = sched_cls(buckets=(16, 64), deadline_s=60.0,
                          decode_horizon=8, max_batch=8)
        sched.set_disagg(lambda r: hits.get(r.rid, 0), prefill_chunk=chunk)
        rest = ([_req(req_cls, 0, 20), _req(req_cls, 1, 60),
                 _req(req_cls, 2, 60), _req(req_cls, 3, 20),
                 _req(req_cls, 4, 10), _req(req_cls, 5, 10),
                 _req(req_cls, 6, 60, t=-120.0)])
        order[name] = [r.rid for r in sched._disagg_order(rest, now=0.0)]
    assert order["torch"] == order["jax"]
    assert order["torch"] == ([0, 3, 6, 4, 5] if chunk == 2
                              else [0, 3, 6, 4, 5, 1, 2])


# -- the engine's refusals -----------------------------------------------------


@pytest.mark.parametrize("case", ["dense", "plan", "spec", "p0", "d0"])
def test_init_disagg_refusals(setup, case):
    cfg, model, params = setup
    kw = dict(max_batch=2, buckets=(16,), max_decode_len=8, disagg=(1, 1))
    match = {"dense": "paged", "plan": "ClusterPlan", "spec": "spec_config",
             "p0": "prefill >= 1", "d0": "decode >= 1"}[case]
    if case == "dense":
        kw["paged"] = False
    elif case == "plan":
        kw["plan"] = build_plan(cfg, make_mesh((1, 1), ("data", "model"),
                                               device="cpu"), mode="serve")
    elif case == "spec":
        kw["spec_config"] = dict(draft_model=model, draft_params=params,
                                 spec_k=2)
    else:
        kw["disagg"] = (0, 2) if case == "p0" else (1, 0)
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(model, params, **kw)


def test_disagg_pools_take_make_mesh_devices(setup):
    """More pool devices than the host has: the pools share the CPU (the
    reference raises; the port follows make_mesh's placement rule)."""
    _, model, params = setup
    eng = ContinuousBatchingEngine(model, params, disagg=(2, 3), **KW)
    assert eng.executor.device == torch.device("cpu")
    assert eng.executor.prefill_model.device == torch.device("cpu")
    assert any("5 pool devices on 1 device(s)" in n
               for n in eng.executor.notes)


# -- the handoff: disagg == colocated, bit for bit -----------------------------


def _stream(cfg):
    return bursty_requests(np.random.default_rng(0), 8, cfg.vocab_size,
                           short_range=(10, 16), long_range=(40, 56),
                           burst_every=3, burst_size=2, budgets=(3, 5))


def _serve(eng, reqs):
    for r in clone_requests(reqs):
        eng.submit(r)
    return {r.rid: tuple(r.tokens_out) for r in eng.run()}


def _bytes_per_page(caches) -> dict:
    """Bytes one page holds in each kind of arena leaf, summed over the
    blocks."""
    out = {}

    def add(ax, name, leaf):
        out[name] = out.get(name, 0) + (leaf.numel() // leaf.shape[ax]
                                        * leaf.element_size())

    paged_cache_map(add, caches)
    return out


def _at_once(reqs):
    """The stream with every arrival at 0.  With deadline_s=0 (FIFO) both
    engines then admit the same requests in the same cycles whatever the
    host's speed, so their arenas can be compared page by page."""
    out = clone_requests(reqs)
    for r in out:
        r.t_arrival = 0.0
    return out


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_disagg_equals_colocated_with_zero_transfer_hits(setup, kv_dtype):
    cfg, model, params = setup
    stream = _at_once(_stream(cfg))
    colo = ContinuousBatchingEngine(model, params, kv_dtype=kv_dtype,
                                    deadline_s=0.0, **KW)
    dis = ContinuousBatchingEngine(model, params, kv_dtype=kv_dtype,
                                   deadline_s=0.0, disagg=(1, 1), **KW)
    assert _serve(colo, stream) == _serve(dis, stream)
    s = dis.stats
    assert s["prefills"] == len(stream) == s["ship_dispatches"]
    assert s["shipped_pages"] > 0
    assert s["shipped_bytes"] == s["shipped_pages"] * dis.kv_page_bytes()
    # the bytes gathered off the staging arena's leaves (padding pages
    # included) against the decode arena's own bytes a page: k, v (and an
    # int8 arena's scale planes), which kv_page_bytes() counts, and the
    # kpos rows, which it leaves out
    gathered = dis.executor.gathered
    per_page = _bytes_per_page(dis._slot_caches)
    assert s["shipped_pages"] <= gathered["pages"] < 2 * s["shipped_pages"]
    assert gathered["bytes"] == gathered["pages"] * sum(per_page.values())
    assert dis.kv_page_bytes() == sum(
        v for k, v in per_page.items() if k != "kpos")
    assert s["pages_peak"] == colo.stats["pages_peak"]
    # replay the same prompts: radix hits admit decode-side only, with
    # zero page transfers, still bit for bit
    hits0, ships0 = s["prefix_hits"], s["ship_dispatches"]
    assert _serve(colo, stream) == _serve(dis, stream)
    assert dis.stats["prefix_hits"] > hits0
    assert dis.stats["ship_dispatches"] == ships0
    assert dis.stats["prefix_hits"] == colo.stats["prefix_hits"]
    dis.kv.assert_drained()
    dis.kv_prefill.assert_drained()
    assert dis.kv_prefill.pages_in_use == 0
    assert dis.hit_stats()["prefix_hits"] == dis.stats["prefix_hits"]
    # the decode arena holds what colocated serving's holds, page by page
    a, b = colo._slot_caches["scan"]["b0"], dis._slot_caches["scan"]["b0"]
    for name in a:
        assert torch.equal(a[name][:, 1:], b[name][:, 1:]), name


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_split_queue_admission_streams_equal_colocated(setup, kv_dtype):
    """With a deadline no cold request reaches, the split queues admit
    prefix hits first and colds shortest bucket first, on the stream's
    own arrival times: only when a request runs changes, so the streams
    equal colocated serving's and every cold admission ships once."""
    cfg, model, params = setup
    stream = _stream(cfg)
    kw = dict(KW, deadline_s=60.0, kv_dtype=kv_dtype)
    colo = ContinuousBatchingEngine(model, params, **kw)
    dis = ContinuousBatchingEngine(model, params, disagg=(1, 1), **kw)
    for _ in ("cold", "replay"):
        assert _serve(colo, stream) == _serve(dis, stream)
    s = dis.stats
    assert s["ship_dispatches"] == len(stream) == s["prefills"]
    assert s["prefix_hits"] == len(stream)
    dis.kv.assert_drained()
    dis.kv_prefill.assert_drained()


# -- the handoff against the JAX engine, on the fitted LM ----------------------

_JAX_DISAGG = """
    import json, sys
    import jax, numpy as np
    from repro.configs import get_config
    from repro.kernels import ops as kops
    from repro.models.synthetic import affine_prompts, fit_affine_lm
    from repro.models.transformer import make_model
    from repro.serving.engine import ContinuousBatchingEngine
    from repro.serving.stream import bursty_requests, clone_requests

    kops.set_impl("ref")
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg, remat=False)
    params = fit_affine_lm(model, steps=300)
    flat = {}  # bf16 leaves saved as their uint16 bits
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        key, v = "/".join(str(getattr(k, "key", k)) for k in path), \
            np.asarray(v)
        if v.dtype == jax.numpy.bfloat16:
            key, v = key + "@bf16", v.view(np.uint16)
        flat[key] = v
    np.savez(sys.argv[1], **flat)
    stream = bursty_requests(np.random.default_rng(0), 8, cfg.vocab_size,
                             short_range=(10, 16), long_range=(40, 56),
                             burst_every=3, burst_size=2, budgets=(3, 5))
    runs = affine_prompts(np.random.default_rng(1), len(stream),
                          cfg.vocab_size, (60, 61))
    for r, run in zip(stream, runs):
        r.prompt = run[:len(r.prompt)]
    out = {}
    for kv in ("bf16", "int8"):
        eng = ContinuousBatchingEngine(model, params, kv_dtype=kv,
                                       disagg=(1, 1), **json.loads(
                                           sys.argv[2]))
        passes = []
        for _ in ("cold", "replay"):
            for r in clone_requests(stream):
                eng.submit(r)
            done = eng.run()
            passes.append({str(r.rid): [int(t) for t in r.tokens_out]
                           for r in done})
        eng.kv.assert_drained()
        eng.kv_prefill.assert_drained()
        out[kv] = dict(streams=passes, stats={
            k: int(eng.stats[k]) for k in ("prefills", "prefix_hits",
                                           "ship_dispatches", "shipped_pages",
                                           "shipped_bytes")})
    print("JAX-DISAGG " + json.dumps(out))
"""

# deadline 0: FIFO admission in both engines, whatever the host's speed
_FIT_KW = dict(KW, deadline_s=0.0)


def _unflatten(flat) -> dict:
    tree = {}
    for key, v in flat.items():
        if key.endswith("@bf16"):
            key, v = key[:-5], v.view(jax.numpy.bfloat16)
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def jax_disagg(tmp_path_factory):
    """The JAX engine's disaggregated streams and ship counters on the
    fitted LM (300 steps), from a subprocess with 2 host devices (the
    reference's pools need P + D of them), and its fitted params."""
    path = str(tmp_path_factory.mktemp("disagg") / "fit.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_DISAGG), path,
         json.dumps(_FIT_KW)], capture_output=True, text=True, env=env,
        timeout=600)
    assert run.returncode == 0, run.stdout + "\n" + run.stderr
    line = next(ln for ln in run.stdout.splitlines()
                if ln.startswith("JAX-DISAGG "))
    with np.load(path) as z:
        params = params_from_jax(_unflatten(dict(z)), device="cpu")
    return json.loads(line.split(" ", 1)[1]), params


def _affine_bursty(cfg):
    """bursty_requests' stream (lengths, arrivals, budgets) over affine
    runs, the fitted model's own distribution: on random tokens its top
    two logits can sit a bf16 ulp apart (request 0's replay reads 17.375
    and 17.25), and int8 KV noise then picks either, colocated or not."""
    stream = _stream(cfg)
    runs = affine_prompts(np.random.default_rng(1), len(stream),
                          cfg.vocab_size, (60, 61))
    for r, run in zip(stream, runs):
        r.prompt = run[:len(r.prompt)]
    return stream


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_disagg_streams_and_ships_equal_the_jax_engines(setup, jax_disagg,
                                                        kv_dtype):
    cfg, model, _ = setup
    want, params = jax_disagg
    stream = _affine_bursty(cfg)
    eng = ContinuousBatchingEngine(model, params, kv_dtype=kv_dtype,
                                   disagg=(1, 1), **_FIT_KW)
    for i, _ in enumerate(("cold", "replay")):
        got = {str(rid): list(t) for rid, t in _serve(eng, stream).items()}
        assert got == want[kv_dtype]["streams"][i], i
    assert {k: eng.stats[k] for k in want[kv_dtype]["stats"]} == \
        want[kv_dtype]["stats"]
    assert want[kv_dtype]["stats"]["ship_dispatches"] == len(stream)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_ship_pages_moves_every_leaf_of_its_pages(setup, n):
    """One gather over every arena leaf (int8 scale planes included), the
    index vectors padded to a power of two with the trash page 0; pages
    outside the shipment stay as they were."""
    _, model, params = setup
    eng = ContinuousBatchingEngine(model, params, kv_dtype="int8",
                                   disagg=(1, 1), **KW)
    ex = eng.executor
    arena = ex.init_prefill_arena(8, 9, 8, "int8")
    dec = ex.init_caches(True, 8, 20, 8, "int8")
    g = torch.Generator().manual_seed(n)

    def fill(t):
        t.copy_(torch.randint(-100, 100, t.shape, generator=g).to(t.dtype))

    for tree in (arena, dec):
        for leaves in list(tree["scan"].values()) + list(
                tree["tail"].values()):
            for t in leaves.values():
                fill(t)
    src, dst = [3, 5, 1, 8][:n], [12, 4, 19, 7][:n]
    before = {k: t.clone() for k, t in dec["scan"]["b0"].items()}
    st = {"caches": dec}
    ex.ship_pages(arena, st, src, dst)
    got, stage = st["caches"]["scan"]["b0"], arena["scan"]["b0"]
    assert set(got) == {"k", "v", "kpos", "k_scale", "v_scale"}
    rest = [p for p in range(1, 20) if p not in dst]
    for name in got:
        assert torch.equal(got[name][:, dst], stage[name][:, src]), name
        assert torch.equal(got[name][:, rest], before[name][:, rest]), name
    with pytest.raises(ValueError, match="pages"):
        ex.ship_pages(arena, st, [1, 2], [3])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_kv_page_bytes_equal_the_jax_engines(setup, kv_dtype):
    _, model, params = setup
    jcfg = get_config("smollm-135m").reduced()
    jeng = JaxEngine(jmake(jcfg, remat=False),
                     jinit(jcfg, jax.random.PRNGKey(0)), kv_dtype=kv_dtype,
                     **KW)
    eng = ContinuousBatchingEngine(model, params, kv_dtype=kv_dtype,
                                   disagg=(1, 1), **KW)
    assert eng.kv_page_bytes() == jeng.kv_page_bytes() > 0


# -- the CLI -------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cli_serves_disaggregated_pools(capsys, kv_dtype):
    done = serve_cli.main(["--device", "cpu", "--reduced", "--requests",
                           "10", "--plan", "none", "--disagg", "1:1",
                           "--stream", "bursty", "--kv-dtype", kv_dtype])
    out = capsys.readouterr().out
    assert len(done) == 10 and all(r.done for r in done)
    assert max(len(r.prompt) for r in done) >= 180  # a burst was served
    assert "disagg=1:1" in out and "'ship_dispatches': 10" in out


@pytest.mark.parametrize("extra,match", [
    (["--disagg", "1:1"], "--plan none"),
    (["--disagg", "1-1", "--plan", "none"], "P:D"),
    (["--disagg", "1:1", "--plan", "none", "--engine", "wave"], "paged cb"),
    (["--disagg", "1:1", "--plan", "none", "--replicas", "2"], "fleet"),
    (["--disagg", "1:1", "--plan", "none", "--draft-config",
      "smollm-135m"], "draft"),
])
def test_cli_refuses_what_the_reference_refuses(extra, match):
    with pytest.raises(SystemExit, match=match):
        serve_cli.main(["--device", "cpu", "--reduced"] + extra)

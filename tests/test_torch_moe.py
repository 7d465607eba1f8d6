"""The MoE families — moonshot-v1-16b-a3b (every layer MoE, 64 experts
top-6, 2 shared experts) and llama4-maverick-400b-a17b (a dense layer,
then a MoE layer of 128 experts top-1 with 1 shared expert) — against
the JAX package at `.reduced()` (4 experts; top-2 and top-1), with the
same weights (JAX `init_params` through `params_from_jax`).

* `route` against the reference's routing (its lines, in jnp, beside
  its jitted `moe_ffn`) at S in {1, 5, 16, 64} and B in {1, 4}, with
  trailing pad rows: the expert ids and the keep mask identical (so the
  same pairs are dropped), the gates within 1e-6; `moe_ffn`'s y within
  1e-2 and bit for bit at >= 99.9% of its elements (all of them at these
  seeds), aux within 1e-6 relative (the reference's jitted aux sums in
  another order).
* A zero router ties every expert: both pick experts 0..k-1.
* The MoE tree crosses `params_from_jax` bit for bit, and the port's
  `init_params` has JAX's layout.
* `moe_ffn`'s gradients within 2^-5 of each leaf's largest (as
  tests/test_torch_synthetic.py's).
* Prefill logits within 2e-2 (as tests/test_torch_model.py); the loss,
  aux included, within 1e-3 (as tests/test_torch_long_forward.py), the
  backbone's aux within 1e-3 relative: there the router reads hidden
  rows a few bf16 ulps apart (measured 4.3e-5 and 8.7e-5 relative; 1e-6
  on the same rows).
* The verify block: a MoE layer routes the block's T tokens as one group
  at the capacity of S = T, so where a pair is dropped the row parts
  from T chained decode steps (which never drop).  The port's verify
  logits equal JAX's within 2e-2, and both part from their own chained
  steps at the same (lane, column) rows.
* A prefix hit is not a cold prefill: the cold prompt routes as one
  group at its bucket's capacity, the hit's suffix one token a decode
  step (capacity 1, no drop); where the bucket drops pairs the next
  token's logits part, by the same amount in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as jmoe
from repro.models.synthetic import affine_batch
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.models import synthetic as tsyn
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake
from test_torch_model import _bucketed, _paged_setup

torch.set_num_threads(1)

ARCHS = ["moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b"]


def _cfgs(arch):
    return get_config(arch).reduced(), tget(arch).reduced()


def _converted(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _moe_params(cfg, seed=0):
    """The reference's MoE leaves of the first MoE block of a reduced
    model, one layer's slice."""
    params = jinit(cfg, jax.random.PRNGKey(seed))
    blk = next(b for b in params["scan"] if cfg.is_moe_layer(int(b[1:])))
    return jax.tree.map(lambda a: a[0], params["scan"][blk]["ffn"])


def _jax_routing(x, p, cfg):
    """The reference's routing lines (repro/models/moe.py:53-78), in jnp:
    (expert ids, keep, gates)."""
    bsz, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = jmoe._capacity(cfg, s)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    flat_ids = expert_ids.reshape(bsz, s * k)
    onehot = jax.nn.one_hot(flat_ids, e, dtype=jnp.int32)
    rank = jnp.cumsum(onehot, axis=1) - onehot
    pos = jnp.sum(rank * onehot, axis=-1)
    return (np.asarray(expert_ids), np.asarray(pos < cap),
            np.asarray(gate_vals))


def _bf16_pair(a):
    """A numpy f32 array as (JAX bf16, torch bf16) of the same bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _converted({"x": j})["x"]


def _hidden(rng, b, s, d):
    """(B, S, D) hidden rows; row i's trailing pads all one pad vector, as
    a prefill bucket's pad rows carry one embedding."""
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    pad = rng.normal(0, 1, d).astype(np.float32)
    for i in range(b):
        x[i, max(1, s - s // 4 - 3 * i):] = pad
    return x


def _bit_equal_share(y, want):
    """The share of y's elements with the reference's bits.  An exp one
    f32 ulp apart can round a SiLU output to another bf16 now and then
    (1 element of 4,096 in the zero-router case); another activation
    formula parts at ~40% of them (models/moe.py)."""
    return float((y.float().numpy() == want).mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_agree(arch):
    assert tget(arch).__dict__ == get_config(arch).__dict__
    cfg, tcfg = _cfgs(arch)
    assert tcfg.__dict__ == cfg.__dict__


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [1, 5, 16, 64])
@pytest.mark.parametrize("b", [1, 4])
def test_route_and_moe_ffn_match_jax(arch, s, b):
    cfg, tcfg = _cfgs(arch)
    jp = _moe_params(cfg)
    tp = _converted(jp)
    xj, xt = _bf16_pair(_hidden(np.random.default_rng(10 * s + b), b, s,
                                cfg.d_model))
    ids, keep, gates = _jax_routing(xj, jp, cfg)
    r = tmoe.route(xt, tp, tcfg)
    assert r.cap == jmoe._capacity(cfg, s)
    assert np.array_equal(r.experts.numpy(), ids)
    assert np.array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gates.numpy(), gates, atol=1e-6, rtol=0)

    want_y, want_aux = jax.jit(jmoe.moe_ffn, static_argnums=2)(xj, jp, cfg)
    y, aux = tmoe.moe_ffn(xt, tp, tcfg)
    want_y = np.asarray(want_y).astype(np.float32)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=1e-2, rtol=0)
    assert _bit_equal_share(y, want_y) >= 0.999
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_pick_the_lowest_experts(arch):
    """Every probability equal: top-k takes experts 0..k-1 in order, as
    `jax.lax.top_k` does; capacity then drops the later tokens' pairs."""
    cfg, tcfg = _cfgs(arch)
    jp = _moe_params(cfg)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp = _converted(jp)
    xj, xt = _bf16_pair(_hidden(np.random.default_rng(3), 2, 16,
                                cfg.d_model))
    ids, keep, _ = _jax_routing(xj, jp, cfg)
    r = tmoe.route(xt, tp, tcfg)
    lowest = np.broadcast_to(np.arange(cfg.top_k), ids.shape)
    assert np.array_equal(ids, lowest)
    assert np.array_equal(r.experts.numpy(), lowest)
    assert np.array_equal(r.keep.numpy(), keep) and not keep.all()
    want_y, _ = jax.jit(jmoe.moe_ffn, static_argnums=2)(xj, jp, cfg)
    y, _ = tmoe.moe_ffn(xt, tp, tcfg)
    want_y = np.asarray(want_y).astype(np.float32)
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=1e-2, rtol=0)
    assert _bit_equal_share(y, want_y) >= 0.999


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keeps_jax_layout(arch):
    cfg, tcfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
    got = tinit(tcfg, seed=0, device="cpu")
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tsyn._leaves(got, [])) == len(flat)
    for path, leaf in flat:
        t = _leaf(got, path)
        assert tuple(t.shape) == leaf.shape, path
        assert t.dtype == names[str(leaf.dtype)], path
    moe = [b for b in got["scan"] if "router" in got["scan"][b]["ffn"]]
    assert moe == [f"b{i}" for i in range(len(got["scan"]))
                   if cfg.is_moe_layer(i)]
    for b in moe:  # the draws' scales: router 0.02, experts d_in^-1/2
        ffn = got["scan"][b]["ffn"]
        for name, d_in in (("router", 1 / 0.02 ** 2), ("wi", cfg.d_model),
                           ("wo", cfg.d_ff), ("shared_wo",
                                              cfg.d_ff * cfg.n_shared_experts)):
            std = ffn[name].float().std().item()
            assert abs(std * d_in ** 0.5 - 1) < 0.15, (name, std)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_is_bit_exact(arch):
    cfg, _ = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(1))
    tp = _converted(params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        t, a = _leaf(tp, path), np.asarray(leaf)
        assert tuple(t.shape) == a.shape, path
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert (t.view(torch.int16).numpy() == a.view(np.int16)).all()
        else:
            assert t.dtype == torch.float32 and (t.numpy() == a).all(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    cfg, tcfg = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 16, 11)]
    toks, pos, last = _bucketed(prompts, 16)
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")
    want, _ = jm.prefill(params, jm.init_cache(3, 16),
                         tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                         last_idx=jnp.asarray(last))
    got, _ = tm.prefill(_converted(params), tm.init_cache(3, 16),
                        torch.tensor(toks), positions=torch.tensor(pos),
                        last_idx=torch.tensor(last))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_aux_match_jax(arch):
    cfg, tcfg = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(2))
    t, lab = affine_batch(np.random.default_rng(0), cfg.vocab_size)
    t, lab = np.asarray(t), np.asarray(lab)
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")
    tp = _converted(params)
    want = float(jm.loss(params, {"tokens": t, "labels": lab}))
    pos = jnp.broadcast_to(jnp.arange(t.shape[1], dtype=jnp.int32), t.shape)
    _, _, want_aux = jm.backbone(params, jm.embed_inputs(params, t), pos,
                                 pos_contiguous=True)
    with torch.no_grad():
        got = tm.loss(tp, {"tokens": torch.tensor(t),
                           "labels": torch.tensor(lab)})
        x = tm.embed_inputs(tp, torch.tensor(t))
        _, aux = tm.backbone(tp, x, torch.tensor(np.asarray(pos)),
                             pos_contiguous=True)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-3
    assert float(want_aux) > 0.5  # a MoE layer's loss is near 1 or more
    assert abs(float(aux) - float(want_aux)) <= 1e-3 * float(want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradients_match_jax(arch):
    """Autograd through `moe_ffn` (the dispatch's index_put, the gather
    back, the sorted and renormalised gates, the aux loss) against
    `jax.grad` of the reference's on the same input rows: sum(y * r) +
    aux, r a fixed random (B, S, D), within 2^-5 of each leaf's largest
    gradient.  (Through a whole model the router sees hidden rows a bf16
    ulp apart, and at 4 experts top-1 a near-tie then routes a token to
    another expert: reduced llama4's loss batch has 3 such of 512 tokens
    against the reference's eager evaluation, whose own jitted one parts
    from it by 0.31 in the logits.)"""
    cfg, tcfg = _cfgs(arch)
    jp = _moe_params(cfg)
    rng = np.random.default_rng(6)
    xj, xt = _bf16_pair(_hidden(rng, 4, 16, cfg.d_model))
    r = rng.normal(0, 1, (4, 16, cfg.d_model)).astype(np.float32)

    def jloss(x, p):
        y, aux = jmoe.moe_ffn(x, p, cfg)
        return jnp.sum(y.astype(jnp.float32) * r) + aux

    gx, gp = jax.jit(jax.grad(jloss, argnums=(0, 1)))(xj, jp)
    tp = tsyn._map(lambda w: w.requires_grad_(True), _converted(jp))
    xt.requires_grad_(True)
    y, aux = tmoe.moe_ffn(xt, tp, tcfg)
    loss = torch.sum(y.float() * torch.tensor(r)) + aux
    names = sorted(tp)
    got = torch.autograd.grad(loss, [xt] + [tp[n] for n in names])
    want = [_converted({"x": gx})["x"]] + [_converted(gp)[n] for n in names]
    for name, w, g in zip(["x"] + names, want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bound = 2 ** -5 * w.float().abs().max()
        assert (g.float() - w.float()).abs().max() <= bound, name


class _Jitted:
    """A JAX model whose prefill, decode_step and verify_block are jitted,
    as the JAX engine runs them (the same logits as eager here, in a third
    of the time)."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)
        self.verify_block = jax.jit(model.verify_block)
        self.init_cache = model.init_cache
        self.init_paged_cache = model.init_paged_cache
        self.admit_lane_cache = model.admit_lane_cache


def _verify_and_chained(model, params, as_tensor, cast, copy, prompts,
                        tokens):
    """(verify_block logits, T chained decode_step logits), each from a
    copy of the same admitted paged cache (`copy`: the port's caches are
    updated in place, JAX's never)."""
    cache, *_ = _paged_setup(model, params, prompts, 8, 4, 8, 25, as_tensor)
    ver, _ = model.verify_block(params, copy(cache), as_tensor(tokens))
    steps, big = [], copy(cache)
    for j in range(tokens.shape[1]):
        lg, big = model.decode_step(params, big, as_tensor(tokens[:, j]))
        steps.append(cast(lg))
    return cast(ver), np.stack(steps, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_block_parts_where_jax_parts(arch, monkeypatch):
    """One verify block of T = 5 after three admitted prompts (the last a
    prefix hit): the port's logits equal JAX's within 2e-2, pairs are
    dropped (counted through the port's `route`), and the rows that part
    from the chained decode steps are the same in both packages."""
    cfg, tcfg = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(0))
    tp = _converted(params)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 14, 12)]
    prompts[2] = np.concatenate([prompts[0][:8], prompts[2][:4]])
    tokens = rng.integers(0, cfg.vocab_size, (3, 5)).astype(np.int32)
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")
    want_v, want_c = _verify_and_chained(_Jitted(jm), params, jnp.asarray,
                                         np.asarray, lambda c: c, prompts,
                                         tokens)
    dropped = []
    route = tmoe.route

    def spy(x, p, c, columns=False):
        r = route(x, p, c, columns)
        if x.shape[1] == tokens.shape[1]:
            dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(tmoe, "route", spy)
    with torch.no_grad():
        got_v, got_c = _verify_and_chained(
            tm, tp, torch.as_tensor, lambda t: t.numpy(),
            lambda c: tsyn._map(torch.clone, c), prompts, tokens)
    assert len(dropped) == sum(map(cfg.is_moe_layer, range(cfg.n_layers)))
    assert sum(dropped) > 0
    np.testing.assert_allclose(got_v, want_v, atol=2e-2, rtol=0)
    np.testing.assert_allclose(got_c, want_c, atol=2e-2, rtol=0)
    want_parts = np.abs(want_v - want_c).max(-1) > 0.05
    got_parts = np.abs(got_v - got_c).max(-1) > 0.05
    assert want_parts.any() and not want_parts.all()
    assert np.array_equal(got_parts, want_parts)
    # rows before a lane's first drop route as the chained steps do: the
    # port's equal them bit for bit
    first = np.argmax(got_parts, 1)
    for lane in range(len(prompts)):
        clean = first[lane] if got_parts[lane].any() else tokens.shape[1]
        assert np.array_equal(got_v[lane, :clean], got_c[lane, :clean])


@pytest.mark.parametrize("arch,seed", [("moonshot-v1-16b-a3b", 0),
                                       ("llama4-maverick-400b-a17b", 1)])
def test_prefix_hit_parts_from_cold_prefill(arch, seed):
    """One 15-token prompt: its last logits from a cold bucket-16 prefill,
    and from a prefix hit on 8 of its positions (another lane's pages)
    whose 7-token suffix goes through decode steps.  At these seeds the
    bucket drops pairs (seeds where it drops none give equal logits in
    the reference): both packages part by more than 0.1, and each side
    is within 2e-2 of JAX's."""
    cfg, tcfg = _cfgs(arch)
    params = jinit(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(seed).integers(0, 256, 15).astype(
        np.int32)

    def run(model, p, as_tensor, cast):
        toks, pos, last = _bucketed([prompt], 16)
        cold, _ = model.prefill(p, model.init_cache(1, 16), as_tensor(toks),
                                positions=as_tensor(pos),
                                last_idx=as_tensor(last))
        big, *_ = _paged_setup(model, p, [prompt, prompt], 8, 4, 8, 17,
                               as_tensor)
        active = as_tensor(np.array([False, True]))
        for tok in prompt[8:]:
            hit, big = model.decode_step(
                p, big, as_tensor(np.array([0, tok], np.int32)), active)
        return cast(cold)[0], cast(hit)[1]

    jc, jh = run(_Jitted(jmake(cfg, remat=False)), params, jnp.asarray,
                 np.asarray)
    with torch.no_grad():
        tc, th = run(tmake(tcfg, device="cpu"), _converted(params),
                     torch.as_tensor, lambda t: t.numpy())
    assert np.abs(jh - jc).max() > 0.1 and np.abs(th - tc).max() > 0.1
    np.testing.assert_allclose(tc, jc, atol=2e-2, rtol=0)
    np.testing.assert_allclose(th, jh, atol=2e-2, rtol=0)

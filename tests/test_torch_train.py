"""Single-device training in the port (`repro_torch.launch.train`,
`optim/`, `data/pipeline.py`, `make_model`'s remat), held against the JAX
package on the CPU, every input made from a numpy seed.

  * `TokenPipeline`: the same seed gives the reference's batches bit for
    bit, plain and packed.
  * `block_quantize`, `block_dequantize`, `quantize_residual`: bit for
    bit; `compressed_psum` over 4 CPU shards against the exact sum, with
    the reference test's bound (tests/test_gmi.py:85: 2 * max|sum| / 127
    + 1e-6).
  * `adamw`, `adamw8`, `sgdm`: three updates from the same params, grads
    and state equal the reference's `update` run op by op, bit for bit
    (params, f32 moments, int8 `q` and f32 `s`).  The jitted reference
    parts from both by an ulp or two (XLA contracts the moment updates
    into fused multiply-adds), which is why the eager one is the oracle.
  * `cosine_schedule` within 1e-7 x the base rate of the reference's
    (their f32 cos part by an ulp, which 1 + cos carries into the rate),
    `clip_by_global_norm` within 2e-6 relative (their f32 sums take other
    orders).
  * `opt_state_specs` on a (2, 4) plan's param specs equals the
    reference's, field for field, for adamw and adamw8.
  * `make_train_step` from JAX weights (`params_from_jax`) against
    `jax.jit(repro.launch.train.make_train_step(...))`: reduced
    smollm-135m, 3 steps at n_micro 1 and 2, and one step of reduced
    moonshot-v1-16b-a3b (MoE) and recurrentgemma-2b (recurrent): loss
    within 1e-4 relative, grad norm within 5e-3 relative (bf16 forward
    and backward, in XLA's and torch's orders).
  * Remat gives the gradients of no remat bit for bit, for every
    family kind.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.core.cluster_builder import build_plan as jbuild_plan
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch import train as jtrain
from repro.launch.mesh import make_abstract_mesh as jabstract
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro.optim import compression as jcomp
from repro.optim import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.core.cluster_builder import build_plan
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_abstract_mesh, make_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params, make_model
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizer as topt

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype.name \
        == "bfloat16" else np.asarray(x)


@pytest.mark.parametrize("pack", [False, True])
def test_pipeline_batches_equal_the_reference(pack):
    for seed in (0, 7):
        want = JPipe(1000, 4, 64, seed=seed, pack=pack)
        got = TokenPipeline(1000, 4, 64, seed=seed, pack=pack)
        for _ in range(3):
            a, b = want.next_batch(), got.next_batch()
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(
                    a[k], b[k]), (seed, k)


def test_block_quantize_and_residual_equal_the_reference():
    rng = np.random.default_rng(0)
    for shape, block in (((1000,), 256), ((8, 64), 256), ((3, 5, 7), 16)):
        x = rng.normal(0, 3, shape).astype(np.float32)
        q, s, pad = jcomp.block_quantize(jnp.asarray(x), block)
        q2, s2, pad2 = tcomp.block_quantize(torch.from_numpy(x), block)
        assert pad == pad2
        assert np.array_equal(np.asarray(q), q2.numpy())
        assert np.array_equal(np.asarray(s), s2.numpy())
        assert np.array_equal(
            np.asarray(jcomp.block_dequantize(q, s, pad, shape)),
            tcomp.block_dequantize(q2, s2, pad2, shape).numpy())
        (_, _, _), r = jcomp.quantize_residual(jnp.asarray(x), block)
        (_, _, _), r2 = tcomp.quantize_residual(torch.from_numpy(x), block)
        assert np.array_equal(np.asarray(r), r2.numpy())


def test_compressed_psum_close_to_exact():
    """Over a (4,) 'pod' mesh of CPU shards, each holding one row block of
    a (8, 64) array: every shard gets the sum of the 4 blocks."""
    g = np.random.default_rng(0).normal(0, 1, (8, 64)).astype(np.float32)
    mesh = make_mesh((4,), ("pod",), device="cpu")
    xs = [torch.from_numpy(g[2 * i:2 * i + 2]) for i in range(4)]
    got = tcomp.compressed_psum(xs, mesh, "pod")
    exact = sum(g[2 * i:2 * i + 2] for i in range(4))
    scale = np.abs(exact).max()
    for out in got:
        assert out.shape == (2, 64)
        assert np.abs(out.numpy() - exact).max() <= 2 * scale / 127 + 1e-6
    assert all(torch.equal(got[0], o) for o in got[1:])


def _tree(rng, dtype):
    shapes = {"a": (8, 48), "b": {"c": (300,), "d": (4, 3, 5)}, "e": ()}

    def mk(sub):
        if isinstance(sub, dict):
            return {k: mk(v) for k, v in sub.items()}
        return rng.normal(0, 1, sub).astype(np.float32).astype(dtype)
    return mk(shapes)


@pytest.mark.parametrize("name", ["adamw", "adamw8", "sgdm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_updates_equal_the_reference(name, dtype):
    import ml_dtypes
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    t_dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    p, grads = _tree(rng, np_dt), [_tree(rng, np_dt) for _ in range(3)]
    jp = jax.tree.map(jnp.asarray, p)
    tp = topt.tree_map(lambda x: torch.from_numpy(
        x.astype(np.float32)).to(t_dt), p)
    ji, ju = jopt.make_optimizer(name, jopt.cosine_schedule(0.01, 5, 30))
    ti, tu = topt.make_optimizer(name, topt.cosine_schedule(0.01, 5, 30))
    js, ts = ji(jp), ti(tp)
    for g in grads:  # op by op: no fused multiply-adds
        jp, js = ju(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = tu(topt.tree_map(lambda x: torch.from_numpy(
            x.astype(np.float32)).to(t_dt), g), ts, tp)
    want = jax.tree.leaves((jp, js))
    got = topt.tree_leaves({0: tp, 1: ts})
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert _np(a).dtype == _np(b).dtype and np.array_equal(
            _np(a), _np(b))
    if name == "adamw8":
        assert ts["m"]["a"]["q"].dtype == torch.int8
        assert tuple(ts["m"]["a"]["s"].shape) == (8, 3)  # 48 = 3 x 16


def test_schedule_and_clip_match():
    jl = jopt.cosine_schedule(3e-3, 5, 30)
    tl = topt.cosine_schedule(3e-3, 5, 30)
    for step in range(0, 32):
        a = float(jl(jnp.asarray(step)))
        b = float(tl(torch.tensor(step, dtype=torch.int32)))
        assert abs(a - b) <= 1e-7 * 3e-3, step
    rng = np.random.default_rng(2)
    for scale in (0.01, 10.0):
        g = {"a": rng.normal(0, scale, (64, 32)).astype(np.float32),
             "b": {"c": rng.normal(0, scale, (1000,)).astype(np.float32)}}
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tc, tn = topt.clip_by_global_norm(
            topt.tree_map(torch.from_numpy, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=2e-6)
        for a, b in zip(jax.tree.leaves(jc), topt.tree_leaves(tc)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("name", ["adamw", "adamw8"])
def test_opt_state_specs_match_the_reference(name):
    arch = "smollm-135m"
    jcfg, tcfg = jget(arch), tget(arch)
    jshape = jax.eval_shape(lambda k: jinit(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    jplan = jbuild_plan(jcfg, jabstract((2, 4), ("data", "model")))
    jinit_opt, _ = jopt.make_optimizer(name, lambda s: 0.0)
    want = jtrain.opt_state_specs(jax.eval_shape(jinit_opt, jshape),
                                  jplan.specs_for_params(jshape))
    tshape = init_params(tcfg, device="meta")
    plan = build_plan(tcfg, make_abstract_mesh((2, 4), ("data", "model")))
    tinit_opt, _ = topt.make_optimizer(name, lambda s: 0.0)
    got = ttrain.opt_state_specs(tinit_opt(tshape),
                                 plan.specs_for_params(tshape))

    def flat(tree, pre=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k], pre + (k,))]
        return [(pre, tuple(tree))]
    assert flat(want) == flat(got)
    assert any(s for _, s in flat(got))  # something is cut


def _step_pair(arch, steps, n_micro, batch=4, seq=32):
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ji, ju = jopt.make_optimizer("adamw", jopt.cosine_schedule(3e-3, 5, 30))
    ti, tu = topt.make_optimizer("adamw", topt.cosine_schedule(3e-3, 5, 30))
    jstep = jax.jit(jtrain.make_train_step(jmake(jcfg), ju, n_micro=n_micro))
    tstep = ttrain.make_train_step(make_model(tcfg, device="cpu"), tu,
                                   n_micro=n_micro)
    js, ts = ji(jp), ti(tp)
    pipe = TokenPipeline(tcfg.vocab_size, batch, seq, seed=0)
    out = []
    for _ in range(steps):
        b = pipe.next_batch()
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.as_tensor(v)
                                    for k, v in b.items()})
        out.append([(float(jm[k]), float(tm[k]))
                    for k in ("loss", "grad_norm")])
    assert int(ts["step"]) == steps
    return out


@pytest.mark.parametrize("arch,steps,n_micro", [
    ("smollm-135m", 3, 1), ("smollm-135m", 3, 2),
    ("moonshot-v1-16b-a3b", 1, 1), ("recurrentgemma-2b", 1, 1)])
def test_train_step_matches_jax(arch, steps, n_micro):
    for (jl, tl), (jg, tg) in _step_pair(arch, steps, n_micro):
        assert abs(tl - jl) <= 1e-4 * abs(jl), (jl, tl)
        assert abs(tg - jg) <= 5e-3 * abs(jg), (jg, tg)


@pytest.mark.parametrize("arch", ["smollm-135m", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b", "xlstm-1.3b"])
def test_remat_gives_the_same_gradients(arch):
    cfg = tget(arch).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    b = TokenPipeline(cfg.vocab_size, 2, 32, seed=3).next_batch()
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    loss0, g0 = ttrain._grads(make_model(cfg, remat=False, device="cpu"),
                              params, batch)
    loss1, g1 = ttrain._grads(make_model(cfg, remat=True, device="cpu"),
                              params, batch)
    assert torch.equal(loss0, loss1)
    for a, b in zip(topt.tree_leaves(g0), topt.tree_leaves(g1)):
        assert torch.equal(a, b)

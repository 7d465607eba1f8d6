"""The port's W8A8 serving weights (`repro_torch.models.quantized`)
against the JAX package's (`repro.models.quantized`) on the CPU.

* `quantize_leaf`: the int8 values and the f32 per-channel scales equal
  JAX's bit for bit.  The reference quantizes eagerly (its executor calls
  it outside jit), so a scale is the IEEE quotient ``amax / 127``; `q` is
  stored column-major (``q.t()`` contiguous), the kernel's K-major read.
* `qdense`: the activation's int8 values and the int32 accumulators equal
  those of JAX's jitted `qdense` (the decode step's; XLA turns its ``/
  127`` into a multiply by float32(1/127), and the port does the same),
  and so does the bf16 output: after equal accumulators and equal scales
  the port's f32 product and bf16 rounding are JAX's, bit for bit.
* `quantize_params_for_serving`: only 2-d `QUANT_NAMES` leaves —
  recurrentgemma-2b's tail MLP at `.reduced()` — become {"q", "s"};
  `params_from_jax` of a JAX-quantized tree gives the port's layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import quantized as jq
from repro.models.transformer import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import quantized as tq
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving import engine as teng

torch.set_num_threads(1)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _w(seed, k=64, n=96, scale=0.05):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, scale, (k, n)).astype(
        np.float32)).astype(jnp.bfloat16)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_leaf_bit_exact(seed):
    w = _w(seed)
    want = jq.quantize_leaf(w)
    got = tq.quantize_leaf(_t(w))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == (1, w.shape[1])
    assert (got["q"].numpy() == np.asarray(want["q"])).all()
    assert (got["s"].numpy() == np.asarray(want["s"])).all()
    # column-major: the kernel reads the transpose as it is
    assert got["q"].t().is_contiguous() and not got["q"].is_contiguous()


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 64), (40, 64)])
def test_qdense_bit_exact(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    x = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)).astype(
        jnp.bfloat16)
    w = jq.quantize_leaf(_w(7))
    tw = tq.quantize_leaf(_t(_w(7)))

    def jax_parts(x, w):
        ax = jnp.maximum(jnp.max(jnp.abs(x.astype(jnp.float32))), 1e-8)
        s_x = ax / 127.0
        x8 = jnp.clip(jnp.round(x.astype(jnp.float32) / s_x), -127, 127
                      ).astype(jnp.int8)
        acc = jax.lax.dot_general(
            x8, w["q"], (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32)
        return x8, s_x, acc

    x8, s_x, acc = jax.jit(jax_parts)(x, w)  # as inside the decode step
    g8, gs = tq.quantize_activation(_t(x))
    assert (g8.numpy() == np.asarray(x8)).all()
    assert gs.item() == float(s_x)
    gacc = ops.int8_matmul(g8.reshape(-1, shape[-1]), tw["q"], 1.0, 1.0)
    assert (gacc.reshape(np.asarray(acc).shape).numpy()
            == np.asarray(acc)).all()
    want = jax.jit(jq.qdense)(x, w)
    got = tq.qdense(_t(x), tw)
    assert got.dtype == torch.bfloat16
    assert (got.view(torch.int16).numpy()
            == np.asarray(want).view(np.int16)).all()


def test_int8_matmul_takes_column_major_weights():
    """The plain version of the GEMM gives the same int32 accumulators
    for a column-major (K, N) weight as for its row-major copy."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.integers(-127, 128, (5, 64)), dtype=torch.int8)
    q = tq.quantize_leaf(_t(_w(2)))["q"]
    assert torch.equal(ops.int8_matmul(a, q, 1.0, 1.0),
                       ops.int8_matmul(a, q.contiguous(), 1.0, 1.0))


def _quantized_paths(tree, path=()):
    if isinstance(tree, dict):
        if tq.is_quantized(tree):
            return [path]
        return [p for k, v in tree.items()
                for p in _quantized_paths(v, path + (k,))]
    return []


def test_quantize_params_only_2d_leaves():
    """Reduced recurrentgemma-2b (4 layers, a period of 3): only the tail
    layer's MLP is 2-d; the stacked "scan" leaves and the recurrent
    projections stay bf16.  smollm-135m quantizes nothing."""
    cfg = tget("recurrentgemma-2b").reduced()
    params = tinit(cfg, seed=0, device="cpu")
    qp = tq.quantize_params_for_serving(params)
    assert sorted(_quantized_paths(qp)) == [
        ("tail", "0", "ffn", n) for n in ("wg", "wi", "wo")]
    sm = tinit(tget("smollm-135m").reduced(), seed=0, device="cpu")
    assert _quantized_paths(tq.quantize_params_for_serving(sm)) == []


def test_params_from_jax_on_a_quantized_tree():
    """JAX's quantize_params_for_serving tree through params_from_jax:
    the same leaves, `q` column-major, equal to the port's own
    quantization of the converted bf16 tree."""
    cfg = get_config("recurrentgemma-2b").reduced()
    params = jinit(cfg, jax.random.PRNGKey(0))
    jqp = jq.quantize_params_for_serving(params)
    got = params_from_jax(jax.tree.map(np.asarray, jqp), device="cpu")
    own = tq.quantize_params_for_serving(
        params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    assert _quantized_paths(got) == _quantized_paths(own)
    for path in _quantized_paths(got):
        g, o = got, own
        for k in path:
            g, o = g[k], o[k]
        assert g["q"].t().is_contiguous()
        assert torch.equal(g["q"], o["q"]) and torch.equal(g["s"], o["s"])


def test_engine_quantizes_once_and_smollm_is_unchanged():
    """quant_weights=True quantizes the params at construction; for
    smollm-135m (every projection stacked, 3-d) the served params are the
    bf16 ones and the streams are those of quant_weights=False."""
    cfg = tget("smollm-135m").reduced()
    tm = tmake(cfg, device="cpu")
    tp = tinit(cfg, seed=0, device="cpu")
    streams = []
    for qw in (False, True):
        eng = teng.ContinuousBatchingEngine(tm, tp, max_batch=2,
                                            buckets=(16,),
                                            quant_weights=qw)
        assert _quantized_paths(eng.executor.params) == []
        for i in range(2):
            eng.submit(teng.Request(rid=i, prompt=np.arange(3 + i) + 5,
                                    max_new_tokens=4))
        streams.append([list(r.tokens_out) for r in eng.run()])
    assert streams[0] == streams[1]

"""The port's I-BERT encoder against the JAX package's, on a small config.

JAX parameters (with random biases and LayerNorm parameters, so that
every quantizer sees non-trivial values) are carried across by
`repro_torch.models.convert.params_from_jax`; token ids and masks are
numpy arrays handed to both.

Tolerances: the float forward and the calibration agree within rtol 1e-5
(atol 1e-6): only summation orders differ.  Everything integer is bit
for bit: the quantized tree given JAX's calibration, and the integer
encoder against JAX's impl="ref" path (whose int8 entry tensor is
asserted equal first, so that a float rounding flip in the embedding's
LayerNorm reads as such and not as a kernel fault).

Run as a script, the file holds the entry point's own model (ibert-base
at full width, 12 layers, weights and tokens from seed 0, seq 128)
against JAX's impl="ref" and prints one JSON line: whether the integer
outputs are bit-exact, and each package's integer-vs-float error.

  JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_ibert.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import ibert as jib
from repro_torch.configs import get_config
from repro_torch.core.quant import quantize
from repro_torch.launch import ibert_encoder
from repro_torch.models import ibert as tib
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=256, vocab_size=500, max_seq_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def small():
    jcfg = dataclasses.replace(jget_config("ibert-base"), **SMALL)
    tcfg = dataclasses.replace(get_config("ibert-base"), **SMALL)
    params = _np(jib.init_ibert_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for lp in params["layers"].values():
        for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
            b = lp[name]["b"]
            lp[name]["b"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
        for name in ("ln1", "ln2"):
            d = lp[name]["g"].shape
            lp[name]["g"] = rng.uniform(0.6, 1.4, d).astype(np.float32)
            lp[name]["b"] = rng.normal(0, 0.1, d).astype(np.float32)
    toks = rng.integers(0, SMALL["vocab_size"], (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), bool)
    mask[1, 16:] = False
    jparams = jax.tree.map(jnp.asarray, params)
    act = jib.calibrate(jparams, jcfg, jnp.asarray(toks), jnp.asarray(mask))
    qp = jib.quantize_ibert(jparams, jcfg, act)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, jqp=qp,
                tparams=params_from_jax(params, device="cpu"),
                tqp=params_from_jax(_np(qp), device="cpu"), toks=toks,
                mask=mask, act=_np(act))


def test_float_forward_matches_jax(small):
    s = small
    for mask in (None, s["mask"]):
        want = jib.ibert_float_forward(
            s["jparams"], s["jcfg"], jnp.asarray(s["toks"]),
            None if mask is None else jnp.asarray(mask))
        got = tib.ibert_float_forward(
            s["tparams"], s["tcfg"], torch.from_numpy(s["toks"]),
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_calibrate_matches_jax(small):
    s = small
    got = tib.calibrate(s["tparams"], s["tcfg"], torch.from_numpy(s["toks"]),
                        torch.from_numpy(s["mask"]))
    assert sorted(got) == sorted(s["act"])
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), s["act"][k], rtol=1e-5,
                                   err_msg=k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, tuple):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_quantize_ibert_matches_jax_bit_for_bit(small):
    s = small
    act = {k: torch.from_numpy(np.array(v)) for k, v in s["act"].items()}
    got = dict(_leaves(tib.quantize_ibert(s["tparams"], s["tcfg"], act)))
    want = dict(_leaves(_np(s["jqp"])))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == getattr(torch, str(np.asarray(w).dtype)), k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        if g.dim() == 0:
            assert g.device.type == "cpu", k  # scales are host metadata


def test_quantized_weights_are_column_major(small):
    """quantize_ibert keeps each int8 weight (K, N) with the reference's
    values but column-major, the layout the card's int8_matmul reads
    without a copy; moving the tree to another device keeps it."""
    s = small
    act = {k: torch.from_numpy(np.array(v)) for k, v in s["act"].items()}
    qp = tib.quantize_ibert(s["tparams"], s["tcfg"], act)
    ws = [lin["w"] for layer in qp["layers"].values()
          for name, lin in layer.items() if name.startswith("w")]
    assert len(ws) == 6 * s["tcfg"].n_layers
    for w in ws:
        assert w.dtype == torch.int8 and w.dim() == 2
        assert w.t().is_contiguous() and w.stride() == (1, w.shape[0])
        moved = w.to("cpu", copy=True)  # .to(dev) keeps dense strides
        assert moved.stride() == w.stride()


@pytest.mark.parametrize("masked", [False, True])
def test_int_forward_matches_jax_ref_bit_for_bit(small, masked):
    s = small
    mask = s["mask"] if masked else None
    jtoks = jnp.asarray(s["toks"])
    ttoks = torch.from_numpy(s["toks"])
    # the entry tensor first: float embedding + LayerNorm + int8 quantize
    h = jib._f_ln(s["jqp"]["tok"][jtoks] + s["jqp"]["pos"][:24][None],
                  s["jqp"]["emb_ln"])
    from repro.core.quant import quantize as jquantize
    want_x = np.asarray(jquantize(h, scale=s["jqp"]["s_emb"]).values)
    x = tib.ibert_embed(s["tqp"], ttoks)
    np.testing.assert_array_equal(x.values.numpy(), want_x)

    want = jib.ibert_int_forward(s["jqp"], s["jcfg"], jtoks,
                                 None if mask is None else jnp.asarray(mask),
                                 impl="ref")
    got = tib.ibert_int_forward(s["tqp"], s["tcfg"], ttoks,
                                None if mask is None
                                else torch.from_numpy(mask))
    assert got.values.dtype == torch.int8
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_integer_tracks_float(small):
    s = small
    toks, mask = torch.from_numpy(s["toks"]), torch.from_numpy(s["mask"])
    out_f = tib.ibert_float_forward(s["tparams"], s["tcfg"], toks, mask)
    out_i = tib.ibert_int_forward(s["tqp"], s["tcfg"], toks, mask)
    err = (out_i.dequantize() - out_f).abs()
    assert err.max() < 0.5 * out_f.std()
    assert err.mean() < 0.1 * out_f.std()


def test_no_padding_equivalence(small):
    """Paper §7.1: a short sequence run unpadded matches it run padded
    with a mask, per token (as tests/test_ibert_model.py holds JAX)."""
    s = small
    short = torch.from_numpy(s["toks"][:1, :10])
    out_short = tib.ibert_int_forward(s["tqp"], s["tcfg"], short,
                                      torch.ones((1, 10), dtype=torch.bool))
    padded = torch.zeros((1, 24), dtype=short.dtype)
    padded[:, :10] = short
    pmask = torch.zeros((1, 24), dtype=torch.bool)
    pmask[:, :10] = True
    out_pad = tib.ibert_int_forward(s["tqp"], s["tcfg"], padded, pmask)
    a = out_short.dequantize()
    b = out_pad.dequantize()[:, :10]
    assert (a - b).abs().max() < 0.05


def test_trace_records_every_site_in_order(small):
    s = small
    trace = {}
    x = tib.ibert_embed(s["tqp"], torch.from_numpy(s["toks"]))
    out = tib.ibert_encode(s["tqp"], s["tcfg"], x, trace=trace)
    sites = ("q", "k", "v", "scores", "probs", "ctx", "attn", "ln1", "gelu",
             "ff2", "ln2")
    assert list(trace) == [f"L{i}.{n}" for i in range(2) for n in sites]
    assert torch.equal(trace["L1.ln2"], out.values)


def test_quantize_entry_divides_on_the_data_device():
    """quantize(x, scale) with a scale held on the CPU: the division is
    IEEE float32 (x / scale), not x * (1 / scale)."""
    x = torch.tensor([0.7, 1.3, -2.9], dtype=torch.float32)
    s = torch.tensor(0.1, dtype=torch.float32)
    want = np.clip(np.sign(x.numpy() / np.float32(0.1))
                   * np.floor(np.abs(x.numpy() / np.float32(0.1)) + 0.5),
                   -127, 127)
    np.testing.assert_array_equal(quantize(x, scale=s).values.numpy(), want)


def test_entry_point_runs_on_cpu_when_asked(capsys):
    out = ibert_encoder.main(["--device", "cpu", "--layers", "1",
                              "--seq-lens", "8"])
    printed = capsys.readouterr().out
    assert "integer vs float" in printed and "Eq.1" in printed
    assert out["error"]["max"] < 0.5 * out["error"]["std"]
    assert [r["seq"] for r in out["times"]] == [8]
    assert out["times"][0]["forward_ms"] > 0


def reference_at_depth(n_layers: int, seq: int, seed: int = 0,
                       **widths) -> dict:
    """The entry point's float weights and tokens for `seed` through both
    packages.  JAX calibrates, quantizes and runs impl="ref"; the port
    runs JAX's quantized tree on the CPU, and also calibrates and
    quantizes for itself, as the entry point does.  Returns whether the
    two integer outputs are bit-exact, and each side's integer-vs-float
    error (max, mean, and the float output's std)."""
    tcfg = dataclasses.replace(get_config("ibert-base"), n_layers=n_layers,
                               **widths)
    jcfg = dataclasses.replace(jget_config("ibert-base"), n_layers=n_layers,
                               **widths)
    params = tib.init_ibert_params(tcfg, seed=seed, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    ttoks = ibert_encoder.make_tokens(tcfg, 1, seq, seed, "cpu")
    jtoks = jnp.asarray(ttoks.numpy())
    jqp = jib.quantize_ibert(jparams, jcfg,
                             jib.calibrate(jparams, jcfg, jtoks))
    want = jib.ibert_int_forward(jqp, jcfg, jtoks, impl="ref")
    out_f = np.asarray(jib.ibert_float_forward(jparams, jcfg, jtoks))
    err = np.abs(np.asarray(want.dequantize()) - out_f)
    with torch.no_grad():
        got = tib.ibert_int_forward(params_from_jax(_np(jqp), device="cpu"),
                                    tcfg, ttoks)
        tqp = tib.quantize_ibert(params, tcfg,
                                 tib.calibrate(params, tcfg, ttoks))
    return {"bit_exact": bool(np.array_equal(got.values.numpy(),
                                             np.asarray(want.values))),
            "jax": {"max": float(err.max()), "mean": float(err.mean()),
                    "std": float(out_f.std(ddof=1))},
            "port": ibert_encoder.int_vs_float(params, tqp, tcfg, ttoks)}


@pytest.mark.parametrize("n_layers, widths", [
    (12, {k: v for k, v in SMALL.items() if k != "n_layers"}),
    (2, {"vocab_size": 1000}),  # ibert-base's widths, vocabulary cut
], ids=["12-layers-small", "2-layers-full-width"])
def test_int_forward_matches_jax_ref_at_depth(n_layers, widths):
    """The entry point's weights, deep or at full width: bit-exact
    against JAX's impl="ref", and the port's integer-vs-float error (its
    own calibration) is JAX's within rtol 1e-3."""
    r = reference_at_depth(n_layers, 24, **widths)
    assert r["bit_exact"]
    for k in ("max", "mean", "std"):
        np.testing.assert_allclose(r["port"][k], r["jax"][k], rtol=1e-3,
                                   err_msg=k)


if __name__ == "__main__":
    print(json.dumps(reference_at_depth(12, ibert_encoder.CALIB_SEQ)))

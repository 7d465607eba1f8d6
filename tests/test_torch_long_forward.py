"""The port's long-context forward against the JAX package's, on the CPU:
`Model.forward_logits`, `Model.loss` and `Model.prefill` without
positions at S = 1100 > DENSE_ATTN_MAX_KV, where both models attend
through `flash_attention` (JAX: the Pallas kernel body under
`impl="interpret"`; the port: the wrapper's plain version on CPU
tensors), with the same weights (JAX `init_params` through
`params_from_jax`) and the same numpy tokens.

Two configs: reduced smollm-135m (hd 16, where 1/sqrt(hd) = 0.25 is
exact) and reduced phi3-medium-14b at hd 32 (1/sqrt(32) is inexact; its
untied `head` leaf crosses the weight bridge).  A port that handed the
kernel the bf16-scaled q would be scaled twice and miss the logits by
~0.9 at both configs.

Tolerances: logits 2e-2, as tests/test_torch_model.py's prefill logits
(|logit| < 1 on random weights; two bf16 layers summed in other orders:
measured 0.013); the mean loss 1e-3 (f32 logsumexp of those logits:
measured 4e-5); the logits of decode steps after the long prefill 2e-2
(measured 0.007).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake

torch.set_num_threads(1)

S = 1100  # > DENSE_ATTN_MAX_KV = 1024, and no multiple of 64 or 256
STEPS = 4
LOGIT_TOL, LOSS_TOL = 2e-2, 1e-3


def _configs(name, head_dim):
    cfg, tcfg = get_config(name).reduced(), tget(name).reduced()
    if head_dim:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
        tcfg = dataclasses.replace(tcfg, head_dim=head_dim)
    return cfg, tcfg


def _batch(vocab):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :100] = -1  # ignored positions
    return toks, labels


def _run_jax(cfg, params, toks, labels):
    jm = jmake(cfg, remat=False)
    with jops.pinned_impl("interpret"):
        logits = jm.forward_logits(params, tokens=jnp.asarray(toks))
        loss = jm.loss(params, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
        lg, caches = jm.prefill(params, jm.init_cache(1, S + STEPS),
                                tokens=jnp.asarray(toks[:1]))
        steps = [lg]
        for i in range(STEPS):
            lg, caches = jm.decode_step(params, caches,
                                        jnp.asarray(toks[1, i:i + 1]))
            steps.append(lg)
    return dict(logits=np.asarray(logits), loss=float(loss),
                steps=[np.asarray(x) for x in steps],
                pos=np.asarray(caches["pos"]))


def _run_port(tcfg, tp, toks, labels):
    tm = tmake(tcfg, device="cpu")
    with torch.no_grad():
        logits = tm.forward_logits(tp, torch.tensor(toks))
        loss = tm.loss(tp, {"tokens": torch.tensor(toks),
                            "labels": torch.tensor(labels)})
        lg, caches = tm.prefill(tp, tm.init_cache(1, S + STEPS),
                                torch.tensor(toks[:1]))
        steps = [lg]
        for i in range(STEPS):
            lg, caches = tm.decode_step(tp, caches,
                                        torch.tensor(toks[1, i:i + 1]))
            steps.append(lg)
    return dict(logits=logits, loss=loss, steps=steps, pos=caches["pos"])


@pytest.fixture(scope="module", params=[("smollm-135m", 0),
                                        ("phi3-medium-14b", 32)],
                ids=["smollm-135m", "phi3-medium-14b-hd32"])
def runs(request):
    cfg, tcfg = _configs(*request.param)
    params = jinit(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    toks, labels = _batch(cfg.vocab_size)
    return cfg, _run_jax(cfg, params, toks, labels), _run_port(
        tcfg, tp, toks, labels)


def test_forward_logits_match_jax(runs):
    cfg, want, got = runs
    lg = got["logits"]
    assert lg.dtype == torch.float32
    assert tuple(lg.shape) == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(lg.numpy(), want["logits"], atol=LOGIT_TOL,
                               rtol=0)


def test_loss_matches_jax(runs):
    _, want, got = runs
    loss = got["loss"]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want["loss"]) <= LOSS_TOL


def test_prefill_without_positions_then_decode_matches_jax(runs):
    _, want, got = runs
    assert (got["pos"].numpy() == want["pos"]).all()
    assert int(got["pos"][0]) == S + STEPS
    for i, (w, g) in enumerate(zip(want["steps"], got["steps"])):
        np.testing.assert_allclose(g.numpy(), w, atol=LOGIT_TOL, rtol=0,
                                   err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# routing, on the port alone
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    _, tcfg = _configs("smollm-135m", 0)
    toks = torch.tensor(_batch(tcfg.vocab_size)[0])
    return tcfg, tmake(tcfg, device="cpu"), tinit(tcfg, seed=0,
                                                   device="cpu"), toks


def _spy(monkeypatch):
    """Count calls of the flash_attention wrapper and of the chunked
    route (on CPU tensors the wrapper launches nothing, so
    ops.launches stays 0 here)."""
    calls = {"flash": 0, "chunked": 0}
    real_fa, real_ch = ops.flash_attention, attn_mod._chunked_attention

    def fa(*a, **kw):
        calls["flash"] += 1
        return real_fa(*a, **kw)

    def ch(*a, **kw):
        calls["chunked"] += 1
        return real_ch(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", fa)
    monkeypatch.setattr(attn_mod, "_chunked_attention", ch)
    return calls


def test_contiguous_long_inputs_run_flash_attention_once_per_layer(
        monkeypatch, small):
    cfg, model, params, toks = small
    calls = _spy(monkeypatch)
    labels = torch.roll(toks, -1, 1)
    with torch.no_grad():
        model.forward_logits(params, toks)
        assert calls == {"flash": cfg.n_layers, "chunked": 0}
        model.loss(params, {"tokens": toks, "labels": labels})
        assert calls == {"flash": 2 * cfg.n_layers, "chunked": 0}
        model.prefill(params, model.init_cache(2, S), toks)
        assert calls == {"flash": 3 * cfg.n_layers, "chunked": 0}
        # at 1024 tokens the dense route attends, as in the reference
        model.forward_logits(params, toks[:, :1024])
    assert calls == {"flash": 3 * cfg.n_layers, "chunked": 0}
    assert ops.launches["flash_attention"] == 0


def test_explicit_positions_and_segments_take_the_chunked_route(
        monkeypatch, small):
    cfg, model, params, toks = small
    with torch.no_grad():
        flash = model.forward_logits(params, toks)
    calls = _spy(monkeypatch)
    pos = torch.arange(S, dtype=torch.int32).expand(2, S)
    seg = torch.zeros((2, S), dtype=torch.int32)
    seg[:, 600:] = 1  # two packed documents per row
    with torch.no_grad():
        chunked = model.forward_logits(params, toks, positions=pos)
        assert calls == {"flash": 0, "chunked": cfg.n_layers}
        loss = model.loss(params, {"tokens": toks, "labels": toks,
                                   "segment_ids": seg})
    assert calls == {"flash": 0, "chunked": 2 * cfg.n_layers}
    assert torch.isfinite(loss)
    # the two routes compute the same attention at the same positions
    np.testing.assert_allclose(chunked.numpy(), flash.numpy(),
                               atol=LOGIT_TOL, rtol=0)


def test_loss_takes_embeds_and_ignores_negative_labels(small):
    cfg, model, params, toks = small
    toks = toks[:, :40]
    embeds = params["embed"]["tok"][toks.long()].float()
    labels = torch.roll(toks, -1, 1)
    masked = labels.clone()
    masked[:, 20:] = -1
    with torch.no_grad():
        full = model.loss(params, {"tokens": toks, "labels": labels})
        same = model.loss(params, {"embeds": embeds, "labels": labels})
        half = model.loss(params, {"tokens": toks, "labels": masked})
        head = model.loss(params, {"tokens": toks[:, :20],
                                   "labels": labels[:, :20]})
        none = model.loss(params, {"tokens": toks,
                                   "labels": torch.full_like(labels, -1)})
    assert torch.equal(full, same)
    # causal: the first 20 positions' loss does not see the rest (f32
    # sums over 20 rows taken in other blocks: a few ulps of ~5.5)
    assert abs(float(half) - float(head)) <= 1e-5
    assert float(none) == 0.0


def test_phi3_config_matches_the_reference():
    assert (tget("phi3-medium-14b").__dict__
            == get_config("phi3-medium-14b").__dict__)

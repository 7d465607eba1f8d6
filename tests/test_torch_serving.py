"""The port's paged continuous-batching engine against the JAX engine.

One cloned request stream goes through `repro.serving.engine
.ContinuousBatchingEngine` (kernels pinned to the jnp oracle) and through
`repro_torch.serving.engine.ContinuousBatchingEngine` on the CPU, with the
same fitted weights (`fit_affine_lm`, 300 steps, converted by
`params_from_jax`).  Every request's token stream must be identical
(token match rate 1.0), and so must the engine's prefix hits, peak pages,
preemptions and decode dispatches.

The streams have the shapes of `poisson_requests` and
`shared_prefix_requests` (rate 0, deadline 0: strict FIFO admission, so
the order does not depend on either engine's speed), but their prompts
are affine runs — the fitted model's own distribution.  On random prompts
that model still emits exact bf16 top-2 ties, which any summation reorder
breaks differently; the stream seed is one whose runs stay clear of them.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.kernels.ops import pinned_impl
from repro.models.synthetic import affine_prompts, fit_affine_lm
from repro.models.transformer import make_model as jmake
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.configs import get_config as tget
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import make_model as tmake
from repro_torch.serving.engine import ContinuousBatchingEngine as TorchEngine
from repro_torch.serving.scheduler import Request as TorchRequest

torch.set_num_threads(1)

CFG = get_config("smollm-135m").reduced()
STATS = ("prefix_hits", "pages_peak", "preemptions", "decode_dispatches",
         "decode_steps", "prefills", "admitted", "completed")


@pytest.fixture(scope="module")
def models():
    jm = jmake(CFG, remat=False)
    params = fit_affine_lm(jm, steps=300)
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jm, params, tmake(tget("smollm-135m").reduced(), device="cpu"), tp


def _stream(kind, seed=2):
    """(prompt, budget) pairs shaped like the reference stream builders."""
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        prompts = affine_prompts(rng, 10, CFG.vocab_size, (4, 30))
        budgets = [int(rng.integers(4, 20)) for _ in prompts]
    else:
        prefix = affine_prompts(rng, 1, CFG.vocab_size, (24, 25))[0]
        prompts = [np.concatenate([prefix, s]).astype(np.int32) for s in
                   affine_prompts(rng, 8, CFG.vocab_size, (3, 9))]
        budgets = [int(rng.integers(8, 24)) for _ in prompts]
    return list(zip(prompts, budgets))


def _serve(engine_cls, request_cls, model, params, stream, num_pages):
    eng = engine_cls(model, params, max_batch=3, buckets=(16, 32),
                     deadline_s=0.0, page_size=4, num_pages=num_pages,
                     max_decode_len=32)
    for i, (p, b) in enumerate(stream):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=b))
    return eng.run(), eng.stats


@pytest.mark.parametrize("kind,num_pages", [("poisson", 20),
                                            ("shared-prefix", 20),
                                            ("shared-prefix", 40)])
def test_engine_matches_jax_engine(models, kind, num_pages):
    jm, params, tm, tp = models
    stream = _stream(kind)
    with pinned_impl("ref"):
        jdone, jstats = _serve(JaxEngine, JaxRequest, jm, params, stream,
                               num_pages)
    tdone, tstats = _serve(TorchEngine, TorchRequest, tm, tp, stream,
                           num_pages)
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    total = sum(len(r.tokens_out) for r in jdone)
    matched = sum(int(a == b) for jr, tr in zip(jdone, tdone)
                  for a, b in zip(jr.tokens_out, tr.tokens_out))
    assert [len(r.tokens_out) for r in tdone] == \
        [len(r.tokens_out) for r in jdone]
    assert matched / total == 1.0, (matched, total)
    assert {k: tstats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    assert all(r.done and len(r.tokens_out) == b
               for r, (_, b) in zip(tdone, stream))
    if kind == "shared-prefix":
        assert tstats["prefix_hits"] > 0
    if num_pages == 20:
        assert tstats["preemptions"] > 0  # the tight pool preempts


def test_engine_refuses_unported_options(models):
    _, _, tm, tp = models
    # int8 KV pages, dense slots (paged=False), speculation (spec_config),
    # W8A8 weights (quant_weights), serve plans (plan) and disaggregated
    # pools (disagg) are ported since; their refusals left this list
    # (tests/test_torch_dense_serving.py, tests/test_torch_spec_decode.py,
    # tests/test_torch_quantized.py, tests/test_torch_disagg_serving.py;
    # what plans still refuse, tests/test_torch_sharded_serving.py), so
    # the engine no longer raises NotImplementedError for any of them
    for kw in ({"disagg": (1, 1)},):
        eng = TorchEngine(tm, tp, max_batch=2, buckets=(16,), **kw)
        assert eng.disagg == (1, 1) and eng.kv_prefill is not None

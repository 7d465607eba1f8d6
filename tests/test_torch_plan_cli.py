"""The serve CLI's `--plan auto`, `--traffic`, `--no-plan` and
`--replicas 0` (`repro_torch.launch.serve`), on the CPU at the reduced
smollm-135m: the search's choice is served as the reference's CLI serves
it (`repro/launch/serve.py`); a choice the port does not serve raises
the engine's refusal instead of serving another candidate."""
import json

import pytest

from repro_torch.configs import get_config
from repro_torch.core.plan_search import TrafficProfile, search
from repro_torch.launch import serve as serve_cli

BASE = ["--device", "cpu", "--reduced", "--requests", "6", "--max-new", "5"]
TWO = dict(devices=2, hbm_gb=80.0)
# a tight TTFT target on long prompts: the fastest prefill, a 2-wide
# tensor-parallel plan (throughput form, W8A8 weights)
CUT = dict(devices=2, hbm_gb=80.0, prompt_mean=1e6, ttft_target_ms=1e-6)


def _profile(tmp_path, **fields):
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(dict(name="test", **fields)))
    return str(path)


def _streams(args, **kw):
    _, done, _ = serve_cli.serve(serve_cli.parse_args(args), **kw)
    return {r.rid: tuple(r.tokens_out) for r in done}


def test_the_h100_choice_for_smollm_on_two_devices():
    res = search(get_config("smollm-135m"), TrafficProfile(devices=2))
    assert res.chosen.key == "serve.tp1.r2.exact.kv=ps8.int8.w=int8"


def test_plan_auto_serves_the_choice_and_prints_the_frontier(tmp_path,
                                                             capsys):
    traffic = _profile(tmp_path, **TWO)
    done = serve_cli.main(BASE + ["--plan", "auto", "--traffic", traffic])
    out = capsys.readouterr().out
    assert "plan auto-search: arch=smollm-135m-reduced profile=test" in out
    assert "on the Pareto frontier" in out
    assert " *serve.tp1.r2.exact.kv=ps8.int8.w=int8" in out
    assert "  chosen: serve.tp1.r2.exact.kv=ps8.int8.w=int8" in out
    assert "serve[fleet]:" in out and "replicas=2" in out
    assert len(done) == 6 and all(r.done for r in done)


def test_the_choice_reaches_the_engines_and_equals_the_plain_engine(
        tmp_path):
    """--replicas 0 takes the choice's 2 replicas, each on int8 pages of
    8 with W8A8 (smollm's stacked leaves stay bf16); FIFO admission, so
    the streams equal one plain engine's on the same pages."""
    args = serve_cli.parse_args(BASE + ["--plan", "auto", "--traffic",
                                        _profile(tmp_path, **TWO)])
    assert args.replicas == 0
    router, done, _ = serve_cli.serve(args, deadline_s=0.0)
    assert args.chosen.key == "serve.tp1.r2.exact.kv=ps8.int8.w=int8"
    assert args.replicas == 2 and args.plan == "serve" and args.exact
    assert args.quant_weights and args.mesh == "1,1"
    engines = [r.engine for r in router.replicas]
    assert len(engines) == 2
    for e in engines:
        assert e.paged and e.page_size == 8 and e.kv_dtype == "int8"
        assert e.plan.mesh.shape == {"data": 1, "model": 1}
        assert e.executor.quant_weights
    want = _streams(BASE + ["--plan", "none", "--page-size", "8",
                            "--kv-dtype", "int8", "--quant-weights"],
                    deadline_s=0.0)
    assert {r.rid: tuple(r.tokens_out) for r in done} == want


def test_explicit_replicas_override_the_choice(tmp_path, capsys):
    serve_cli.main(BASE + ["--plan", "auto", "--traffic",
                           _profile(tmp_path, **TWO), "--replicas", "1"])
    out = capsys.readouterr().out
    assert "serve[cb]:" in out and "mesh={'data': 2, 'model': 1}" in out
    assert "kv_dtype=int8 quant_weights=True" in out


def test_replicas_zero_without_auto_is_one(capsys):
    serve_cli.main(BASE + ["--plan", "none"])
    assert "serve[cb]:" in capsys.readouterr().out


def test_no_plan_is_plan_none():
    assert serve_cli.parse_args(["--no-plan"]).plan == "none"
    assert serve_cli.parse_args(["--no-plan", "--plan", "serve"]).plan \
        == "none"
    got = _streams(BASE + ["--no-plan"], deadline_s=0.0)
    assert got == _streams(BASE + ["--plan", "none"], deadline_s=0.0)


def test_plan_auto_dryrun_prints_the_choices_shardings(tmp_path, capsys):
    done = serve_cli.main(["--device", "cpu", "--reduced", "--plan", "auto",
                           "--traffic", _profile(tmp_path, **TWO),
                           "--dryrun"])
    out = capsys.readouterr().out
    assert done == []
    assert "chosen: serve.tp1.r2.exact.kv=ps8.int8.w=int8" in out
    assert ("serve --dryrun: arch=smollm-135m-reduced mode=serve "
            "exact=True mesh={'data': 2, 'model': 1} paged=True") in out
    assert "-- params" in out and "(paged arena)" in out


@pytest.mark.parametrize("arch,option", [
    ("smollm-135m", "W8A8 weights under a plan"),
    ("moonshot-v1-16b-a3b", "W8A8 weights under a plan")])
def test_a_choice_the_port_refuses_raises(arch, option, tmp_path, capsys):
    """The port refused this choice's `option` until W8A8 weights served
    under a tensor-parallel plan; now the CLI serves the choice itself
    (nothing quantized: both models' projections are stacked)."""
    done = serve_cli.main(BASE + ["--arch", arch, "--plan", "auto",
                                  "--traffic", _profile(tmp_path, **CUT)])
    out = capsys.readouterr().out
    assert "chosen: serve.tp2.r1.tput.kv=ps16.int8.w=int8" in out
    assert ("plan=serve mesh={'data': 1, 'model': 2} exact=False "
            "kv_dtype=int8 quant_weights=True") in out
    assert len(done) == 6 and all(r.done for r in done)


def test_a_profile_with_unknown_keys_is_refused(tmp_path):
    with pytest.raises(ValueError, match="hbm_gigs"):
        serve_cli.main(BASE + ["--plan", "auto", "--traffic",
                               _profile(tmp_path, hbm_gigs=80)])


def test_the_skewed_pipeline_rounds_max_batch_to_its_stages(capsys):
    serve_cli.main(BASE + ["--plan", "serve_pipeline", "--mesh", "2",
                           "--no-exact", "--max-batch", "3"])
    out = capsys.readouterr().out
    assert "max_batch 3 -> 4 (2 stages)" in out
    assert "plan=serve_pipeline mesh={'stage': 2} exact=False" in out

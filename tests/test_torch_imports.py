"""The port stands alone: no module of `repro_torch`, and not
`chip_smoke.py`, imports JAX or the JAX package; its CLIs run on the CPU
only when asked and otherwise refuse to start without a card."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.launch import ibert_encoder, serve

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]", out.stdout


def test_every_port_module_is_walked():
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    for want in ("repro_torch.kernels.ops", "repro_torch.kernels.build",
                 "repro_torch.serving.engine", "repro_torch.launch.serve",
                 "repro_torch.models.convert", "repro_torch.models.ibert",
                 "repro_torch.core.ibert_ops",
                 "repro_torch.launch.ibert_encoder",
                 "repro_torch.serving.wave", "repro_torch.core.quant",
                 "repro_torch.configs.phi3_medium_14b",
                 "repro_torch.core.plan_search",
                 "repro_torch.roofline.op_cost",
                 "repro_torch.launch.train", "repro_torch.optim.optimizer",
                 "repro_torch.optim.compression",
                 "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.checkpointing",
                 "repro_torch.runtime.fault_tolerance",
                 "repro_torch.runtime.elastic"):
        assert want in names


def test_cli_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--reduced", "--requests", "2"])


def test_ibert_cli_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        ibert_encoder.main(["--layers", "1", "--seq-lens", "8"])


def test_train_cli_refuses_to_start_without_a_card():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would run on it")
    with pytest.raises(SystemExit, match="--device cpu"):
        train.main(["--reduced", "--steps", "1"])


def test_cli_serves_on_cpu_when_asked(capsys):
    done = serve.main(["--reduced", "--device", "cpu", "--requests", "4",
                       "--max-new", "5", "--stream", "shared-prefix"])
    assert len(done) == 4 and all(len(r.tokens_out) == 5 for r in done)
    assert "prefix_hits" in capsys.readouterr().out


@pytest.mark.parametrize("route", [["--engine", "wave"],
                                   ["--kv-dtype", "int8"]])
def test_cli_serves_wave_and_int8_on_cpu(capsys, route):
    done = serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--max-new", "4"] + route)
    assert len(done) == 3 and all(len(r.tokens_out) == 4 for r in done)
    out = capsys.readouterr().out
    assert ("waves" in out) == (route[0] == "--engine")


def test_cli_refuses_int8_on_the_wave_engine():
    with pytest.raises(SystemExit, match="drop --engine wave"):
        serve.main(["--reduced", "--device", "cpu", "--engine", "wave",
                    "--kv-dtype", "int8"])

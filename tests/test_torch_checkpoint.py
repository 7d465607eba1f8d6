"""The port's training substrate on the CPU: checkpoints
(`repro_torch.checkpoint`), recovery and elastic helpers
(`repro_torch.runtime`), and the train CLI (`repro_torch.launch.train`).

  * A checkpoint written by the port restores with the reference's
    `repro.checkpoint.CheckpointManager`, and one the reference writes
    restores in the port: same files, bf16, f32, int8 and int32 leaves bit
    for bit (the port stores bf16 as its uint16 bits, the reference as
    2-byte voids; each reads the manifest's dtype).
  * A corrupted file fails its checksum, `keep` prunes, a `.tmp`
    directory is no checkpoint, an async save lands on `wait`.
  * `run_with_recovery` and the elastic helpers give the reference's
    results on the cases of tests/test_fault_tolerance.py.
  * The train CLI on the CPU (reduced smollm-135m) recovers an injected
    failure from its last checkpoint (restarts 1, step 12 failed,
    recovered from 10), packs sequences with --pack, and refuses --seq
    2048 on the card before it touches one.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JManager
from repro.runtime import run_with_recovery as jrun
from repro.runtime.elastic import (accumulation_steps as jacc,
                                   elastic_mesh_shape as jmesh,
                                   rebalanced_batch as jrebal)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train
from repro_torch.runtime import (FailureInjector, SimulatedFailure,
                                 accumulation_steps, elastic_mesh_shape,
                                 rebalanced_batch, run_with_recovery)

torch.set_num_threads(1)


def _tree(seed=0):
    """A params-like tree of numpy arrays (bf16 as float32 values that
    bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (8, 16)).astype(np.float32)
    return {"params": {
        "w": w, "bf": torch.from_numpy(w).bfloat16().float().numpy(),
        "emb": rng.integers(-5, 5, (4, 4)).astype(np.int8)},
        "step": np.int32(7)}


def _torch_tree(t):
    return {"params": {"w": torch.from_numpy(t["params"]["w"]),
                       "bf": torch.from_numpy(t["params"]["bf"]).bfloat16(),
                       "emb": torch.from_numpy(t["params"]["emb"])},
            "step": torch.tensor(int(t["step"]), dtype=torch.int32)}


def _jax_tree(t):
    return {"params": {"w": jnp.asarray(t["params"]["w"]),
                       "bf": jnp.asarray(t["params"]["bf"], jnp.bfloat16),
                       "emb": jnp.asarray(t["params"]["emb"])},
            "step": jnp.asarray(t["step"])}


def _same(a, b):
    """A torch tree against a JAX (or numpy) tree: dtypes and bits."""
    for k in ("w", "bf", "emb"):
        x, y = a["params"][k], np.asarray(b["params"][k])
        assert str(x.dtype).replace("torch.", "") == str(y.dtype), k
        xv = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        assert np.array_equal(xv.numpy(), y.view(np.int16) if y.dtype.name
                              == "bfloat16" else y), k
    assert int(a["step"]) == int(b["step"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    CheckpointManager(str(tmp_path), keep=3).save(
        3, _torch_tree(_tree()), blocking=True)
    step, tree = JManager(str(tmp_path)).restore()
    assert step == 3
    back = CheckpointManager(str(tmp_path)).restore(device="cpu")[1]
    _same(back, jax.tree.map(np.asarray, tree))
    _same(_torch_tree(_tree()), jax.tree.map(np.asarray, tree))
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert manifest["leaves"]["params/bf"]["dtype"] == "bfloat16"


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    JManager(str(tmp_path), keep=3).save(4, _jax_tree(_tree(1)),
                                         blocking=True)
    step, tree = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert step == 4 and tree["params"]["bf"].dtype == torch.bfloat16
    _same(tree, _jax_tree(_tree(1)))
    templ = CheckpointManager(str(tmp_path)).restore(
        device="cpu", template={"params": {"w": 0, "bf": 0, "emb": 0},
                                "step": 0, "empty": {}})[1]
    assert templ["empty"] == {} and torch.equal(templ["params"]["w"],
                                                tree["params"]["w"])


def test_checksum_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, _torch_tree(_tree()), blocking=True)
    d = tmp_path / "step_00000005"
    manifest = json.load(open(d / "manifest.json"))
    victim = manifest["leaves"]["params/w"]["file"]
    with open(d / victim, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="checksum mismatch for params/w"):
        mgr.restore(5, device="cpu")


def test_keep_prunes_and_async_saves_land(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, _torch_tree(_tree(s)))  # async: each waits for the last
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    _, tree = mgr.restore(2, device="cpu")
    _same(tree, _jax_tree(_tree(2)))
    assert tree["step"].shape == ()
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert mgr.all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(device="cpu")


def _recovery_case(runner, injector_cls):
    saved, log = {}, []
    injector = injector_cls({7: "node_loss", 13: "preemption"})

    def train_steps(state, start, stop):
        x = state["x"]
        for step in range(start, stop):
            injector.check(step)
            x += 1
            log.append(step)
        return {"x": x}

    def save(step, state):
        saved[step] = dict(state)

    def restore():
        if not saved:
            return None
        return max(saved), dict(saved[max(saved)])

    state, report = runner(lambda: {"x": 0}, train_steps, save, restore,
                           total_steps=20, checkpoint_every=5)
    return state, vars(report), log


def test_recovery_equals_the_reference():
    from repro.runtime import FailureInjector as JInjector
    want = _recovery_case(jrun, JInjector)
    got = _recovery_case(run_with_recovery, FailureInjector)
    assert got == want
    assert got[1]["restarts"] == 2 and got[1]["recovered_from"] == [5, 10]

    class AlwaysFail(FailureInjector):
        def check(self, step):
            raise SimulatedFailure(step)

    with pytest.raises(SimulatedFailure):
        run_with_recovery(lambda: {}, lambda s, a, b: AlwaysFail().check(a),
                          lambda s, st: None, lambda: None, total_steps=10,
                          checkpoint_every=2, max_restarts=3)


@pytest.mark.parametrize("args", [(512, 16, 256), (256, 16, 256),
                                  (128, 16, None), (64, 8, None)])
def test_elastic_helpers_equal_the_reference(args):
    assert elastic_mesh_shape(*args) == jmesh(*args)
    for gb, dp in ((256, 16), (256, 8), (100, 8)):
        assert rebalanced_batch(gb, dp) == jrebal(gb, dp)
        assert accumulation_steps(gb, dp, 8) == jacc(gb, dp, 8)
    with pytest.raises(ValueError):
        elastic_mesh_shape(100, 16)


CLI = ["--device", "cpu", "--reduced", "--steps", "20", "--batch", "4",
       "--seq", "32", "--ckpt-every", "5"]


def test_cli_recovers_an_injected_failure(tmp_path, capsys):
    out = train.main(CLI + ["--ckpt-dir", str(tmp_path),
                            "--inject-failure-at", "12"])
    rep = out["report"]
    assert (rep.restarts, rep.failed_steps, rep.recovered_from,
            rep.completed_steps) == (1, [12], [10], 20)
    assert len(out["losses"]) == 22  # steps 10 and 11 replayed
    assert out["restored_devices"] == [["cpu"]]
    assert out["ckpt"].all_steps() == [15, 20]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("train: arch=smollm-135m-reduced opt=adamw "
                           "steps=20 loss ") and "restarts=1" in line


def test_cli_trains_packed_and_with_adamw8(tmp_path, capsys):
    out = train.main(CLI + ["--ckpt-dir", str(tmp_path), "--pack",
                            "--optimizer", "adamw8", "--steps", "6"])
    assert out["opt"] == "adamw8" and len(out["losses"]) == 6
    assert all(np.isfinite(out["losses"]))
    assert out["state"]["opt"]["m"]["embed"]["tok"]["q"].dtype == torch.int8


def test_cli_refuses_a_long_contiguous_sequence_on_the_card():
    """Past 1,024 contiguous positions the forward reaches the
    flash_attention kernel, which has no backward: refused before any
    card is touched (so this runs on a host without one)."""
    with pytest.raises(ValueError, match="flash_attention.*no backward"):
        train.main(["--reduced", "--seq", "2048", "--steps", "1"])

"""The port's GMI collectives and GPipe stage pipeline against the JAX
package's.

The JAX side runs once, in a subprocess with 8 host devices (the flag
must be set before JAX starts, as tests/test_gmi.py does), under
`shard_map` on an 8-member mesh and on a (2, 4) pod x data mesh; it saves
every result to an .npz in tmp_path.  The port runs the same collectives
on a single-controller mesh of CPU shards, from the same numpy inputs.
On integer-valued f32 inputs the two must be equal bit for bit (sums of
small integers are exact in any order); on normal draws within f32 1e-6.
Member f's input is rows [f*r, (f+1)*r) of one global array, and member
outputs are compared concatenated on dim 0, as shard_map's out_specs
join them.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import gmi
from repro_torch.core.pipeline import (gpipe_forward_perm, pipeline_steps,
                                       pipelined_apply)
from repro_torch.launch.mesh import make_mesh

R, C = 4, 3  # rows and columns of one member's block


def _inputs():
    rng = np.random.default_rng(0)
    ints = rng.integers(-8, 9, (8 * 4 * R, C)).astype(np.float32)
    normal = rng.normal(0, 1, (8 * 4 * R, C)).astype(np.float32)
    return ints, normal


# (name, mesh, axis args, kwargs): axis args are the collective's axis
# parameters after x; "x4" ops take a (4*R, C) block per member
OPS = {
    "flat8": [
        ("broadcast", ("data",), {"root": 2}),
        ("reduce", ("data",), {"root": 1}),
        ("gather", ("data",), {"root": 3}),
        ("allgather_composed", ("data",), {}),
        ("allreduce_composed", ("data",), {}),
        ("allgather", ("data",), {}),
        ("allreduce", ("data",), {}),
        ("reduce_scatter", ("data",), {}),
        ("cluster_send", ("data",), {}),
        ("cluster_send", ("data",), {"dst_offset": 3}),
    ],
    "2x4": [
        ("broadcast", ("data",), {"root": 2}),
        ("broadcast", (("pod", "data"),), {"root": 5}),
        ("reduce", ("data",), {"root": 1}),
        ("reduce", ("pod",), {"root": 1}),
        ("gather", ("data",), {}),
        ("scatter", ("data",), {"root": 0}),
        ("scatter", ("data",), {"root": 2}),
        ("allgather_composed", ("data",), {}),
        ("allreduce_composed", ("data",), {}),
        ("allgather", (("pod", "data"),), {}),
        ("allreduce", ("pod",), {}),
        ("allreduce", (("pod", "data"),), {}),
        ("reduce_scatter", ("data",), {}),
        ("hier_allreduce", ("data", "pod"), {}),
        ("flat_allreduce", ("data", "pod"), {}),
        ("hier_allgather", ("data", "pod"), {}),
        ("cluster_send", ("pod",), {}),
    ],
}
MESHES = {"flat8": ((8,), ("data",)), "2x4": ((2, 4), ("pod", "data"))}
CASES = [(m, i) for m in OPS for i in range(len(OPS[m]))]
PIPE = [(4, 4), (6, 4), (2, 4), (3, 1)]  # (n_micro, n_stages)


def _key(mesh, i, kind):
    return f"{mesh}-{i}-{kind}"


JAX_SCRIPT = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import gmi
from repro.core.pipeline import pipelined_apply, shard_map_compat
from repro.launch.mesh import make_mesh

assert jax.device_count() == 8
ops = json.loads(sys.argv[2])
meshes = json.loads(sys.argv[3])
pipe = json.loads(sys.argv[4])
d = dict(np.load(sys.argv[1] + ".in.npz"))
out = {}
for mname, cases in ops.items():
    shape, axes = meshes[mname]
    mesh = make_mesh(tuple(shape), tuple(axes))
    spec = P(tuple(axes)) if len(axes) > 1 else P(axes[0])
    for i, (name, ax, kw) in enumerate(cases):
        ax = [tuple(a) if isinstance(a, list) else a for a in ax]
        for kind in ("ints", "normal"):
            x = jnp.asarray(d[kind])
            rows = x.shape[0] // 8
            if name == "scatter":  # each member's block: (n, r, c)
                x = x.reshape(8 * 4, rows // 4, x.shape[1])
            elif name != "reduce_scatter":
                x = x[: 8 * (rows // 4)]
            fn = getattr(gmi, name)
            f = shard_map_compat(lambda v: fn(v, *ax, **kw), mesh,
                                 in_specs=(spec,), out_specs=spec)
            out[f"{mname}-{i}-{kind}"] = np.asarray(f(x))
smesh = make_mesh((4,), ("stage",))
for n_micro, n_stages in pipe:
    rng = np.random.default_rng(n_micro * 10 + n_stages)
    mesh = make_mesh((n_stages,), ("stage",))
    w = jnp.asarray(rng.integers(-2, 3, (n_stages, 5, 5)).astype(np.float32))
    b = jnp.asarray(rng.integers(-2, 3, (n_stages, 1, 5)).astype(np.float32))
    x = jnp.asarray(rng.integers(-2, 3, (n_micro, 3, 5)).astype(np.float32))
    out[f"pipe-int-{n_micro}-{n_stages}"] = np.asarray(pipelined_apply(
        lambda p, v: v @ p[0] + p[1], mesh, "stage", (w, b), x))
    xf = jnp.asarray(rng.normal(0, 1, (n_micro, 3, 5)).astype(np.float32))
    wf = jnp.asarray(rng.normal(0, 0.5, (n_stages, 5, 5)).astype(np.float32))
    out[f"pipe-tanh-{n_micro}-{n_stages}"] = np.asarray(pipelined_apply(
        lambda p, v: jnp.tanh(v @ p), mesh, "stage", wf, xf))
np.savez(sys.argv[1] + ".out.npz", **out)
print("JAX-OK")
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    import json
    base = str(tmp_path_factory.mktemp("gmi") / "gmi")
    ints, normal = _inputs()
    np.savez(base + ".in.npz", ints=ints, normal=normal)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    ops = {m: [[n, [list(a) if isinstance(a, tuple) else a for a in ax], kw]
               for n, ax, kw in cases] for m, cases in OPS.items()}
    res = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), base,
         json.dumps(ops), json.dumps(MESHES), json.dumps(PIPE)],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    return dict(np.load(base + ".out.npz"))


def _port(mname, name, ax, kw, x):
    shape, axes = MESHES[mname]
    mesh = make_mesh(shape, axes, device="cpu")
    rows = x.shape[0] // 8
    if name == "scatter":
        x = x.reshape(8 * 4, rows // 4, x.shape[1])
    elif name != "reduce_scatter":
        x = x[: 8 * (rows // 4)]
    xs = list(torch.from_numpy(np.ascontiguousarray(x)).chunk(8))
    out = getattr(gmi, name)(xs, mesh, *ax, **kw)
    assert len(out) == 8
    return torch.cat(out, 0).numpy()


@pytest.mark.parametrize("mname,i", CASES)
def test_collective_matches_jax(jax_out, mname, i):
    name, ax, kw = OPS[mname][i]
    ints, normal = _inputs()
    got = _port(mname, name, ax, kw, ints)
    want = jax_out[_key(mname, i, "ints")]
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    got = _port(mname, name, ax, kw, normal)
    want = jax_out[_key(mname, i, "normal")]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_micro,n_stages", PIPE)
def test_pipelined_apply_matches_jax(jax_out, n_micro, n_stages):
    rng = np.random.default_rng(n_micro * 10 + n_stages)
    mesh = make_mesh((n_stages,), ("stage",), device="cpu")
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    w = t(rng.integers(-2, 3, (n_stages, 5, 5)))
    b = t(rng.integers(-2, 3, (n_stages, 1, 5)))
    x = t(rng.integers(-2, 3, (n_micro, 3, 5)))
    got = pipelined_apply(lambda p, v: v @ p[0] + p[1], mesh, "stage",
                          (w, b), x)
    np.testing.assert_array_equal(
        got.numpy(), jax_out[f"pipe-int-{n_micro}-{n_stages}"])
    xf = t(rng.normal(0, 1, (n_micro, 3, 5)))
    wf = t(rng.normal(0, 0.5, (n_stages, 5, 5)))
    got = pipelined_apply(lambda p, v: torch.tanh(v @ p), mesh, "stage",
                          wf, xf)
    np.testing.assert_allclose(
        got.numpy(), jax_out[f"pipe-tanh-{n_micro}-{n_stages}"],
        rtol=1e-6, atol=1e-6)


def test_schedule_arithmetic():
    assert pipeline_steps(6, 6) == 11 and pipeline_steps(1, 4) == 4
    assert gpipe_forward_perm(4) == [(0, 1), (1, 2), (2, 3), (3, 0)]


def test_sums_run_in_shard_order():
    """A sum adds the group's members in axis order: 1e8 + 1 - 1e8 in
    f32 gives 0, not 1, whichever member holds the result."""
    mesh = make_mesh((3,), ("model",), device="cpu")
    xs = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])]
    for r in gmi.allreduce(xs, mesh, "model"):
        assert float(r) == 0.0
    assert float(gmi.reduce(xs, mesh, "model", root=2)[2]) == 0.0

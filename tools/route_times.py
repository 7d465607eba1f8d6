"""The single-device serve routes of a tree's `chip_smoke.py`, alone.

Runs the tree's own phases, with their checks: the paged smollm-135m
Poisson stream (serve), its profiled window (profile: busy share, device
ops and wall ms a step), the attention-only families (tok/s) and the MoE
phase (moonshot-v1-16b-a3b and llama4-maverick's period: tok/s, busy
share, expert reads); with `--gemm`, the gemm kernel's shapes first
(trees that have it); with `--host`, the host time of one launch of the
decode step's products and norms (wrapper against the library call, at
smollm-135m's shapes, 2,000 back to back: the host, not the card, bounds
them); with `--quick`, the serve phase alone; with `--row-norm`, the
tree's row-norm kernel phase alone (every width and row count, checked,
bf16 timed beside the plain version and F.rms_norm / F.layer_norm); with
`--xlstm`, xlstm-1.3b alone (its profiled 8 fused decode steps: wall ms,
busy share, device ops; and the tree's mLSTM head probe where it has
one).  Two trees compared in one call, on one card:

    python tools/route_times.py _parent && python tools/route_times.py . \
        && python tools/route_times.py . && python tools/route_times.py _parent

ROOT (the repo by default) holds chip_smoke.py and src/; its package is
imported and its kernels built.  Each line is prefixed by chip_smoke's
log; the last names the tree.  Needs a card.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time


def host_us(fn, n: int = 2000) -> float:
    """Wall microseconds a call of fn, n calls back to back, then one
    synchronization (the card's work a call is a few microseconds)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def host_phase(cs) -> None:
    """Host microseconds a launch: the port's wrappers (`layers.product`
    when the tree has it, else `layers.dense`; `ops.row_norm`) beside
    torch.matmul and F.rms_norm, at smollm-135m's decode shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models import layers

    dev = torch.device("cuda")
    with torch.no_grad():
        x = torch.randn(8, 1, 576, device=dev).bfloat16()
        w = (torch.randn(576, 192, device=dev) * 0.04).bfloat16()
        g = torch.ones(576, device=dev)
        gb = g.bfloat16()
        prod = getattr(layers, "product", layers.dense)
        rows = {"product 8x576x192": host_us(lambda: prod(x, w)),
                "torch.matmul 8x576x192": host_us(
                    lambda: torch.matmul(x, w)),
                "row_norm 8x576": host_us(lambda: ops.row_norm(x, g)),
                "F.rms_norm 8x576": host_us(
                    lambda: F.rms_norm(x, (576,), gb, 1e-6))}
    cs.log("route_times host_us_per_call: " + " ".join(
        f"{k}={v:.2f}" for k, v in rows.items()))


def xlstm_phase(cs, dev) -> None:
    """xlstm-1.3b at full depth on init_params weights (seed 0): the
    tree's 8 fused decode steps on dense slot rows under the profiler,
    then its mLSTM head probe where the tree has one."""
    cfg = cs.get_config("xlstm-1.3b")
    model = cs.make_model(cfg, device=dev)
    params = cs.init_params(cfg, seed=0, device=dev)
    cs._recurrent_profile(model, params)
    if hasattr(cs, "mlstm_head_probe"):
        cs.mlstm_head_probe(dev)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = os.path.abspath(args[0] if args else os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("route_times: no CUDA device is available")
    cs.log(f"route_times: tree {root}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    t0 = time.perf_counter()
    cs.build.build_all()
    cs.log(f"route_times: build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    if "--gemm" in sys.argv and hasattr(cs, "gemm_phase"):
        flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
        cs.timed("gemm", lambda: cs.gemm_phase(dev, flush))
        del flush
    if "--host" in sys.argv:
        host_phase(cs)
    if "--xlstm" in sys.argv:
        cs.timed("xlstm", lambda: xlstm_phase(cs, dev))
        cs.log(f"route_times: tree {root} done")
        return
    if "--row-norm" in sys.argv:
        flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
        cs.timed("row_norm", lambda: cs.row_norm_phase(dev, flush))
        cs.log(f"route_times: tree {root} done")
        return
    cs.timed("serve", lambda: cs.serve_phase("poisson", 16))
    if "--quick" in sys.argv:
        cs.log(f"route_times: tree {root} done")
        return
    cs.timed("profile", lambda: cs.profile_phase(dev))
    cs.timed("families", lambda: cs.families_phase(dev))
    cs.timed("moe", lambda: cs.moe_phase(dev))
    cs.log(f"route_times: tree {root} done")


if __name__ == "__main__":
    main()

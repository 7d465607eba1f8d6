#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports neither JAX nor
the JAX package.  Phases, in order — any fault exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from the sources in the checkout,
   one nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (and a long-context one), with the error, the
   kernel's time, the plain version's time, a library yardstick's time
   and the least time the card could take (bytes over HBM rate);
4. serve: smollm-135m at full width (random weights from a seed) serves a
   Poisson stream and a shared-prefix stream through the port's
   ContinuousBatchingEngine; every request must finish its budget, the
   shared prefix must hit the radix cache, and the decode kernel must
   have launched once per layer per fused decode step; then one more
   stream under torch.profiler says where the serve path's time goes;
5. model: the same weights run prefill and 8 decode steps on the card and
   on the CPU (plain versions); logits must agree within a stated bound;
6. summary: a JSON line of the kernels, then the device line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.transformer import init_params, make_model  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402

SENTINEL = 2 ** 30
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense): HBM
# bytes/s and f32 flop/s outside the tensor cores
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
KERNEL_TOL = 1e-2  # bf16 outputs in (-1, 1): ~2 ulps of summation order
LOGIT_TOL = 0.1    # 30 bf16 layers, CPU vs card summation order


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, flush: torch.Tensor, iters: int = 30) -> float:
    """Mean device time of fn() with a cold L2: each launch follows a
    write of `flush` (larger than the 50 MB L2), which also keeps the
    device busy while the host enqueues fn, so host overhead is not
    counted."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def paged_inputs(seed: int, b: int, kvh: int, g: int, hd: int, ps: int,
                 maxp: int, dev):
    """Decode inputs in the serving engine's invariants: lanes 1-3 share
    lane 0's full prefix pages, pages past a lane's length name the
    trash page 0, the row after qpos in a lane's last page is never
    written (sentinel) and later rows are stale (kpos > qpos), lanes 5
    and 7 are inactive."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    qpos = rng.integers(maxp * ps // 2, maxp * ps - 2, b).astype(np.int32)
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    shared = min(int(qpos.min()) // ps, maxp // 2)
    nxt = 1
    for lane in range(b):
        for j in range(int(qpos[lane]) // ps + 1):
            if 0 < lane < 4 and j < shared:
                pt[lane, j] = pt[0, j]
                continue
            pt[lane, j] = nxt
            kpos[nxt] = j * ps + np.arange(ps)
            nxt += 1
        last, off = pt[lane, qpos[lane] // ps], int(qpos[lane]) % ps
        if off + 1 < ps:
            kpos[last, off + 1] = SENTINEL
    active = np.ones((b,), bool)
    active[[5, 7]] = False
    bf = torch.bfloat16
    t = {
        "q": torch.tensor(rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5),
        "k": torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd))),
        "v": torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd))),
    }
    t = {n: x.to(bf).to(dev) for n, x in t.items()}
    t.update(kpos=torch.tensor(kpos, device=dev),
             page_table=torch.tensor(pt, device=dev),
             qpos=torch.tensor(qpos, device=dev),
             active=torch.tensor(active, device=dev))
    return t


def kernel_phase(dev, flush, bw: float, flops: float, maxp: int) -> dict:
    b, kvh, g, hd, ps = 8, 3, 3, 64, 16
    t = paged_inputs(maxp, b, kvh, g, hd, ps, maxp, dev)
    args = (t["q"], t["k"], t["v"], t["kpos"], t["page_table"], t["qpos"])
    out = ops.paged_flash_decode(*args, active=t["active"])
    want = ref.paged_flash_decode(*args, active=t["active"])
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    off = ~t["active"]
    require(bool(torch.isfinite(out).all()), "kernel output not finite")
    require(bool((out[off] == 0).all()), "inactive lanes must be exact zeros")
    require(err <= KERNEL_TOL, f"kernel vs plain: {err} > {KERNEL_TOL}")
    ms = time_ms(lambda: ops.paged_flash_decode(*args, active=t["active"]),
                 flush)
    plain_ms = time_ms(lambda: ref.paged_flash_decode(
        *args, active=t["active"]), flush)
    # yardstick only (the port never calls it): SDPA over the cache
    # gathered beforehand, kv heads expanded to the query heads
    pt = t["page_table"].long()
    kg, vg = (x[pt].reshape(b, maxp * ps, kvh, hd).transpose(1, 2)
              .repeat_interleave(g, dim=1).contiguous()
              for x in (t["k"], t["v"]))
    mask = ((t["kpos"][pt].reshape(b, 1, 1, -1) <= t["qpos"].view(b, 1, 1, 1))
            & t["active"].view(b, 1, 1, 1))
    q4 = t["q"].view(b, kvh * g, 1, hd)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask, scale=1.0), flush)
    # least bytes: the pages the tables name (each once), kpos of those
    # pages, q, out, the table, qpos, active
    pages = torch.unique(t["page_table"]).numel()
    nbytes = (pages * ps * kvh * hd * 2 * 2 + pages * ps * 4
              + 2 * t["q"].numel() * 2 + t["page_table"].numel() * 4
              + b * 4 + b)
    nflop = 4 * b * maxp * ps * kvh * g * hd
    bound_ms = max(nbytes / bw, nflop / flops) * 1e3
    # what the kernel reads as written: every table entry's page, per lane
    walked = b * maxp * ps * kvh * hd * 2 * 2 + b * maxp * ps * 4
    log(f"kernel paged_flash_decode B={b} KVH={kvh} G={g} hd={hd} ps={ps} "
        f"MAXP={maxp}: max_abs_err={err:.3g} (tol {KERNEL_TOL}) "
        f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
        f"bound_ms={bound_ms:.6f} ({nbytes} bytes, {pages} pages) "
        f"walked_bytes={walked} ({walked / bw * 1e3:.6f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if nbytes / bw >=
                nflop / flops else "operations", library_ms=library_ms)


def serve_phase(stream: str, n: int) -> dict:
    args = serve_cli.parse_args([
        "--arch", "smollm-135m", "--requests", str(n), "--max-batch", "8",
        "--max-new", "32", "--stream", stream, "--warmup", "--seed", "0"])
    ops.reset_launches()
    engine, done, wall = serve_cli.serve(args)
    launches = ops.launches["paged_flash_decode"]
    steps = engine.stats["decode_steps"]  # warm-up pass included
    n_layers = engine.model.cfg.n_layers
    require(len(done) == n, f"{len(done)} of {n} requests finished")
    for r in done:
        require(r.done and (len(r.tokens_out) == r.max_new_tokens
                            or r.tokens_out[-1] == r.eos_id),
                f"request {r.rid} stopped short of its budget")
    require(launches == n_layers * steps,
            f"{launches} kernel launches != {n_layers} x {steps} steps")
    toks = sum(len(r.tokens_out) for r in done)
    ttft = sorted((r.t_first_token - r.t_enqueue) * 1e3 for r in done)
    s = engine.stats
    log(f"serve {stream}: requests={n} tokens={toks} wall_s={wall:.4f} "
        f"tok_s={toks / wall:.1f} ttft_p50_ms={ttft[len(ttft) // 2]:.2f} "
        f"decode_steps={steps} kernel_launches={launches} "
        f"(= {n_layers} x {steps}) prefix_hits={s['prefix_hits']} "
        f"pages_peak={s['pages_peak']} preemptions={s['preemptions']}")
    if stream == "shared-prefix":
        require(s["prefix_hits"] > 0, f"no prefix hit: {s}")
    return dict(launches=launches, prefix_hits=s["prefix_hits"])


def profile_phase(dev) -> None:
    """Where the serve path's time goes: one Poisson stream served under
    torch.profiler.  Prints the device's busy share of the window (union
    of kernel and copy intervals over the host clock), the decode
    kernel's share of device time, and launches per decode step.  The
    profiler's own host cost lowers the busy share somewhat."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = serve_cli.parse_args(["--requests", "16", "--max-batch", "8",
                                 "--max-new", "32", "--seed", "3"])
    cfg = get_config(args.arch)
    engine = ContinuousBatchingEngine(
        make_model(cfg, device=dev), init_params(cfg, seed=0, device=dev),
        max_batch=args.max_batch, buckets=serve_cli.BUCKETS)
    for r in serve_cli.make_stream(args, cfg.vocab_size, args.seed):
        engine.submit(r)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy, end, kern, n_kern = 0.0, -1.0, 0.0, 0
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        if "paged_flash_decode" in name:
            kern += e - s
            n_kern += 1
    dev_total = sum(e - s for s, e, _ in spans)
    steps = engine.stats["decode_steps"]
    log(f"profile poisson x16 (B=8, max_new 32): wall_ms={wall_us / 1e3:.2f}"
        f" device_busy_share={busy / wall_us:.4f} device_kernel_ms="
        f"{dev_total / 1e3:.2f} paged_flash_decode_share_of_device="
        f"{kern / max(dev_total, 1e-9):.4f} ({n_kern} launches) "
        f"device_ops_per_decode_step={len(spans) / max(steps, 1):.1f} "
        f"decode_steps={steps} wall_ms_per_decode_step="
        f"{wall_us / 1e3 / max(steps, 1):.3f}")


def model_phase() -> None:
    """Same weights on card and CPU: prefill two prompts, then 8 decode
    steps fed the same tokens on both; then 8 fused greedy steps."""
    cfg = get_config("smollm-135m")
    ps, maxp, steps = 16, 6, 8
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 37)]
    gpu_params = init_params(cfg, seed=0, device="cuda")
    runs = {}
    for name in ("cpu", "cuda"):
        params = gpu_params if name == "cuda" else {
            k: _to(v, "cpu") for k, v in gpu_params.items()}
        model = make_model(cfg, device=name)
        with torch.no_grad():
            runs[name] = _model_run(model, params, prompts, ps, maxp, steps,
                                    runs.get("cpu"))
    cpu, gpu = runs["cpu"], runs["cuda"]
    errs = [(g - c).abs().max().item() for c, g in zip(cpu["logits"],
                                                       gpu["logits"])]
    scale = max(c.abs().max().item() for c in cpu["logits"])
    match = (cpu["block"] == gpu["block"]).float().mean().item()
    log(f"model smollm-135m prefill+{steps} decode steps, card vs CPU: "
        f"max_abs_logit_err={max(errs):.4g} (tol {LOGIT_TOL}, "
        f"|logit| max {scale:.3g}) per step={['%.3g' % e for e in errs]} "
        f"fused {steps}-step token match={match:.3f}")
    require(max(errs) <= LOGIT_TOL, f"card vs CPU logits: {errs}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _model_run(model, params, prompts, ps, maxp, steps, teacher):
    """Prefill each prompt into its lane of a paged cache, then decode.
    The per-step input tokens come from `teacher` (the CPU run) when
    given, so both devices see the same inputs."""
    dev = model.device
    b = len(prompts)

    def admitted():
        big = model.init_paged_cache(b, 1 + b * maxp, ps, maxp)
        logits = []
        for i, p in enumerate(prompts):
            bucket = -(-len(p) // ps) * ps
            toks = np.zeros((1, bucket), np.int32)
            pos = np.full((1, bucket), SENTINEL, np.int32)
            toks[0, :len(p)], pos[0, :len(p)] = p, np.arange(len(p))
            lg, small = model.prefill(
                params, model.init_cache(1, bucket),
                torch.tensor(toks, device=dev),
                positions=torch.tensor(pos, device=dev),
                last_idx=torch.tensor([len(p) - 1], device=dev))
            pages = np.arange(1 + i * maxp, 1 + (i + 1) * maxp,
                              dtype=np.int32)
            model.admit_lane_cache(big, i, pages, len(p), pages, small=small,
                                   write_pages=pages[:bucket // ps])
            logits.append(lg[0])
        return big, torch.stack(logits)

    big, lg = admitted()
    out = {"logits": [lg.float().cpu()], "tokens": []}
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    for s in range(steps):
        tok = (teacher["tokens"][s] if teacher is not None
               else out["logits"][-1].argmax(-1).to(torch.int32))
        out["tokens"].append(tok)
        lg, big = model.decode_step(params, big, tok.to(dev), active=active)
        out["logits"].append(lg.float().cpu())
    big, lg = admitted()
    block, *_ = model.decode_steps(params, big,
                                   lg.argmax(-1).to(torch.int32), active,
                                   steps)
    out["block"] = block.cpu()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    name = torch.cuda.get_device_name(0)
    bw, flops = HBM_BYTES_S, F32_FLOP_S
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{name}; bound uses H100 SXM peaks: {bw:.3g} B/s, {flops:.3g} "
        "flop/s (f32)")

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f}"
        " s")
    for src, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
    main_shape = kernel_phase(dev, flush, bw, flops, maxp=12)
    kernel_phase(dev, flush, bw, flops, maxp=128)
    del flush
    torch.cuda.empty_cache()

    served = [serve_phase("poisson", 16), serve_phase("shared-prefix", 8)]
    profile_phase(dev)
    model_phase()

    entry = dict(name="paged_flash_decode", route="cuda",
                 source="src/repro_torch/kernels/csrc/paged_flash_decode.cu",
                 replaces="src/repro/kernels/flash_decode.py:250",
                 launches=sum(s["launches"] for s in served), **main_shape)
    log(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

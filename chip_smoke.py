#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); imports neither JAX nor
the JAX package.  Phases, in order — any fault exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the port, from the sources in the checkout,
   one nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (and long-context ones for the decode kernels,
   also at phi3-medium-14b's heads; int8_matmul with B column-major, the
   encoder's layout, and its row-major path, one transposing copy, held
   equal to it; flash_attention at smollm-135m's and phi3-medium-14b's
   heads, S=4096,
   timed in bf16 and checked once more in f32, at a ragged non-causal
   f32 shape, and in bf16 at smollm's heads at S = 1100, 2048 and 8192),
   with the error, the kernel's time, the plain version's time, a library
   yardstick's time where one PyTorch call computes the same function, and
   the least time the card could take (bytes over the HBM rate, or
   operations over the peak rate of their type, whichever is larger); the
   three decode kernels agree within DECODE_ATOL + 2^-7 |want| + 2^-8 W
   (W: the plain version over |v|) and give exact zeros on
   inactive lanes, and the four I-BERT integer kernels must equal their
   plain versions bit for bit; each I-BERT kernel is also timed beside a
   copy of the same bytes (copy_ms), i_softmax at (1536, 128) and at
   ibert-base's max_seq_len, (6144, 512); kernels 1 and 2 also at the
   speculative verify pass's shape (8 lanes x 5 queries folded into 40),
   kernel 1 also at the MoE models' heads (KVH 16, G 1 and KVH 8, G 5,
   hd 128) and at their serve plans' shard heads (KVH 8 and 4, G 1;
   KVH 1, G 5); torch.bmm over a shard's block of E / n experts equal to
   the E-expert call bit for bit at moonshot's and llama4's expert
   shapes (`expert_bmm_probe`, the MoE serve plans' premise);
   the port-only row norm (rmsnorm, layernorm) at every served width
   (ROW_NORM_DS) and at 1, 8, 40 and 4096 rows, within ROW_NORM_TOL, in
   bf16 beside F.rms_norm / F.layer_norm, equal bit for bit to its order
   of sums repeated in torch (`ref.row_norm_schedule`), and row-count
   invariant: a row's output is the same bits at every row count (the
   row_norm step logs its seconds); the port-only gemm
   (every served `layers.dense` product and the head, f32 sums in an
   order fixed by K) at the served product shapes, within 2^-8 |want| + 1e-5
   |x||w| of its plain version, timed beside it and torch.matmul (and
   checked, untimed, at the MoE serve plans' shard columns), and a
   column block of w or a row block of x equal to the whole product bit
   for bit (where torch.matmul parts);
4. long forward: smollm-135m at full width (30 layers, random weights
   from seed 0) through `Model.forward_logits` at B=2, S=4096, `loss` on
   the same tokens and `prefill` without positions at S=1536 into 1,600
   dense slots followed by 8 fused decode steps: each forward and the
   prefill must launch flash_attention once per layer and no decode
   kernel, each decode step flash_decode once per layer and
   flash_attention never; the forward and (warm) the 8 decode steps
   once more under torch.profiler;
   then card vs CPU (plain versions) at B=1, S=2048, logits within
   LOGIT_TOL and loss within LOSS_TOL.  Each profiled forward must show
   one flash_attention kernel span per layer.  Then phi3-medium-14b at full
   width (40 layers, seed 0): one forward_logits at B=1, S=4096, 40
   flash_attention launches, finite logits;
5. serve: smollm-135m at full width (random weights from a seed) through
   the serve entry point: a Poisson and a shared-prefix stream on the
   paged bf16 arena, then a Poisson stream each through the wave engine,
   the continuous-batching engine on dense slot rows and on an int8 page
   arena; every request must finish its budget, the shared prefix must
   hit the radix cache, and the route's decode kernel (paged_flash_decode,
   flash_decode, paged_flash_decode_q) must have launched once per layer
   per fused decode step and the other two never, and the row norm 2 per
   layer and 1 per backbone call; serving never
   launches flash_attention; then one more paged bf16 stream under
   torch.profiler says where the main route's time goes (the decode
   kernel's and the row norm's shares of device time);
6. model: the same weights run prefill and 8 decode steps on the card and
   on the CPU (plain versions), on a bf16 page arena; logits must agree
   within a stated bound; where 8 fused greedy steps part, the CPU's
   top-2 logit gap is logged beside the card's logit error at that step;
   on dense slot rows and an int8 page arena the card half alone
   (finite logits; kv_quantize of the card's K/V rows equal to the
   CPU's bit for bit), their CPU halves cut for chip time;
7. fit: `models.synthetic.fit_affine_lm` on the card at its defaults
   (1,000 Adam steps) for reduced smollm-135m (the gate's instrument:
   the full-width fit does not reach the accuracy a gate needs, PERF.md),
   then DRAFT_FIT_STEPS for a 1-layer draft on the clean corpus and one
   with disagree_every=3; each logs its held-out loss and greedy
   accuracy;
8. gate: the fitted target's greedy streams on the card against the
   CPU's (8 affine prompts, 16 fused steps) on a bf16 page arena, dense
   slot rows and an int8 arena: the token match must be exactly 1.0;
9. spec: greedy speculative decoding through the paged cb engine (B=8,
   spec_k 4, a tight page pool so lanes starve, are preempted and catch
   their drafts up): the fitted target with each fitted draft, on bf16
   and int8 arenas, 16 affine requests then 8 sharing a prefix; every
   stream must equal the plain engine's on the same requests; the route
   kernel's launches split into verify passes (B * (k+1) folded lanes,
   one per target layer per spec dispatch) and single-query steps; then
   smollm-135m at full width on random weights drafting for itself; the
   verify block must equal its chained decode steps bit for bit, on the
   reduced target and at full width;
10. families: minitron-8b, musicgen-medium, internvl2-1b and
   deepseek-coder-33b at full width on random weights: card vs CPU on 2
   layers (as phase 6, paged), 8 requests of 32 tokens served through the
   paged cb engine at full depth (deepseek-coder-33b cut to 8 of its 62
   layers), exact paged_flash_decode and row_norm launch counts, and the
   verify block equal to its chained decode steps bit for bit (each
   product runs once over the B*T rows on the K-ordered gemm kernel);
   its reduced musicgen-medium and minitron-8b are fitted and gated in
   the fitted phase (15); the fit worker (FITTED_GATES) starts here;
11. recurrent: recurrentgemma-2b (RG-LRU blocks, sliding-window MQA
   attention at hd 256 / G 10, W8A8 tail MLPs) and xlstm-1.3b (mLSTM and
   sLSTM blocks) at full width on random weights: card vs CPU on one
   period of layers (dense slot rows; xlstm gated on 2 layers, an mLSTM
   then an sLSTM), 8 requests of 32 tokens served
   through the dense-slot cb engine at full depth (recurrentgemma with
   bf16 and with W8A8 weights), exact flash_decode, int8_matmul and
   row_norm launch counts, 8 fused decode steps under torch.profiler
   (their reduced fits gated in the fitted phase); then xlstm-1.3b x48
   on 6 drained serve_pipeline stages, B 12 (`family_pipeline`: tokens
   and last-step logits equal to Model.decode_steps, d = 0, ticks
   8 x pipeline_steps(6, 6), row_norm and gemm launches one device's
   scaled per microbatch; recurrentgemma-2b's 2-layer tail takes no
   stage); then each under mode="serve" plans on its first layers, views
   of the phase's weights (`_recurrent_plan_step`, 8 lanes, dense slots):
   xlstm x8 on (1, 2) and (1, 4), recurrentgemma x5 (a period and its
   2-layer tail) on (1, 2) with bf16 and with W8A8 weights (its tail
   MLPs: each shard's column blocks of wi and wg, wo whole or, under
   exact=False, by row), tokens and logits d = 0 against one device on
   the same admitted state, exact flash_decode, row_norm, gemm and
   int8_matmul launches a step, each W8A8 MLP on its shards' blocks
   equal to one device's bit for bit in both forms, and recurrentgemma
   with exact=False logged;
12. moe: moonshot-v1-16b-a3b (64 experts top-6, 2 shared) and
   llama4-maverick-400b-a17b (a dense layer, then 128 experts top-1 and
   1 shared) at full width on random weights (their card-vs-CPU halves
   are cut for chip time; the fitted phase gates both reduced models
   card vs CPU): moonshot served at all 48
   layers and llama4 at its period (depth cut from 48 to 2) through the
   paged cb engine, 8 requests of 32 tokens, exact paged_flash_decode
   and row_norm launch counts; one verify block against its chained
   decode steps, logged (the reference's MoE verify routes the block as
   one group at its own capacity and parts where it drops a pair), d = 0
   required on the rows with no drop; 8 fused decode steps profiled (the
   expert products' share of device time and their bytes against the
   bound) (their reduced fits gated in the fitted phase); then moonshot
   x12 (MOE_PIPELINE_LAYERS, views of the phase's weights, 2 layers a
   stage) on 6 serve_pipeline stages at B 12, drained on dense slot rows
   and request-skewed on a paged bf16 arena (lane groups of 2): tokens
   and last-step logits equal to Model.decode_steps (d = 0), ticks, and
   flash_decode / paged_flash_decode 12 x 6 launches a step
   (`family_pipeline`; llama4's one period takes no 6 stages); then each
   under a mode="serve" plan, every shard on the
   card running its block of the experts (MOE_PLAN: moonshot's first 12
   layers, views of the phase's tree, on (1, 2) and (1, 4), llama4's
   period on (1, 8), the narrowest mesh where its plan drops FSDP and so
   keeps its reductions whole): 8 admitted lanes, 8 fused decode steps and one
   more step's logits through the plan and through one device on the
   same state, tokens and logits d = 0, paged_flash_decode n x L,
   row_norm 2 L + 1 and gemm launches a step exact, both routes
   profiled one step, the placement's memory and the expert bytes a step
   logged; moonshot x12 on (1, 2) with exact=False, its token match and
   logits against the exact plan's logged;
13. plans: the multi-device serve plans on the single-controller mesh,
   every shard on the one card (shards share it, so this checks the
   program and its contract, not multi-card scaling): the GMI
   collectives and pipelined_apply on 8 CUDA shards equal the CPU's bit
   for bit; kernels 1-3 at the per-shard shapes (1 kv head of 3 query
   heads at hd 64, smollm-135m's on 3 shards; 2 of 4 at hd 128,
   minitron-8b's on 4); smollm-135m x30 through the paged cb engine
   under a mode="serve" plan on a (1, 3) mesh, bf16 and int8, a cold
   pass then one of radix hits on the sharded arena, every stream equal
   to the plan-free engine's, kernel 1 (2) 3 x 30 launches a decode
   step, each shard's arena one kv head, and the logits of a prefill and
   4 decode steps equal one device's bit for bit on paged, int8 and
   dense-slot caches; the two routes profiled (4 fused steps); the
   --no-exact psum form (logits and token match logged on random
   weights; the band, token match >= 0.98, required on a fitted reduced
   model with 3 kv heads); smollm-135m's 30 layers on a 6-stage
   serve_pipeline plan: the pipelined loop equal to Model.decode_steps,
   the engine's streams equal to the dense-slot engine's, 11 ticks and
   30 x 6 flash_decode launches a step, Eq. 1 from the stage time;
   speculation under (1, 3) (smollm-135m drafting for itself, spec_k 4,
   bf16 and int8: streams equal the plan's plain streams and one
   device's spec streams, counters equal, launches one device's plus the
   other shards' target passes); the wave engine under (1, 3) at the
   default buckets (one wave at bucket 256, prefilled in request blocks
   of 4: streams equal one device's, flash_decode 3 x 30 a step); the
   request-skewed serve_pipeline (--no-exact) on 6 stages at B = 12,
   lane groups of 2: the loop equal to Model.decode_steps (tokens, lane
   state, counters, arena), 4 x 6 + 5 ticks and 30 x 6 kernel-1 launches
   a step, one step profiled beside one device's, the engine's streams
   equal the plain paged engine's on bf16 (cold then hits) and int8
   (cold), each stage's arena block 5 periods, a page's bytes 1/6;
   kernels 1 and 2 at
   a 2-lane group; minitron-8b at full width, 8 of its 32 layers, on
   (1, 4): streams and logits equal one device's, and on 4 skewed
   stages at B = 8: streams equal one device's; the --dryrun CLI's
   markers; each step logs its seconds;
14. fleet: smollm-135m x30 at full width (seed 0) through the replica
   fleet and the disaggregated pools, every replica and pool on the one
   card (the program and its contract, not scaling): 16
   multi-prefix requests (4 prefixes of 64 tokens, budget 16, B = 4 a
   replica, FIFO admission) through the plain engine, a 1- and a
   2-replica affinity fleet (streams equal the plain engine's bit for
   bit), a 2-replica round-robin fleet (fewer prefix hits than
   affinity's), 2 replicas under 1x1 serve plans on the card listed
   twice (equal), and shed_depth=1 (some shed with a reason, the rest
   equal); then disagg=(1, 1) against colocated serving on 12 bursty
   requests (long prompts 180-240, buckets to 256, pages of 8), bf16
   and int8, cold then a replay: streams equal, every cold admission
   shipped once, the bytes gathered off the staging arena's leaves equal
   to its pages times the decode arena's own bytes a page (k, v, int8
   scales: kv_page_bytes(); and kpos), the replay all prefix hits and no
   ship, both ledgers drained, kernel 1 (2) launches equal colocated
   serving's; every pass 30 decode-kernel launches a decode step summed
   over the replicas, row_norm and gemm per call.  Admission is FIFO
   (deadline_s=0) so that every engine takes the same decode steps: the
   disaggregated split queues' shortest-first order does not run here
   (tests/test_torch_disagg_serving.py holds it on the CPU);
15. plansearch: the plan search (core/plan_search.py) for smollm-135m
   under the H100 table (roofline/analysis.py) at 1, 2 and 4 devices of
   the card's memory (torch's total_memory): candidates, frontier,
   choice and its predicted tok/s, TTFT and HBM share; the devices-2
   choice served through `serve.serve` with --plan auto --traffic (16
   Poisson requests, budget 32, FIFO admission): every request
   finishes, the engines carry the choice's replica count, page size
   and KV dtype, the streams equal one plain engine's (--plan none, the
   same pages and weights) token for token, and paged_flash_decode_q
   launches 30 a decode step summed over the replicas; then the
   reference's two-point calibration on one replica's executor (fused
   decode at n = 1 and 8, one batch-1 prefill at the largest bucket),
   t_step, t_dispatch, t_prefill, `predict_engine_tok_s` beside the
   measured tok/s and PREDICTION_BAND, logged with the card's name and
   power limit (no gate: all finite);
16. fitted: the reduced fits behind the card-vs-CPU stream gates of
   phases 10-12 (FITTED_GATES: musicgen-medium, minitron-8b, paged;
   recurrentgemma-2b, xlstm-1.3b, dense slot rows; moonshot-v1-16b-a3b,
   llama4-maverick-400b-a17b, paged), each fitted on the card with
   fit_affine_lm (Model.loss backward through its blocks) by a worker
   process (this script with --fit-worker) that runs beside phases
   10-15, then each gated card vs CPU at token match 1.0 (gate_phase);
17. train: smollm-135m at full width through the train CLI
   (`repro_torch.launch.train.main`, init_params seed 0, adamw, remat,
   B 8, S 512, 30 steps, checkpoints every 10, a failure injected at
   step 15): the loss falls (the last 10 steps' mean under the first
   10's), the recovery report is exactly the injection's (1 restart,
   step 15 failed, recovered from 10), the restored params on the card,
   every kept checkpoint's checksums verify, row_norm launched 4n + 1
   times a step (the forward's 2n + 1, the remat's recompute of every
   period's 2n) and no other kernel (every recorded product runs in
   torch.matmul); the final params saved and restored bit for bit,
   timed; 5 steps of adamw8, finite; one step's gradients with remat
   equal those without bit for bit; steps/s, tokens/s and peak memory
   logged; then the sharded step (`train.jit_train_step`) on a (2, 3)
   ("data", "model") train plan, its six shards on the card, against
   one device's `make_train_step`, 3 adamw steps from the same init at B
   8, S 512 with remat: the first loss within SHARDED_LOSS_TOL relative
   of one device's, the later losses within SHARDED_DRIFT_TOL (one
   device at n_micro 2 logged beside), every grad norm within
   SHARDED_NORM_TOL; the same 3 steps with a planted fault (data replica
   1's gradients dropped before the reduction) must fail the grad norm's
   gate, its gaps and the gates they fail logged;
   row_norm launched 2 (4n + 1) times a step (each data replica's
   forward and recompute) and no other kernel, each step's wall time and
   peak memory beside one device's; the sharded state (params, adamw
   moments) saved joined and restored onto (1, 3) and onto one device bit
   for bit, one step from each restore equal in loss to the (2, 3) plan's
   next step within SHARDED_LOSS_TOL; one step under
   hints(int8_gather=True) from the init, finite and within
   INT8_GATHER_TOL of the bf16 step's loss;
18. encode: the integer I-BERT encoder (ibert-base at full width, 12
   layers, random float weights from seed 0, calibrated at batch 1, seq
   128) through `repro_torch.launch.ibert_encoder`: one forward must
   launch exactly 72 / 12 / 24 / 12 int8_matmul / i_softmax / i_layernorm
   / i_gelu kernels, equal the CPU plain path bit for bit from the same
   int8 entry tensor, and track the float forward (one encoder within
   tests/test_ibert_model.py's bounds, 12 within the reference's own
   12-layer error on these weights); then one forward under
   torch.profiler, and the entry point's time at seq 1, 8, 32, 64, 128;
19. summary: a JSON line of the kernels (the decode kernels' launches
   include the gate's, the spec phase's, the families', the recurrent
   phase's, the moe phase's, the plans phase's, the fleet phase's, the
   plansearch phase's and the fitted phase's;
   row_norm's are the serve phases' and the families', recurrent, MoE,
   plans, fleet and plansearch models' served streams and the train
   phase's two CLI runs and sharded steps; gemm's the serve
   phases' and the plans, fleet and plansearch phases' streams and the
   recurrent and moe phases' pipelines; int8_matmul's the encoder's and
   recurrentgemma's W8A8
   stream), then the device line.

Each phase logs its wall seconds ("phase ...").
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.cluster_builder import build_plan  # noqa: E402
from repro_torch.core import ibert_ops, quant  # noqa: E402
from repro_torch.core.latency_model import (  # noqa: E402
    pipeline_ticks_per_step)
from repro_torch.core import plan_search  # noqa: E402
from repro_torch.core.packing import bucket_len  # noqa: E402
from repro_torch.core.quant import QTensor  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import ibert_encoder  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    TokenPipeline, shard_batch)
from repro_torch.models import shard_hints  # noqa: E402
from repro_torch.optim.optimizer import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import ibert as ib  # noqa: E402
from repro_torch.models import moe, synthetic  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from repro_torch.models.quantized import (  # noqa: E402
    column_major, is_quantized, quantize_leaf)
from repro_torch.models.transformer import (  # noqa: E402
    init_params, layer_plan, make_model, paged_cache_map)
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.serving import replica, router  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    ContinuousBatchingEngine, Request)
from repro_torch.serving.executor import Executor  # noqa: E402
from repro_torch.serving.stream import (  # noqa: E402
    bursty_requests, clone_requests, multi_prefix_requests)

SENTINEL = 2 ** 30
# published peaks of one H100 SXM at 700 W (roofline/analysis.py, NVIDIA's
# data sheet, dense): HBM bytes/s, f32 flop/s outside the tensor cores,
# int8 tensor-core ops/s, the bf16 tensor-core rate.  int32 ALU ops are
# bounded by the f32 rate (the card has no more int32 lanes than f32
# lanes), which keeps their bound a lower bound.
HBM_BYTES_S, F32_FLOP_S = analysis.HBM_BW, analysis.PEAK_FLOPS_F32
INT8_OPS_S, BF16_FLOP_S = analysis.PEAK_FLOPS_INT8, analysis.PEAK_FLOPS_BF16
# int32 operations per element of the I-BERT nonlinearities (the max and
# sum reductions included), for their operations bound
IBERT_OPS_PER_ELEM = {"i_softmax": 16, "i_layernorm": 10, "i_gelu": 12}
# one 12-layer ibert-base forward: launches per kernel
IBERT_LAUNCHES = {"int8_matmul": 72, "i_softmax": 12, "i_layernorm": 24,
                  "i_gelu": 12}
# the card's 12-layer integer-vs-float error may exceed the reference's
# (the CPU plain path on the same weights) by these fractions: the card
# calibrates from its own float forward, whose summation order moves the
# scales by ulps.  Three calibrations of seed 0's weights (JAX's, the
# port's on one CPU thread and on eight) gave max 3.59-3.80 (6% apart)
# and mean 0.7543-0.7566 (0.3% apart)
REF_ERR_MARGIN = {"max": 0.10, "mean": 0.02}
# the decode kernels vs their plain versions: |out - want| <= DECODE_ATOL
# + 2^-7 |want| + 2^-8 W, W = sum p |v| / l (the plain version over |v|).
# The bf16 kernels and the plain version round p to bf16 against
# different maxima (the kernel's running one, the lane's): each p is off
# by at most 2^-9 of itself on each side, so the f32 outputs part by at
# most 2^-8 W; rounding both to bf16 adds at most 2^-7 |want|; DECODE_ATOL
# covers the f32 summation order.  The int8 kernel keeps p in f32 on
# both sides: W = 0.  At 2,048 keys W is ~0.5 and the limit ~0.0022,
# where a 32-key tile left out moves the largest output by ~0.01
DECODE_ATOL = 1e-4
DECODE_KERNELS = ("paged_flash_decode", "paged_flash_decode_q",
                  "flash_decode")
ATTN_KERNELS = DECODE_KERNELS + ("flash_attention",)
# kernels whose every compiled instance must report 0 spill bytes
SPILL_FREE = ("paged_flash_decode", "flash_decode", "paged_flash_decode_q",
              "int8_matmul", "i_softmax", "i_layernorm", "i_gelu",
              "row_norm", "gemm")
LOGIT_TOL = 0.1    # 30 bf16 layers, CPU vs card summation order
LOSS_TOL = 1e-2    # mean cross-entropy of those logits, card vs CPU
# flash_attention vs its plain version, (atol, rtol) as |out - want| <=
# atol + rtol * |want|: 2e-5 in f32 (tests/test_flash_attention.py's); in
# bf16 two ulps of the output plus 4e-3, well under the ~0.03 of a
# typical output at S=4096, which a key tile left out or counted twice
# moves by more
FA_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (4e-3, 2 ** -7)}
# row_norm's widths: the reduced configs, smollm-135m, internvl2-1b,
# musicgen-medium, xlstm-1.3b and moonshot-v1-16b-a3b, recurrentgemma-2b,
# minitron-8b, llama4-maverick-400b-a17b, deepseek-coder-33b; its row
# counts: one lane, a decode step (B=8), a verify pass (8 x 5), a long
# prompt
ROW_NORM_DS = (64, 576, 896, 1536, 2048, 2560, 4096, 5120, 7168)
ROW_NORM_ROWS = (1, 8, 40, 4096)
# row_norm vs its plain version: a bf16 output within one bf16 ulp of the
# plain one (the two round f32 values a few f32 ulps apart), an f32 one
# within ROW_NORM_TOL of itself; layernorm adds ROW_NORM_TOL of the row's
# largest |output|: x - mu cancels where x is near the mean, so a mean a
# few f32 ulps apart moves an output near 0 by more than its own ulp
ROW_NORM_TOL = 1e-6
SPEC_K = 4  # the spec phase's most drafted tokens per dispatch
# the two 1-layer drafts' Adam steps (1,000 before the plans phase grew):
# the spec phase requires spec streams equal to the plain engine's,
# which holds for any draft; their acceptance is logged
DRAFT_FIT_STEPS = 300
# the families phase: each served at full width, whole but for
# deepseek-coder-33b, cut from 62 to 8 layers (~4.7 B parameters, ~9.4 GB
# in bf16; init_params draws each stacked leaf in f32 first)
FAMILIES = ("minitron-8b", "musicgen-medium", "internvl2-1b",
            "deepseek-coder-33b")
FAMILY_LAYERS = {"deepseek-coder-33b": 8}
# the spec phase's page pool (16-row pages): ~5 lanes' worth at its
# budgets, so B=8 lanes starve, preempt and (speculating) catch drafts up
SPEC_PAGES = 30
# the paged serve profile's window: 4 requests (16 before the recurrent
# phase came, 8 before the plans phase; the profiler's handling of the
# window's events took ~100 s at 16)
PROFILE_REQUESTS = 4
# the recurrent phase: each model at full width, card vs CPU on the
# layers that hold every block kind (recurrentgemma's period: rglru,
# rglru, attn; xlstm's mLSTM and sLSTM at slstm_every=2), then served at
# full depth
RECURRENT_CUT = {"recurrentgemma-2b": 3, "xlstm-1.3b": 2}
# the moe phase: moonshot-v1-16b-a3b served at all 48 layers (28.9 B
# parameters, 57.8 GB in bf16) and llama4-maverick-400b-a17b at its
# 2-layer period (a dense layer, then a MoE layer of 128 experts: 18.6 B,
# 37.1 GB; two periods do not fit beside the arenas), both at full width
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
MOE_LAYERS = {"llama4-maverick-400b-a17b": 2}
# the moe phase's mode="serve" plans: arch -> (layers, mesh shapes), the
# layers the first of the phase's tree (views): moonshot's experts are
# 1.107 GB a layer, and an exact plan's placement copies the wi and wg
# blocks (2/3 of them), 35.4 GB at 48 layers beside the 57.8 GB tree, past
# the card's 80 GB; 8.9 GB at 12.  llama4's one period stacks to a leading
# dim of 1, so its expert blocks are contiguous views (no copy).  An exact
# plan is gather-form (reductions whole) only where the plan drops FSDP,
# at most 8 GB of weights a shard (build_plan, the reference's capacity
# rule): moonshot x12 takes 7.7 GB a shard on (1, 2), llama4's period
# 18.6 GB on (1, 2), 9.3 on (1, 4) and 4.6 on (1, 8).  The archs in
# MOE_NO_EXACT also run exact=False on the first shape (their expert wo
# cut too: 4.4 GB more at moonshot x12)
MOE_PLAN = {"moonshot-v1-16b-a3b": (12, ((1, 2), (1, 4))),
            "llama4-maverick-400b-a17b": (2, ((1, 8),))}
MOE_NO_EXACT = ("moonshot-v1-16b-a3b",)
# the layers of moonshot's stage pipelines: its first 12 (views), 2 a
# stage (cut from 48 for chip time)
MOE_PIPELINE_LAYERS = 12
# the fleet phase: lanes a replica (and a disaggregated engine), and the
# affinity rebalance margin in token-steps, past the 16 requests' whole
# backlog (16 x (128 + 16)), so every prefix group stays on one replica
FLEET_B = 4
FLEET_MARGIN = 10_000
# the fitted phase: (arch, Adam steps, cache kind) of each reduced fit
# gated card vs CPU.  The fits (~250 s on a quick host, ~360 s on a slow
# one) run in a worker process beside phases 10-15, so they add little
# to the script's time.  The sLSTM's sequential scan makes an xlstm step
# ~3x a recurrentgemma one on the card (122 s and 41 s for 1,000 steps
# on an H100 80GB HBM3 at 700 W), so xlstm takes fewer
FITTED_GATES = (("musicgen-medium", 1000, "paged"),
                ("minitron-8b", 1000, "paged"),
                ("recurrentgemma-2b", 1000, "dense"),
                ("xlstm-1.3b", 400, "dense"),
                ("moonshot-v1-16b-a3b", 1000, "paged"),
                ("llama4-maverick-400b-a17b", 1000, "paged"))
# the longest the fitted phase waits for one fit, seconds
FIT_WAIT_S = 600
# recurrentgemma-2b's decode-step int8_matmul shapes (its tail MLPs: K
# 2560 -> N 7680 for wi and wg, 7680 -> 2560 for wo) at a decode step's
# 8 lanes and a 128-token prefill bucket
INT8_DECODER_SHAPES = ((8, 2560, 7680), (8, 7680, 2560), (128, 2560, 7680),
                       (128, 7680, 2560))
# and a shard's under a (1, 2) mode="serve" plan at 8 lanes: a column
# block of wi / wg (K 2560 -> N 3840), and a row block of wo under
# exact=False (K 3840 -> N 2560); an exact plan's wo is whole (above).
# Each block is stored column-major, as the executor places it
INT8_SHARD_SHAPES = ((8, 2560, 3840, "column"), (8, 3840, 2560, "row"))


def log(msg: str) -> None:
    print(msg, flush=True)


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


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
    and 7 (where b holds them) are inactive."""
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
    active[[i for i in (5, 7) if i < b]] = False
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


def verify_inputs(seed: int, b: int, t: int, kvh: int, g: int, hd: int,
                  ps: int, maxp: int, dev) -> dict:
    """The speculative verify pass's kernel inputs: lane i's block sits at
    positions pos_i .. pos_i + t - 1, all written (the verify scatter runs
    first), later rows never written; the t queries of a lane fold into
    t lanes that repeat its table row, qpos = pos_i + j; lanes 5 and 7
    (all their folded lanes) are inactive."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * maxp
    pos = rng.integers(maxp * ps // 2, maxp * ps - t, b)
    kpos = np.full((n_pages, ps), SENTINEL, np.int32)
    pt = np.zeros((b, maxp), np.int32)
    nxt = 1
    for lane in range(b):
        end = int(pos[lane]) + t
        for j in range(-(-end // ps)):
            pt[lane, j] = nxt
            rows = j * ps + np.arange(ps)
            kpos[nxt] = np.where(rows < end, rows, SENTINEL)
            nxt += 1
    active = np.ones((b,), bool)
    active[[5, 7]] = False
    bf = torch.bfloat16
    x = {"q": torch.tensor(rng.normal(0, 1, (b * t, kvh * g, hd))
                           * hd ** -0.5),
         "k": torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd))),
         "v": torch.tensor(rng.uniform(-1, 1, (n_pages, ps, kvh, hd)))}
    x = {n: v.to(bf).to(dev) for n, v in x.items()}
    x.update(kpos=torch.tensor(kpos, device=dev),
             page_table=torch.tensor(np.repeat(pt, t, axis=0), device=dev),
             qpos=torch.tensor((pos[:, None] + np.arange(t)).reshape(-1),
                               dtype=torch.int32, device=dev),
             active=torch.tensor(np.repeat(active, t), device=dev))
    return x


def verify_kernel_phase(dev, flush, quantized: bool) -> dict:
    """Kernel 1 (bf16 arena) or 2 (int8) at the verify pass's shape at
    smollm-135m's heads: B=8 lanes x T=SPEC_K+1 queries = 40 folded
    lanes, MAXP=12 pages of 16 — against its plain version, timed beside
    it and beside SDPA."""
    b, t, kvh, g, hd, ps, maxp = 8, SPEC_K + 1, 3, 3, 64, 16, 12
    x = verify_inputs(maxp, b, t, kvh, g, hd, ps, maxp, dev)
    nl = b * t
    pt = x["page_table"].long()
    mask = ((x["kpos"][pt].reshape(nl, -1) <= x["qpos"][:, None])
            & x["active"][:, None])
    label = (f"verify B={b} T={t} ({nl} lanes) KVH={kvh} G={g} hd={hd} "
             f"ps={ps} MAXP={maxp}")
    if not quantized:
        args = (x["q"], x["k"], x["v"], x["kpos"], x["page_table"],
                x["qpos"])
        kg, vg = (y[pt].reshape(nl, -1, kvh, hd) for y in (x["k"], x["v"]))
        nbytes, pairs = _paged_need(x, ps, kvh * hd * 2 * 2)
        w = ref.paged_flash_decode(x["q"], x["k"], x["v"].abs(), *args[3:],
                                   active=x["active"])
        return _decode_case(
            "paged_flash_decode", label,
            lambda: ops.paged_flash_decode(*args, active=x["active"]),
            lambda: ref.paged_flash_decode(*args, active=x["active"]),
            _sdpa(x["q"], kg, vg, mask, g), flush, x["active"], nbytes,
            4 * pairs * kvh * g * hd, w)
    k8, ks = quant.kv_quantize(x["k"])
    v8, vs = quant.kv_quantize(x["v"])
    args = (x["q"], k8, v8, ks, vs, x["kpos"], x["page_table"], x["qpos"])
    kg, vg = (quant.kv_dequantize(y[pt], sc[pt]).reshape(nl, -1, kvh, hd)
              for y, sc in ((k8, ks), (v8, vs)))
    nbytes, pairs = _paged_need(x, ps, kvh * (2 * hd + 2 * 4))
    return _decode_case(
        "paged_flash_decode_q", label + " (f32 SDPA over keys dequantized "
        "beforehand)",
        lambda: ops.paged_flash_decode_q(*args, active=x["active"]),
        lambda: ref.paged_flash_decode_q(*args, active=x["active"]),
        _sdpa(x["q"].float(), kg, vg, mask, g), flush, x["active"], nbytes,
        4 * pairs * kvh * g * hd)


def kernel_phase(dev, flush, maxp: int, kvh: int = 3, g: int = 3,
                 hd: int = 64, b: int = 8) -> dict:
    """The bf16 paged kernel at the serve path's shape (paged_inputs), or
    at other heads (phi3-medium-14b's: KVH=10, G=4, hd=128) or lane
    counts (a skewed pipeline's lane group)."""
    ps = 16
    t = paged_inputs(maxp, b, kvh, g, hd, ps, maxp, dev)
    args = (t["q"], t["k"], t["v"], t["kpos"], t["page_table"], t["qpos"])
    pt = t["page_table"].long()
    kg, vg = (x[pt].reshape(b, -1, kvh, hd) for x in (t["k"], t["v"]))
    mask = ((t["kpos"][pt].reshape(b, -1) <= t["qpos"][:, None])
            & t["active"][:, None])
    nbytes, pairs = _paged_need(t, ps, kvh * hd * 2 * 2)
    w = ref.paged_flash_decode(t["q"], t["k"], t["v"].abs(), *args[3:],
                               active=t["active"])
    return _decode_case(
        "paged_flash_decode", f"B={b} KVH={kvh} G={g} hd={hd} ps={ps} "
        f"MAXP={maxp}",
        lambda: ops.paged_flash_decode(*args, active=t["active"]),
        lambda: ref.paged_flash_decode(*args, active=t["active"]),
        _sdpa(t["q"], kg, vg, mask, g), flush, t["active"], nbytes,
        4 * pairs * kvh * g * hd, w)


def _paged_need(t: dict, ps: int, row_bytes: int) -> tuple:
    """The least bytes a paged decode kernel moves, and the (lane, key)
    pairs it attends.  Bytes: K/V of each (page, row) an active lane
    keeps, once (`row_bytes` per row, all kv heads, scales included),
    the kpos of each page the active lanes' tables name, once, those
    lanes' q and table rows, out, qpos and active.  Inactive lanes read
    nothing."""
    act = t["active"]
    pt = t["page_table"][act].long()  # (A, MAXP)
    keep = t["kpos"][pt] <= t["qpos"][act][:, None, None]  # (A, MAXP, ps)
    rows = (pt[..., None] * ps + torch.arange(ps, device=pt.device))[keep]
    n_act, h_hd = pt.shape[0], t["q"][0].numel()
    nbytes = (torch.unique(rows).numel() * row_bytes
              + torch.unique(pt).numel() * ps * 4
              + n_act * h_hd * 2 + t["q"].numel() * 2 + pt.numel() * 4
              + act.numel() * 4 + act.numel())
    return nbytes, int(keep.sum())


def _decode_case(name: str, label: str, kernel, plain, library, flush,
                 active: torch.Tensor, nbytes: float, nflop: float,
                 w=None) -> dict:
    """One decode kernel at one shape: against its plain version on the
    same card inputs (within DECODE_ATOL + 2^-7 |want| + 2^-8 w, w the
    plain version over |v| or None where p stays f32; exact zeros on
    inactive lanes), then timed beside it and beside a library
    yardstick."""
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    require(out.dtype == want.dtype and out.shape == want.shape,
            f"{name} {label}: {out.dtype} {tuple(out.shape)} vs plain "
            f"{want.dtype} {tuple(want.shape)}")
    require(bool(torch.isfinite(out).all()), f"{name} {label}: not finite")
    require(bool((out[~active] == 0).all()),
            f"{name} {label}: inactive lanes must be exact zeros")
    diff, mag = (out.float() - want.float()).abs(), want.float().abs()
    err = diff.max().item()
    limit = DECODE_ATOL + 2 ** -7 * mag
    if w is not None:
        limit = limit + 2 ** -8 * w.float()
    # the worst element's share of its limit (at most 1); the mean |want|
    # and mean limit of the active lanes, a typical output and its limit
    worst = (diff / limit).max().item()
    check = (f"max_abs_err={err:.3g} (limit {DECODE_ATOL:g} + 2^-7 |want|"
             f"{' + 2^-8 W' if w is not None else ''}, worst {worst:.3f} "
             f"of it; mean |want| {mag[active].mean().item():.4g}, mean "
             f"limit {limit[active].mean().item():.4g})")
    require(worst <= 1.0, f"{name} {label}: kernel vs plain {check}")
    ms = time_ms(kernel, flush)
    plain_ms = time_ms(plain, flush)
    library_ms = time_ms(library, flush)
    bound_ms, bound_by = _bound(nbytes, nflop, F32_FLOP_S)
    log(f"kernel {name} {label}: {check} "
        f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
        f"bound_ms={bound_ms:.6f} ({bound_by}; {nbytes:.0f} bytes, "
        f"{nflop:.4g} flop)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _sdpa(q, k, v, mask, g):
    """The yardstick call: SDPA of q (B, H, hd) over k/v (B, S, KVH, hd),
    kv heads expanded to the query heads beforehand, mask (B, S)."""
    b, h, hd = q.shape
    kx, vx = (x.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
              for x in (k, v))
    q4, m4 = q.view(b, h, 1, hd), mask.view(b, 1, 1, -1)
    return lambda: F.scaled_dot_product_attention(q4, kx, vx, attn_mask=m4,
                                                  scale=1.0)


def flash_decode_phase(dev, flush, sk: int, window: int = 0, kvh: int = 3,
                       g: int = 3, hd: int = 64) -> dict:
    """The dense slot-cache kernel at the serve path's shape (or at other
    heads): B=8 lanes of Sk slots, lane i holding positions 0..n_i-1 (the
    rest never written), qpos = n_i - 1, lanes 5 and 7 inactive."""
    b = 8
    rng = np.random.default_rng(sk + window)
    n = rng.integers(sk // 4, sk + 1, b)
    slot = np.arange(sk)[None]
    kpos = np.where(slot < n[:, None], slot, SENTINEL).astype(np.int32)
    active = np.ones((b,), bool)
    active[[5, 7]] = False
    bf = torch.bfloat16
    q = torch.tensor(rng.normal(0, 1, (b, kvh * g, hd)) * hd ** -0.5).to(
        bf).to(dev)
    k, v = (torch.tensor(rng.uniform(-1, 1, (b, sk, kvh, hd))).to(bf).to(dev)
            for _ in range(2))
    kpos_t = torch.tensor(kpos, device=dev)
    qpos = torch.tensor((n - 1).astype(np.int32), device=dev)
    act = torch.tensor(active, device=dev)
    args = (q, k, v, kpos_t, qpos)
    keep = (kpos <= (n - 1)[:, None]) & active[:, None]
    if window:
        keep &= (n - 1)[:, None] - kpos < window
    # least bytes: the keys the active lanes attend (K and V rows), their
    # lanes' kpos, q, out, qpos, active
    attended = int(keep.sum())
    nbytes = (attended * kvh * hd * 2 * 2 + int(active.sum()) * sk * 4
              + 2 * q.numel() * 2 + b * 4 + b)
    w = ref.flash_decode(q, k, v.abs(), kpos_t, qpos, active=act,
                         window=window)
    return _decode_case(
        "flash_decode", f"B={b} Sk={sk} KVH={kvh} G={g} hd={hd} "
        f"window={window}",
        lambda: ops.flash_decode(*args, active=act, window=window),
        lambda: ref.flash_decode(*args, active=act, window=window),
        _sdpa(q, k, v, torch.tensor(keep, device=dev), g), flush, act,
        nbytes, 4 * attended * kvh * g * hd, w)


def paged_q_phase(dev, flush, maxp: int, kvh: int = 3, g: int = 3,
                  hd: int = 64, b: int = 8) -> dict:
    """The int8 paged kernel at the serve path's shape (or at other heads
    or lane counts): paged_inputs' tables and lanes, k/v quantized into
    an int8 arena on the card."""
    ps = 16
    t = paged_inputs(maxp, b, kvh, g, hd, ps, maxp, dev)
    k8, ks = quant.kv_quantize(t["k"])
    v8, vs = quant.kv_quantize(t["v"])
    args = (t["q"], k8, v8, ks, vs, t["kpos"], t["page_table"], t["qpos"])
    pt = t["page_table"].long()
    kg, vg = (quant.kv_dequantize(x[pt], sc[pt]).reshape(b, -1, kvh, hd)
              for x, sc in ((k8, ks), (v8, vs)))
    mask = ((t["kpos"][pt].reshape(b, -1) <= t["qpos"][:, None])
            & t["active"][:, None])
    # least bytes, as for paged_flash_decode: kept rows of int8 K and V
    # with their f32 scales
    nbytes, pairs = _paged_need(t, ps, kvh * (2 * hd + 2 * 4))
    return _decode_case(
        "paged_flash_decode_q", f"B={b} KVH={kvh} G={g} hd={hd} ps={ps} "
        f"MAXP={maxp} (f32 SDPA over keys dequantized beforehand)",
        lambda: ops.paged_flash_decode_q(*args, active=t["active"]),
        lambda: ref.paged_flash_decode_q(*args, active=t["active"]),
        _sdpa(t["q"].float(), kg, vg, mask, g), flush, t["active"], nbytes,
        4 * pairs * kvh * g * hd)


def flash_attention_phase(dev, flush, b: int, s: int, h: int, kvh: int,
                          hd: int, dtype, causal: bool, timing: bool = True,
                          plain_timing: bool = True) -> dict:
    """The prefill kernel at one shape: q, k, v ~ N(0, 1) from a seed,
    against its plain version on the card (FA_TOL), then (with `timing`)
    timed beside SDPA and (with `plain_timing`) beside the plain version.
    Bound: Q, K, V and O once over the HBM rate, or the flops these masks
    need (4 per query-key pair per head dim) over the dtype's peak (bf16
    tensor cores, or f32)."""
    name = "flash_attention"
    rng = np.random.default_rng(s + h + hd)
    q, k, v = (torch.tensor(rng.normal(0, 1, (b, s, n, hd)),
                            dtype=torch.float32).to(dtype).to(dev)
               for n in (h, kvh, kvh))
    label = (f"B={b} S={s} H={h} KVH={kvh} hd={hd} "
             f"{str(dtype).replace('torch.', '')} causal={causal}")
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    require(out.dtype == want.dtype and out.shape == want.shape,
            f"{name} {label}: {out.dtype} {tuple(out.shape)} vs plain "
            f"{want.dtype} {tuple(want.shape)}")
    require(bool(torch.isfinite(out).all()), f"{name} {label}: not finite")
    atol, rtol = FA_TOL[dtype]
    diff, mag = (out.float() - want.float()).abs(), want.float().abs()
    err = diff.max().item()
    # the worst element's share of its limit: at most 1
    worst = (diff / (atol + rtol * mag)).max().item()
    check = (f"max_abs_err={err:.3g} (limit {atol:g} + {rtol:g} |want|, "
             f"worst {worst:.3f} of it; mean |want| {mag.mean().item():.4g})")
    require(worst <= 1.0, f"{name} {label}: kernel vs plain {check}")
    del out, want, diff, mag
    if not timing:
        log(f"kernel {name} {label}: {check}")
        return dict(max_abs_err=err)
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal), flush)
    plain_ms = (time_ms(lambda: ref.flash_attention(q, k, v, causal=causal),
                        flush, iters=5) if plain_timing else None)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = None
    try:  # a yardstick only, never part of the port
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush)
    except RuntimeError as exc:
        log(f"kernel {name} {label}: SDPA yardstick refused: {exc}")
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    nflop = 4 * b * h * hd * pairs
    bound_ms, bound_by = _bound(nbytes, nflop, BF16_FLOP_S
                                if dtype == torch.bfloat16 else F32_FLOP_S)
    lib = "none" if library_ms is None else f"{library_ms:.5f}"
    plain = "not timed" if plain_ms is None else f"{plain_ms:.5f}"
    log(f"kernel {name} {label}: {check} "
        f"ms={ms:.5f} plain_ms={plain} library_ms={lib} (SDPA) "
        f"bound_ms={bound_ms:.6f} ({bound_by}; {nbytes:.0f} bytes, "
        f"{nflop:.4g} flop) achieved_tflop_s={nflop / ms / 1e9:.2f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _bound(nbytes: float, nops: float, ops_rate: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _ibert_case(name: str, label: str, kernel, plain, flush, nbytes: float,
                nops: float, ops_rate: float, library=None,
                copy_src=None) -> dict:
    """One I-BERT kernel at one shape: bit-exact against its plain version
    on the same card inputs, then timed beside it and beside a copy that
    moves the same bytes (`copy_src` copied, or a byte buffer of half
    `nbytes`): one launch's practical floor on this card, cold L2."""
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    require(out.dtype == want.dtype and out.shape == want.shape,
            f"{name} {label}: {out.dtype} {tuple(out.shape)} vs plain "
            f"{want.dtype} {tuple(want.shape)}")
    err = (out.long() - want.long()).abs().max().item()
    require(err == 0, f"{name} {label}: kernel differs from its plain "
            f"version (max abs err {err}, {(out != want).sum().item()} "
            "elements)")
    ms = time_ms(kernel, flush)
    plain_ms = time_ms(plain, flush)
    library_ms = None
    if library is not None:  # a yardstick only, never part of the port
        try:
            library_ms = time_ms(library, flush)
        except RuntimeError as exc:
            log(f"kernel {name} {label}: library yardstick refused: {exc}")
    bound_ms, bound_by = _bound(nbytes, nops, ops_rate)
    lib = (f"library_ms={library_ms:.5f}" if library_ms is not None
           else "library_ms=none (no single PyTorch call computes it)")
    log(f"kernel {name} {label}: max_abs_err={err} (bit-exact) ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} {lib} bound_ms={bound_ms:.6f} "
        f"({bound_by}; {nbytes:.0f} bytes, {nops:.4g} ops)")
    src = (copy_src if copy_src is not None else
           torch.empty(int(nbytes) // 2, dtype=torch.uint8, device=out.device))
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), flush)
    log(f"kernel {name} {label}: copy_ms={copy_ms:.5f} (a same-bytes "
        f"yardstick, not a library call: {2 * src.nbytes} bytes moved by "
        f"one copy_; kernel / copy {ms / copy_ms:.2f})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def ibert_kernel_phase(dev, flush) -> dict:
    """The four I-BERT kernels at ibert-base's batch-1, seq-128 shapes
    (i_softmax also at seq 512).  Returns {kernel: metrics at its main
    shape}; int8_matmul's main shape is the q/k/v/wo GEMM (4 of its 6
    launches per layer)."""
    rng = np.random.default_rng(12)
    m, d, f = 128, 768, 3072

    def ints(lo, hi, shape, dtype):
        return torch.tensor(rng.integers(lo, hi, shape), dtype=dtype,
                            device=dev)

    res = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, n, requant in ((d, d, True), (d, f, False), (f, d, True)):
        a, b = ints(-127, 128, (m, k), torch.int8), ints(-127, 128, (k, n),
                                                          torch.int8)
        bc = b.t().contiguous().t()  # the encoder's layout: column-major
        bias = ints(-20000, 20000, (n,), torch.int32)
        sa, sb = torch.tensor(0.02), torch.tensor(0.004)
        so = torch.tensor(0.3) if requant else None
        out_bytes = m * n * (1 if requant else 4)
        label = f"{m}x{k}x{n} {'requant' if requant else 'int32'}"
        r = _ibert_case(
            "int8_matmul", f"{label}, B column-major (split-K "
            f"{ops.int8_matmul_split(m, n, k, sms)}; library "
            "torch._int_mm on row-major B, the product only)",
            lambda: ops.int8_matmul(a, bc, sa, sb, s_out=so, bias=bias),
            lambda: ref.int8_matmul(a, bc, sa, sb, s_out=so, bias=bias),
            flush, m * k + k * n + 4 * n + out_bytes, 2 * m * n * k,
            INT8_OPS_S, library=lambda: torch._int_mm(a, b))
        res.setdefault("int8_matmul", r)
        # a row-major B takes one transposing copy in the wrapper first
        def row_major():
            return ops.int8_matmul(a, b, sa, sb, s_out=so, bias=bias)

        same = torch.equal(row_major(), ops.int8_matmul(
            a, bc, sa, sb, s_out=so, bias=bias))
        require(same, f"int8_matmul {label}: row-major B differs from "
                "column-major B")
        log(f"kernel int8_matmul {label}: B row-major (copy + kernel) equals"
            f" B column-major bit for bit; ms="
            f"{time_ms(row_major, flush):.5f}")
    # the encoder's (12 heads x seq 128, 128), then ibert-base at its
    # max_seq_len 512 (rows of 512 whole in registers)
    for rows, cols in ((12 * m, m), (12 * 512, 512)):
        q = ints(-2047, 2048, (rows, cols), torch.int32)
        r = _ibert_case(
            "i_softmax", f"({rows}, {cols})",
            lambda: ops.i_softmax(q, 0.004),
            lambda: ref.i_softmax_rows(q, 0.004), flush, 2 * 4 * rows * cols,
            IBERT_OPS_PER_ELEM["i_softmax"] * rows * cols, F32_FLOP_S,
            copy_src=q)
        res.setdefault("i_softmax", r)
    r = ints(-127, 128, (m, d), torch.int32) + ints(-127, 128, (m, d),
                                                    torch.int32)
    prep = ibert_ops.layernorm_prepare(
        torch.tensor(rng.uniform(0.5, 1.5, d), dtype=torch.float32,
                     device=dev),
        torch.tensor(rng.normal(0, 0.1, d), dtype=torch.float32, device=dev))
    res["i_layernorm"] = _ibert_case(
        "i_layernorm", f"({m}, {d})", lambda: ops.i_layernorm(r, prep)[0],
        lambda: ref.i_layernorm_rows(r, prep.q_gamma, prep.q_beta), flush,
        2 * 4 * m * d + 2 * 4 * d, IBERT_OPS_PER_ELEM["i_layernorm"] * m * d,
        F32_FLOP_S, copy_src=r)
    g = ints(-2047, 2048, (m, f), torch.int32)
    res["i_gelu"] = _ibert_case(
        "i_gelu", f"({m}, {f})", lambda: ops.i_gelu(g, 0.003),
        lambda: ref.i_gelu_elem(g, 0.003), flush, 2 * 4 * m * f,
        IBERT_OPS_PER_ELEM["i_gelu"] * m * f, F32_FLOP_S, copy_src=g)
    return res


def int8_decoder_phase(dev, flush) -> None:
    """int8_matmul at recurrentgemma-2b's W8A8 tail-MLP shapes
    (INT8_DECODER_SHAPES) and at a (1, 2) serve plan's shard blocks
    (INT8_SHARD_SHAPES), the weight quantized per channel and stored
    column-major as `models/quantized.quantize_leaf` keeps it, the int32
    product only (qdense scales it afterwards): bit-exact against the
    plain version, timed beside torch._int_mm (whose M must exceed 16:
    at M = 8 its rows are padded to 32 with zeros, and the time is of
    that padded call)."""
    rng = np.random.default_rng(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [(m, k, n, None) for m, k, n in INT8_DECODER_SHAPES]
    for m, k, n, block in cases + list(INT8_SHARD_SHAPES):
        a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8,
                         device=dev)
        if block is None:
            w = torch.tensor(rng.normal(0, 0.02, (k, n)),
                             dtype=torch.bfloat16, device=dev)
            q = quantize_leaf(w)["q"]
        else:  # shard 0's block of the whole (1, 2) weight, placed
            whole = (k, 2 * n) if block == "column" else (2 * k, n)
            w = torch.tensor(rng.normal(0, 0.02, whole),
                             dtype=torch.bfloat16, device=dev)
            q = quantize_leaf(w)["q"]
            q = column_major(q[:, :n] if block == "column" else q[:k])
        require(q.t().is_contiguous(), f"int8_matmul {m}x{k}x{n}: the "
                "weight is not column-major")
        brow = q.contiguous()
        pad = 32 if m <= 16 else m
        ap = torch.zeros((pad, k), dtype=torch.int8, device=dev)
        ap[:m] = a
        where = ("" if block is None else f", a (1, 2) shard's {block} "
                 "block")
        _ibert_case(
            "int8_matmul", f"{m}x{k}x{n} int32, recurrentgemma-2b W8A8"
            f"{where} (B column-major; split-K "
            f"{ops.int8_matmul_split(m, n, k, sms)};"
            f" library torch._int_mm on row-major B"
            f"{', rows padded to 32' if pad != m else ''})",
            lambda: ops.int8_matmul(a, q, 1.0, 1.0),
            lambda: ref.int8_matmul(a, q, 1.0, 1.0), flush,
            m * k + k * n + 4 * m * n, 2 * m * n * k, INT8_OPS_S,
            library=lambda: torch._int_mm(ap, brow))


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at each |t| (t holds bf16 values, as f32):
    2^(e - 8) for |t| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(t)
    return torch.ldexp(torch.ones_like(t), e - 8)


def _row_norm_check(label: str, out, want, layer: bool) -> tuple:
    """row_norm's output against its plain version's (ROW_NORM_TOL):
    (a note for the log line, the largest |difference|)."""
    require(out.dtype == want.dtype and out.shape == want.shape,
            f"row_norm {label}: {out.dtype} {tuple(out.shape)} vs plain "
            f"{want.dtype} {tuple(want.shape)}")
    o, w = out.float(), want.float()
    require(bool(torch.isfinite(o).all()), f"row_norm {label}: not finite")
    diff = (o - w).abs()
    if out.dtype == torch.bfloat16:
        limit, unit = _bf16_ulp(w), "bf16 ulp of want"
    else:
        limit, unit = ROW_NORM_TOL * w.abs(), f"{ROW_NORM_TOL:g} |want|"
    if layer:
        limit = limit + ROW_NORM_TOL * w.abs().amax(-1, keepdim=True)
        unit += f" + {ROW_NORM_TOL:g} of the row's largest |want|"
    bad = int((diff > limit).sum())
    worst = (diff / limit.clamp(min=2.0 ** -149)).max().item()
    err = diff.max().item()
    check = (f"max_abs_err={err:.3g} (limit 1 x {unit}; worst {worst:.3f} "
             f"of it) differing share={(diff > 0).float().mean().item():.5f}")
    require(bad == 0, f"row_norm {label}: {bad} elements beyond the limit; "
            f"{check}")
    return check, err


def row_norm_phase(dev, flush) -> dict:
    """The port-only row norm (rmsnorm, and layernorm with a bias) against
    its plain version on the card, at every width of ROW_NORM_DS and
    every row count of ROW_NORM_ROWS, in bf16 (timed beside the plain
    version and F.rms_norm / F.layer_norm) and in f32, and equal bit for
    bit to the kernel's order of sums in torch (`ref.row_norm_schedule`,
    over `ops.row_norm_geometry`); then row-count invariance: each row
    count's output equals the next one's first rows bit for bit.  Returns
    the metrics at a smollm-135m decode step's rmsnorm (8 rows of 576,
    bf16)."""
    rng = np.random.default_rng(21)
    bf, f32, eps = torch.bfloat16, torch.float32, 1e-6
    main = None
    for d in ROW_NORM_DS:
        # a nonzero mean: layernorm's x - mu cancels, as in a model
        x_all = torch.tensor(rng.normal(0.3, 1.0, (ROW_NORM_ROWS[-1], d)),
                             dtype=f32, device=dev)
        g = torch.tensor(rng.uniform(0.5, 1.5, d), dtype=f32, device=dev)
        b0 = torch.tensor(rng.normal(0, 0.1, d), dtype=f32, device=dev)
        for layer in (False, True):
            form, b = ("layernorm", b0) if layer else ("rmsnorm", None)
            for dt in (bf, f32):
                x = x_all.to(dt)
                outs = {}
                for rows in ROW_NORM_ROWS:
                    xr = x[:rows]
                    label = (f"{form} rows={rows} D={d} "
                             f"{str(dt).replace('torch.', '')}")

                    def kernel():
                        return ops.row_norm(xr, g, b, eps)

                    def plain():
                        return (ref.layernorm(xr, g, b, eps) if layer
                                else ref.rmsnorm(xr, g, eps))

                    out, want = kernel(), plain()
                    sched = ref.row_norm_schedule(xr, g, b, eps)
                    torch.cuda.synchronize()
                    check, err = _row_norm_check(label, out, want, layer)
                    same = out == sched
                    require(bool(same.all()), f"row_norm {label}: "
                            f"{int((~same).sum())} of {out.numel()} outputs"
                            " differ from ref.row_norm_schedule's bits "
                            f"(geometry {ops.row_norm_geometry(d, dt)})")
                    check += " =schedule bit for bit"
                    outs[rows] = out
                    if dt is f32:
                        log(f"kernel row_norm {label}: {check}")
                        continue
                    m = _row_norm_timed(label, check, kernel, plain, xr, g,
                                        b, eps, flush)
                    if not layer and d == 576 and rows == 8:
                        main = dict(max_abs_err=err, **m)
                for small, big in zip(ROW_NORM_ROWS, ROW_NORM_ROWS[1:]):
                    require(torch.equal(outs[small], outs[big][:small]),
                            f"row_norm {form} D={d} {dt}: the first {small}"
                            f" rows of a {big}-row launch differ from a "
                            f"{small}-row launch")
                log(f"kernel row_norm {form} D={d} "
                    f"{str(dt).replace('torch.', '')}: row-count invariant "
                    f"bit for bit over rows {ROW_NORM_ROWS}")
    return main


def _row_norm_timed(label, check, kernel, plain, x, g, b, eps,
                    flush) -> dict:
    """One bf16 row_norm case timed beside its plain version and the
    library call (F.rms_norm / F.layer_norm, the weights cast to bf16).
    Bound: x read and y written once, g (and b) read once, over the HBM
    rate, or ~4 (rmsnorm) / ~7 (layernorm) f32 operations an element."""
    rows, d = x.shape
    ms = time_ms(kernel, flush)
    plain_ms = time_ms(plain, flush)
    # the fused library kernels take the weights in x's dtype
    gx, bx = g.to(x.dtype), None if b is None else b.to(x.dtype)
    library = ((lambda: F.layer_norm(x, (d,), gx, bx, eps)) if b is not None
               else (lambda: F.rms_norm(x, (d,), gx, eps)))
    library_ms = None
    try:  # a yardstick only, never part of the port
        library_ms = time_ms(library, flush)
    except RuntimeError as exc:
        log(f"kernel row_norm {label}: library yardstick refused: {exc}")
    nbytes = 2 * rows * d * x.element_size() + d * 4 * (1 if b is None else 2)
    bound_ms, bound_by = _bound(nbytes, (4 if b is None else 7) * rows * d,
                                F32_FLOP_S)
    lib = "none" if library_ms is None else f"{library_ms:.5f}"
    log(f"kernel row_norm {label}: {check} ms={ms:.5f} plain_ms="
        f"{plain_ms:.5f} library_ms={lib} bound_ms={bound_ms:.6f} "
        f"({bound_by}; {nbytes} bytes)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def serve_phase(stream: str, n: int, engine: str = "cb",
                kv_dtype: str = "bf16", paged="auto") -> dict:
    """One stream served at full width through the serve entry point, after
    a warm-up stream.  The route's decode kernel must launch once per layer
    per fused decode step, and the other decode kernels never."""
    args = serve_cli.parse_args([
        "--arch", "smollm-135m", "--requests", str(n), "--max-batch", "8",
        "--max-new", "32", "--stream", stream, "--warmup", "--seed", "0",
        "--engine", engine, "--kv-dtype", kv_dtype])
    kernel = ("flash_decode" if engine == "wave" or paged is False else
              "paged_flash_decode_q" if kv_dtype == "int8" else
              "paged_flash_decode")
    route = (engine if engine == "wave" else
             f"cb {'dense' if paged is False else 'paged ' + kv_dtype}")
    ops.reset_launches()
    eng, done, wall = serve_cli.serve(args, paged=paged)
    launches, norms = ops.launches[kernel], ops.launches["row_norm"]
    others = {k: ops.launches[k] for k in ATTN_KERNELS if k != kernel}
    steps = eng.stats["decode_steps"]  # warm-up pass included
    n_layers = eng.model.cfg.n_layers
    require(len(done) == n, f"{route}: {len(done)} of {n} requests finished")
    for r in done:
        require(r.done and (len(r.tokens_out) == r.max_new_tokens
                            or r.tokens_out[-1] == r.eos_id),
                f"{route}: request {r.rid} stopped short of its budget")
    require(launches == n_layers * steps,
            f"{route}: {launches} {kernel} launches != {n_layers} x {steps} "
            "steps")
    require(not any(others.values()), f"{route}: other attention kernels "
            f"launched: {others}")
    _require_norms(route, norms, eng)
    gemms, s = ops.launches["gemm"], eng.stats
    calls = s["decode_steps"] + s.get("prefills", 0) + s.get("waves", 0)
    per = 7 * n_layers + 1  # q, k, v, o, wi, wg, wo a layer; the head
    require(gemms == per * calls, f"{route}: {gemms} gemm launches != "
            f"{per} x {calls} backbone calls")
    toks = sum(len(r.tokens_out) for r in done)
    ttft = sorted((r.t_first_token - r.t_enqueue) * 1e3 for r in done)
    s = eng.stats
    log(f"serve {route} {stream}: requests={n} tokens={toks} "
        f"wall_s={wall:.4f} tok_s={toks / wall:.1f} "
        f"ttft_p50_ms={ttft[len(ttft) // 2]:.2f} decode_steps={steps} "
        f"{kernel}_launches={launches} (= {n_layers} x {steps}) "
        f"row_norm_launches={norms} gemm_launches={gemms} "
        f"prefix_hits={s.get('prefix_hits', 0)} "
        f"pages_peak={s.get('pages_peak', 0)} "
        f"preemptions={s.get('preemptions', 0)}")
    if stream == "shared-prefix":
        require(s["prefix_hits"] > 0, f"no prefix hit: {s}")
    return dict(kernel=kernel, launches=launches, row_norm=norms, gemm=gemms)


def _norms_per_call(cfg) -> int:
    """Row norms of one backbone call: 2 a layer (1 in the xLSTM family,
    whose blocks carry no MLP) and the final one."""
    return (1 if cfg.family == "ssm" else 2) * cfg.n_layers + 1


def _attn_layers(cfg) -> int:
    return sum(cfg.block_kind(i) == "attn" for i in range(cfg.n_layers))


def _require_norms(route: str, norms: int, eng) -> None:
    """The row norm's launches over a served stream: `_norms_per_call` at
    every backbone call (one per prefill or wave, one per fused decode
    step)."""
    s, per = eng.stats, _norms_per_call(eng.model.cfg)
    calls = s["decode_steps"] + s.get("prefills", 0) + s.get("waves", 0)
    require(norms == per * calls, f"{route}: {norms} row_norm "
            f"launches != {per} x {calls} backbone calls")


def _device_spans(fn, out=None) -> tuple:
    """fn() under torch.profiler: the device's (start, end, name) spans in
    start order, and the window's wall time on the host clock (us);
    `out["prof"]` gets the profile when `out` is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if out is not None:
        out["prof"] = prof
    return spans, wall_us


def _busy_us(spans) -> float:
    """Length of the union of the spans: the device's busy time."""
    busy, end = 0.0, -1.0
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def profile_phase(dev) -> None:
    """Where the main route's time goes: one Poisson stream served under
    torch.profiler by the continuous-batching engine on a paged bf16
    arena.  Prints the device's busy share of the window (union of kernel
    and copy intervals over the host clock), the decode kernel's and the
    row norm's shares of device time, and device ops per decode step.
    The profiler's own host cost lowers the busy share somewhat, and its
    handling of the window's events takes far longer than the stream, so
    only this route is profiled.  The window's launches are required
    exact on the wrappers' counts (n_layers decode kernels a step, 2n+1
    norms a backbone call); the profiler can lose a few of its ~73,000
    events (72,901-72,908 recorded for the same window in six runs on an
    H100), so each kernel's spans are required present and at most its
    launches, and both counts are logged."""
    args = serve_cli.parse_args(["--requests", str(PROFILE_REQUESTS),
                                 "--max-batch", "8", "--max-new", "32",
                                 "--seed", "3"])
    cfg = get_config(args.arch)
    engine = ContinuousBatchingEngine(make_model(cfg, device=dev),
                                      init_params(cfg, seed=0, device=dev),
                                      max_batch=args.max_batch,
                                      buckets=serve_cli.BUCKETS)
    for r in serve_cli.make_stream(args, cfg.vocab_size, args.seed):
        engine.submit(r)
    ops.reset_launches()
    spans, wall_us = _device_spans(engine.run)
    steps, n = engine.stats["decode_steps"], cfg.n_layers
    calls = steps + engine.stats["prefills"]
    want = {"paged_flash_decode": n * steps, "row_norm": (2 * n + 1) * calls}
    got = {k: ops.launches[k] for k in want}
    require(got == want, f"profile cb paged bf16: launches {got}, want "
            f"{n} x {steps} and {2 * n + 1} x {calls}")
    if not spans:
        log("profile cb paged bf16: the profiler recorded no device time "
            "(not measured)")
        return
    kern = [e - s for s, e, name in spans
            if "paged_flash_decode_kernel" in name]
    norms = [e - s for s, e, name in spans if "row_norm_kernel" in name]
    dev_total = sum(e - s for s, e, _ in spans)
    require(0 < len(kern) <= want["paged_flash_decode"]
            and 0 < len(norms) <= want["row_norm"],
            f"profile cb paged bf16: {len(kern)} paged_flash_decode and "
            f"{len(norms)} row_norm spans of {want} launches")
    log(f"profile cb paged bf16 poisson x{PROFILE_REQUESTS} (B=8, "
        f"max_new 32): "
        f"wall_ms={wall_us / 1e3:.2f} "
        f"device_busy_share={_busy_us(spans) / wall_us:.4f} "
        f"device_kernel_ms={dev_total / 1e3:.2f} "
        f"paged_flash_decode_share_of_device="
        f"{sum(kern) / max(dev_total, 1e-9):.4f} ({len(kern)} spans of "
        f"{got['paged_flash_decode']} launches, {n} x {steps} steps) "
        f"row_norm_share_of_device="
        f"{sum(norms) / max(dev_total, 1e-9):.4f} ({len(norms)} spans of "
        f"{got['row_norm']} launches, {2 * n + 1} x {calls} backbone "
        f"calls, mean {sum(norms) / max(len(norms), 1):.2f} us) "
        f"device_ops_per_decode_step={len(spans) / max(steps, 1):.1f} "
        f"decode_steps={steps} wall_ms_per_decode_step="
        f"{wall_us / 1e3 / max(steps, 1):.3f}")


def _launched(fn) -> tuple:
    """fn() with every launch count set to 0 just before and read just
    after: (fn's result, wall seconds to a synchronize, the counts)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(ops.launches)


def _counted(fn, want: dict, what: str):
    """fn() with the launch counts set to 0 just before and read just
    after: each attention kernel must have launched want.get(name, 0)
    times.  Returns (fn's result, wall seconds to a synchronize, the
    counts read)."""
    out, wall, got = _launched(fn)
    got = {k: got[k] for k in ATTN_KERNELS}
    need = {k: want.get(k, 0) for k in ATTN_KERNELS}
    require(got == need, f"{what}: launches {got} != {need}")
    return out, wall, got


def _kernel_profile(what: str, fn, kernel: str, launches: int,
                    note: str = "") -> None:
    """fn() under torch.profiler: the device's busy share of the window
    and `kernel`'s share of device time.  Its spans (every instance whose
    name holds `{kernel}_kernel`) must number `launches`, so a renamed
    kernel cannot read as a share of 0."""
    spans, wall_us = _device_spans(fn)
    if not spans:
        log(f"profile {what}: {note}the profiler recorded no device time "
            "(not measured)")
        return
    dev_total = sum(e - s for s, e, _ in spans)
    ks = [e - s for s, e, name in spans if f"{kernel}_kernel" in name]
    require(len(ks) == launches, f"profile {what}: {len(ks)} {kernel} "
            f"kernel spans, want {launches}")
    log(f"profile {what}: {note}wall_ms={wall_us / 1e3:.2f} "
        f"device_busy_share={_busy_us(spans) / wall_us:.4f} "
        f"device_kernel_ms={dev_total / 1e3:.3f} {kernel}_ms="
        f"{sum(ks) / 1e3:.3f} ({len(ks)} launches) "
        f"{kernel}_share_of_device={sum(ks) / dev_total:.4f} "
        f"device_ops={len(spans)}")


def _decode_profile(model, params, prompt, n_layers: int) -> None:
    """The 8 fused decode steps after a prefill of `prompt` into 1,600
    dense slots, warm: their wall time to a synchronize, then once more
    under torch.profiler (one flash_decode span per layer per step)."""
    act = torch.ones((1,), dtype=torch.bool, device=prompt.device)

    def prefilled():
        lg, caches = model.prefill(params, model.init_cache(1, 1600), prompt)
        return caches, lg.argmax(-1).to(torch.int32)

    caches, first = prefilled()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.decode_steps(params, caches, first, act, 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    caches, first = prefilled()
    _kernel_profile("8 fused decode steps after prefill S=1536 (warm)",
                    lambda: model.decode_steps(params, caches, first, act, 8),
                    "flash_decode", 8 * n_layers,
                    note=f"wall_ms={wall * 1e3:.2f}; profiled ")


def long_forward_phase(dev) -> int:
    """smollm-135m's long-context entry points at full width (30 layers,
    random weights from seed 0), counted; then card vs CPU.  Returns the
    flash_attention launches the counted runs read."""
    cfg = get_config("smollm-135m")
    n, vocab = cfg.n_layers, cfg.vocab_size
    fa = {"flash_attention": n}
    model = make_model(cfg, device=dev)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(5)
    toks = torch.tensor(rng.integers(0, vocab, (2, 4096)), dtype=torch.int32,
                        device=dev)
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    counts = []

    def counted(fn, want, what):
        out, wall, got = _counted(fn, want, what)
        counts.append(got["flash_attention"])
        return out, wall

    with torch.no_grad():
        # warm-up: GEMM heuristics and first loads of the loss's kernels
        model.forward_logits(params, toks)
        model.loss(params, batch)
        logits, wall = counted(lambda: model.forward_logits(params, toks),
                               fa, "smollm forward_logits")
        require(tuple(logits.shape) == (2, 4096, vocab)
                and bool(torch.isfinite(logits).all()),
                f"forward_logits: {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        del logits
        loss, wall_loss = counted(lambda: model.loss(params, batch), fa,
                                  "smollm loss")
        require(bool(torch.isfinite(loss)), f"loss {loss}")
        log(f"long forward smollm-135m x{n} B=2 S=4096: forward_logits "
            f"wall_ms={wall * 1e3:.2f} "
            f"tok_s={2 * 4096 / wall:.0f}; loss={float(loss):.5f} "
            f"wall_ms={wall_loss * 1e3:.2f}; flash_attention launches "
            f"{n} per call, decode kernels 0")
        _kernel_profile("smollm-135m forward_logits B=2 S=4096",
                        lambda: model.forward_logits(params, toks),
                        "flash_attention", n)

        # prefill at contiguous positions into dense slots, then decode
        caches = model.init_cache(1, 1600)
        (lg, caches), wall_pf = counted(lambda: model.prefill(
            params, caches, toks[:1, :1536]), fa, "smollm prefill S=1536")
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        out, wall_dec = counted(lambda: model.decode_steps(
            params, caches, lg.argmax(-1).to(torch.int32), active, 8),
            {"flash_decode": 8 * n}, "smollm 8 decode steps after prefill")
        block = out[0]
        require(tuple(block.shape) == (8, 1) and bool((block >= 0).all())
                and bool((block < vocab).all())
                and int(caches["pos"][0]) == 1536 + 8,
                f"decode after long prefill: tokens {block.flatten()}, pos "
                f"{caches['pos']}")
        log(f"long prefill smollm-135m S=1536 into 1600 dense slots: "
            f"wall_ms={wall_pf * 1e3:.2f} ({n} flash_attention); 8 fused "
            f"decode steps wall_ms={wall_dec * 1e3:.2f} ({8 * n} "
            f"flash_decode, 0 flash_attention)")
        _decode_profile(model, params, toks[:1, :1536], n)
        del caches

        # card vs CPU (plain versions) on the same weights and tokens
        t1, l1 = toks[:1, :2048], labels[:1, :2048]
        card_lg, _ = counted(lambda: model.forward_logits(params, t1), fa,
                             "smollm forward_logits S=2048")
        card_loss, _ = counted(lambda: model.loss(
            params, {"tokens": t1, "labels": l1}), fa, "smollm loss S=2048")
        cpu_model = make_model(cfg, device="cpu")
        cpu_params = _to(params, "cpu")
        t0 = time.perf_counter()
        cpu_lg = cpu_model.forward_logits(cpu_params, t1.cpu())
        cpu_loss = cpu_model.loss(cpu_params, {"tokens": t1.cpu(),
                                               "labels": l1.cpu()})
        cpu_s = time.perf_counter() - t0
    card_lg = card_lg.cpu()
    err_last = (card_lg[0, -1] - cpu_lg[0, -1]).abs().max().item()
    err_all = (card_lg - cpu_lg).abs().max().item()
    loss_err = abs(float(card_loss) - float(cpu_loss))
    log(f"long forward smollm-135m B=1 S=2048, card vs CPU: last-position "
        f"max_abs_logit_err={err_last:.4g} (tol {LOGIT_TOL}), all positions "
        f"{err_all:.4g} (|logit| max {cpu_lg.abs().max().item():.3g}); loss "
        f"card {float(card_loss):.6f} CPU {float(cpu_loss):.6f} err "
        f"{loss_err:.3g} (tol {LOSS_TOL}); CPU forward+loss {cpu_s:.1f} s")
    require(err_last <= LOGIT_TOL, f"card vs CPU last logits {err_last}")
    require(loss_err <= LOSS_TOL, f"card vs CPU loss {loss_err}")
    return sum(counts)


def phi3_forward_phase(dev) -> int:
    """phi3-medium-14b at full width (40 layers, random weights from seed
    0): one counted, timed forward_logits at B=1, S=4096, then one under
    torch.profiler.  Returns the flash_attention launches the counted run
    read."""
    cfg = get_config("phi3-medium-14b")
    n = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s, init_gib = (time.perf_counter() - t0,
                        torch.cuda.max_memory_allocated() / 2 ** 30)
    model = make_model(cfg, device=dev)
    toks = torch.tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 4096)), dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, wall, got = _counted(
            lambda: model.forward_logits(params, toks),
            {"flash_attention": n}, "phi3 forward_logits")
        finite = bool(torch.isfinite(logits).all())
        require(tuple(logits.shape) == (1, 4096, cfg.vocab_size) and finite,
                f"phi3 forward_logits: {tuple(logits.shape)}, finite "
                f"{finite}")
        del logits
        log(f"long forward phi3-medium-14b x{n} B=1 S=4096: init "
            f"{init_s:.1f} s (peak {init_gib:.1f} GiB); forward_logits "
            f"wall_ms={wall * 1e3:.2f} tok_s={4096 / wall:.0f} (first call, "
            f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB), "
            f"{n} flash_attention launches, finite logits")
        _kernel_profile("phi3-medium-14b forward_logits B=1 S=4096",
                        lambda: model.forward_logits(params, toks),
                        "flash_attention", n)
    del params
    torch.cuda.empty_cache()
    return got["flash_attention"]


def model_phase(kind: str, cfg=None, note: str = "",
                gated: bool = True) -> None:
    """Same weights on card and CPU, on a bf16 page arena ("paged") or
    dense slot rows ("dense"): prefill two prompts, then 8 decode steps
    fed the same tokens on both; then 8 fused greedy steps.  `cfg`:
    smollm-135m unless given; `note` says how a given one was cut.
    gated=False logs the error without requiring LOGIT_TOL, beside the
    CPU's own spread: the same CPU run once more on one thread (another
    summation order of its bf16 products), and that run's distance from
    the first."""
    cfg = cfg or get_config("smollm-135m")
    ps, maxp, steps = 16, 6, 8
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 37)]
    gpu_params = init_params(cfg, seed=0, device="cuda")
    cpu_params = {k: _to(v, "cpu") for k, v in gpu_params.items()}
    runs = {}
    for name in ("cpu", "cuda"):
        params = gpu_params if name == "cuda" else cpu_params
        model = make_model(cfg, device=name)
        with torch.no_grad():
            runs[name] = _model_run(model, params, prompts, ps, maxp, steps,
                                    runs.get("cpu"), kind)
    del gpu_params
    cpu, gpu = runs["cpu"], runs["cuda"]
    errs = [(g - c).abs().max().item() for c, g in zip(cpu["logits"],
                                                       gpu["logits"])]
    scale = max(c.abs().max().item() for c in cpu["logits"])
    match = (cpu["block"] == gpu["block"]).float().mean().item()
    spread = ""
    if not gated:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        with torch.no_grad():
            one = _model_run(make_model(cfg, device="cpu"), cpu_params,
                             prompts, ps, maxp, steps, cpu, kind)
        torch.set_num_threads(threads)
        own = max((a - b).abs().max().item()
                  for a, b in zip(cpu["logits"], one["logits"]))
        spread = (f" (logged, not gated; the CPU on 1 thread vs on "
                  f"{threads}: {own:.4g})")
    del cpu_params
    log(f"model {cfg.name}{note} {kind} cache, prefill+{steps} decode "
        f"steps, card vs CPU: max_abs_logit_err={max(errs):.4g} (tol {LOGIT_TOL}, "
        f"|logit| max {scale:.3g}){spread} per step="
        f"{['%.3g' % e for e in errs]} fused {steps}-step token match="
        f"{match:.3f}; {_first_divergence(cpu, gpu)}")
    require(not gated or max(errs) <= LOGIT_TOL,
            f"{cfg.name} {kind}: card vs CPU logits: {errs}")


def card_model_phase(kind: str) -> None:
    """model_phase's card half alone on dense slot rows ("dense") or an
    int8 arena ("int8"), whose CPU halves are cut for chip time (the gate
    phase holds both caches card vs CPU on the fitted model): smollm-135m
    prefills two prompts and runs 8 decode steps, then 8 fused greedy
    steps, all logits finite; on the int8 arena kv_quantize of the card's
    K/V rows must equal the CPU's of the same rows bit for bit."""
    cfg = get_config("smollm-135m")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (21, 37)]
    params = init_params(cfg, seed=0, device="cuda")
    with torch.no_grad():
        run = _model_run(make_model(cfg, device="cuda"), params, prompts,
                         16, 6, 8, None, kind)
    require(all(bool(torch.isfinite(lg).all()) for lg in run["logits"]),
            f"model {kind}: logits not finite")
    log(f"model {cfg.name} {kind} cache (card only), prefill+8 decode "
        f"steps: finite logits, |logit| max "
        f"{max(lg.abs().max().item() for lg in run['logits']):.3g}")
    if kind == "int8":
        rows = run["kv_rows"]
        same = [torch.equal(a.cpu(), b) for x in rows
                for a, b in zip(quant.kv_quantize(x),
                                quant.kv_quantize(x.cpu()))]
        log(f"model: kv_quantize of {sum(x[..., 0].numel() for x in rows)} "
            f"K/V rows, card == CPU bit for bit: {all(same)}")
        require(all(same), "kv_quantize differs between card and CPU")


def _first_divergence(cpu: dict, gpu: dict) -> str:
    """Where the fused greedy chains of card and CPU first part, lane by
    lane.  A chain is the prefill's argmax, then the fused block.  Up to
    its first difference a lane saw the same inputs on both devices as
    in the teacher-fed steps, so step t's logits there are the ones that
    chose the differing token: the CPU's gap between its top two logits
    is set beside the card's largest logit error at that step.  A gap
    below that error is a tie the summation order may break either way."""
    chain = {n: torch.cat([r["logits"][0].argmax(-1)[None].to(torch.int32),
                           r["block"]]) for n, r in (("cpu", cpu),
                                                     ("gpu", gpu))}
    parts = []
    for lane in range(chain["cpu"].shape[1]):
        differ = (chain["cpu"][:, lane] != chain["gpu"][:, lane]).nonzero()
        if not len(differ):
            parts.append(f"lane {lane}: no divergence")
            continue
        t = int(differ[0])
        c, g = cpu["logits"][t][lane], gpu["logits"][t][lane]
        top2 = c.topk(2).values
        parts.append(
            f"lane {lane}: first differs at step {t} (CPU token "
            f"{int(chain['cpu'][t, lane])}, card {int(chain['gpu'][t, lane])};"
            f" CPU teacher-fed argmax {int(c.argmax())}, card "
            f"{int(g.argmax())}): CPU top-2 gap {float(top2[0] - top2[1]):.4g}"
            f", card logit err {float((g - c).abs().max()):.4g}")
    return "; ".join(parts)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):  # LNParams
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev)


def _admitted(model, params, prompts, ps, maxp, kind, out=None):
    """Each prompt prefilled at its page-rounded bucket and admitted into
    its lane of a `kind` cache ("paged", "int8" or "dense"), lane i owning
    pages 1 + i * maxp ... (maxp of them).  Returns (cache, the prefills'
    last logits (B, V)); `out` gets the last prompt's K/V rows."""
    dev = model.device
    b = len(prompts)
    if kind == "dense":
        big = model.init_cache(b, maxp * ps)
    else:
        big = model.init_paged_cache(
            b, 1 + b * maxp, ps, maxp,
            kv_dtype="int8" if kind == "int8" else "bf16")
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
        if out is not None and "k" in small["scan"].get("b0", {}):
            out["kv_rows"] = [small["scan"]["b0"][n] for n in ("k", "v")]
        if kind == "dense":
            model.insert_prefill_cache(big, small, i)
        else:
            pages = np.arange(1 + i * maxp, 1 + (i + 1) * maxp,
                              dtype=np.int32)
            model.admit_lane_cache(big, i, pages, len(p), pages,
                                   small=small,
                                   write_pages=pages[:bucket // ps])
        logits.append(lg[0])
    return big, torch.stack(logits)


def _model_run(model, params, prompts, ps, maxp, steps, teacher, kind):
    """Prefill each prompt into its lane of a `kind` cache, then decode.
    The per-step input tokens come from `teacher` (the CPU run) when
    given, so both devices see the same inputs."""
    dev = model.device
    b = len(prompts)
    out = {"tokens": []}

    def admitted():
        return _admitted(model, params, prompts, ps, maxp, kind, out)

    big, lg = admitted()
    out["logits"] = [lg.float().cpu()]
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


# ---------------------------------------------------------------------------
# the fitted instrument: fit, card stream gate, speculative decoding
# ---------------------------------------------------------------------------


def fit_phase(dev) -> dict:
    """`fit_affine_lm` on the card: reduced smollm-135m at its defaults
    (1,000 Adam steps), then, at DRAFT_FIT_STEPS, a 1-layer draft on the
    clean corpus and one with disagree_every=3.  Each logs its seconds, its loss on a held-out
    batch of its own corpus and its greedy accuracy on 64 affine prompts.
    Returns {name: (model, params)}."""
    cfg = get_config("smollm-135m").reduced()
    dcfg = dataclasses.replace(cfg, name=cfg.name + "-draft", n_layers=1)
    steps = {"target": 1000, "draft": DRAFT_FIT_STEPS,
             "draft_disagree3": DRAFT_FIT_STEPS}
    prompts = synthetic.affine_prompts(np.random.default_rng(123), 64,
                                       cfg.vocab_size)
    fits = {}
    for name, c, every in (("target", cfg, 0), ("draft", dcfg, 0),
                           ("draft_disagree3", dcfg, 3)):
        model = make_model(c, device=dev)
        t0 = time.perf_counter()
        params = synthetic.fit_affine_lm(model, steps=steps[name],
                                         disagree_every=every)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        toks, labels = synthetic.affine_batch(
            np.random.default_rng(99), c.vocab_size, disagree_every=every,
            device=dev)
        with torch.no_grad():
            loss = float(model.loss(params, {"tokens": toks,
                                             "labels": labels}))
        acc = synthetic.greedy_accuracy(model, params, prompts)
        require(np.isfinite(loss), f"fit {c.name}: loss {loss}")
        log(f"fit {c.name} (x{c.n_layers}, vocab {c.vocab_size}) "
            f"disagree_every={every}: {steps[name]} steps in {secs:.1f} s, "
            f"held-out loss={loss:.5f}, greedy accuracy on 64 affine "
            f"prompts={acc:.4f}")
        fits[name] = (model, params)
    return fits


def gate_phase(model, params, kind: str) -> dict:
    """The card's greedy streams against the CPU's on the fitted weights:
    8 affine prompts admitted into a `kind` cache, 16 teacher-fed decode
    steps, then 16 fused greedy steps on each device; the fused blocks
    must agree at every token.  Returns the decode kernel's launches."""
    cfg = model.cfg
    ps, maxp, steps = 16, 3, 16
    prompts = synthetic.affine_prompts(np.random.default_rng(7), 8,
                                       cfg.vocab_size)
    kernel = {"paged": "paged_flash_decode", "int8": "paged_flash_decode_q",
              "dense": "flash_decode"}[kind]
    n = _attn_layers(cfg) * 2 * steps
    with torch.no_grad():
        cpu = _model_run(make_model(cfg, device="cpu"), _to(params, "cpu"),
                         prompts, ps, maxp, steps, None, kind)
        gpu, _, got = _counted(
            lambda: _model_run(model, params, prompts, ps, maxp, steps, cpu,
                               kind), {kernel: n}, f"gate {kind}")
    match = (cpu["block"] == gpu["block"]).float().mean().item()
    errs = [(g - c).abs().max().item() for c, g in zip(cpu["logits"],
                                                       gpu["logits"])]
    log(f"gate {cfg.name} fitted, {kind} cache, B={len(prompts)}, card vs "
        f"CPU: fused {steps}-step greedy token match={match:.4f} (want "
        f"1.0), teacher-fed max_abs_logit_err={max(errs):.4g}, "
        f"{kernel} launches={got[kernel]}; {_first_divergence(cpu, gpu)}")
    require(match == 1.0, f"gate {kind}: card and CPU greedy streams part")
    return {kernel: got[kernel]}


def fit_worker(out_dir: str) -> None:
    """The reduced fits of FITTED_GATES, one after another on the card, in
    a process of their own (`chip_smoke.py --fit-worker DIR`): each is
    saved, with its log line, to DIR/<arch>.pt (written whole, then
    renamed into place) for the fitted phase to gate."""
    dev = torch.device("cuda")
    prompts = None
    for arch, steps, _ in FITTED_GATES:
        cfg = get_config(arch).reduced()
        model = make_model(cfg, device=dev)
        t0 = time.perf_counter()
        params = synthetic.fit_affine_lm(model, steps=steps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if prompts is None:
            prompts = synthetic.affine_prompts(np.random.default_rng(123),
                                               64, cfg.vocab_size)
        acc = synthetic.greedy_accuracy(model, params, prompts)
        kind = (f"{cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts
                else cfg.family)
        line = (f"fit {cfg.name} (x{cfg.n_layers}, {kind}, {cfg.norm}, "
                f"{cfg.act}, {cfg.mlp_style}): {steps} steps in {secs:.1f} "
                f"s in the fit worker, greedy accuracy on 64 affine prompts="
                f"{acc:.4f}")
        path = os.path.join(out_dir, f"{arch}.pt")
        torch.save({"params": _to(params, "cpu"), "line": line},
                   path + ".part")
        os.replace(path + ".part", path)
        print(line, flush=True)
        del model, params
        torch.cuda.empty_cache()


class FitWorker:
    """The fit worker process and the directory it saves into."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_fits_")
        self.log = os.path.join(self.dir, "worker.log")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--fit-worker",
                 self.dir], stdout=out, stderr=subprocess.STDOUT)
        self.t0 = time.perf_counter()
        log(f"fit worker started (pid {self.proc.pid}): "
            f"{', '.join(a for a, _, _ in FITTED_GATES)}")

    def fitted(self, arch: str, dev):
        """The worker's fitted params for `arch` on `dev` and its log line,
        once it has saved them; fails if the worker ends without them."""
        path = os.path.join(self.dir, f"{arch}.pt")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            code = self.proc.poll()
            if code is not None and not os.path.exists(path):
                with open(self.log) as f:
                    tail = f.read()[-4000:]
                require(False, f"fit worker exited {code} before {arch} "
                        f"was fitted:\n{tail}")
            require(time.perf_counter() - t0 < FIT_WAIT_S,
                    f"fit worker: no {arch} fit after {FIT_WAIT_S} s")
            time.sleep(0.5)
        waited = time.perf_counter() - t0
        saved = torch.load(path, map_location=dev)
        return saved["params"], saved["line"], waited

    def close(self) -> None:
        """Stop the worker if it still runs (a phase failed before the
        fitted phase waited for it) and remove its directory."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def fitted_phase(dev, worker: FitWorker) -> dict:
    """The card-vs-CPU stream gates on the worker's reduced fits
    (FITTED_GATES): each loaded on the card and gated at token match 1.0
    on its cache kind (gate_phase).  Returns the decode kernels'
    launches."""
    launches = {}
    for arch, _, kind in FITTED_GATES:
        params, line, waited = worker.fitted(arch, dev)
        log(f"{line} (waited {waited:.1f} s for it)")
        model = make_model(get_config(arch).reduced(), device=dev)
        for k, v in gate_phase(model, params, kind).items():
            launches[k] = launches.get(k, 0) + v
        del model, params
    code = worker.proc.wait(timeout=60)
    require(code == 0, f"fit worker exited {code}")
    log(f"fit worker: all {len(FITTED_GATES)} fits in "
        f"{time.perf_counter() - worker.t0:.1f} s of wall time")
    return launches


def _spec_requests(vocab: int, seed: int = 0):
    """16 affine requests, then 8 that share a 32-token affine prefix (a
    prefix hit whose draft lane ingests the forced suffix); budgets
    8-32."""
    rng = np.random.default_rng(seed)
    prompts = synthetic.affine_prompts(rng, 16, vocab, (4, 30))
    prefix = synthetic.affine_prompts(rng, 1, vocab, (32, 33))[0]
    prompts += [np.concatenate([prefix, s]).astype(np.int32) for s in
                synthetic.affine_prompts(rng, 8, vocab, (3, 9))]
    return [(p, int(rng.integers(8, 33))) for p in prompts]


class _LaneTally:
    """Records the lane count of every paged decode-kernel call while
    installed (a pass-through around the wrappers, which count the
    launches themselves): B lanes for a decode step, B * (k+1) for a
    verify pass."""

    names = ("paged_flash_decode", "paged_flash_decode_q")

    def __enter__(self):
        self.lanes = {n: [] for n in self.names}
        self.orig = {n: getattr(ops, n) for n in self.names}
        for n in self.names:
            def call(q, *a, _n=n, **k):
                # under a serve plan the wrapper is called with the
                # shards' queries, then once per shard with each's
                self.lanes[_n].append((q[0] if isinstance(q, list)
                                       else q).shape[0])
                return self.orig[_n](q, *a, **k)
            setattr(ops, n, call)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(ops, n, f)


def _serve_requests(model, params, requests, kv_dtype, spec=None,
                    num_pages=SPEC_PAGES, plan=None):
    """The paged cb engine at B=8 on `requests` (FIFO, all at t=0) over
    `num_pages` pages (None: room for every lane), under `plan` when
    given, with the launch counts set to 0 just before; returns (streams,
    engine, wall seconds, launch counts, kernel lane tally)."""
    eng = ContinuousBatchingEngine(model, params, max_batch=8,
                                   buckets=serve_cli.BUCKETS,
                                   deadline_s=0.0, max_decode_len=40,
                                   num_pages=num_pages, kv_dtype=kv_dtype,
                                   spec_config=spec, plan=plan)
    for i, (p, b) in enumerate(requests):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=b))
    torch.cuda.synchronize()
    ops.reset_launches()
    with _LaneTally() as tally:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = {k: ops.launches[k] for k in ATTN_KERNELS}
    require(len(done) == len(requests) and all(
        r.done and len(r.tokens_out) == b
        for r, (_, b) in zip(done, requests)),
        "spec phase: a request stopped short of its budget")
    return [r.tokens_out for r in done], eng, wall, got, tally.lanes


def _spec_run(label, model, params, requests, kv_dtype, draft, dparams,
              plain_toks, plain_wall, num_pages=SPEC_PAGES) -> dict:
    """One speculative engine run against the plain engine's streams,
    which it must equal: tok/s, acceptance, dispatches, catch-up, and the
    route kernel's launches split into verify passes (B * (k+1) lanes;
    one per target layer per spec dispatch, the warm-up's one per ladder
    depth included) and single-query steps (B lanes: the target's plain
    decode steps, the draft's steps).  `plain_wall` None: the plain
    streams came from another run.  Returns (the route kernel's launches,
    the engine's stats)."""
    kernel = ("paged_flash_decode_q" if kv_dtype == "int8"
              else "paged_flash_decode")
    spec = dict(draft_model=draft, draft_params=dparams, spec_k=SPEC_K)
    toks, eng, wall, got, lanes = _serve_requests(
        model, params, requests, kv_dtype, spec, num_pages)
    s, b = eng.stats, eng.max_batch
    verify = sum(1 for n in lanes[kernel] if n > b)
    single = sum(1 for n in lanes[kernel] if n == b)
    ladder = eng.sched.spec_ladder
    n_tgt, n_dft = model.cfg.n_layers, draft.cfg.n_layers
    plain_steps = s["decode_steps"] - s["spec_draft_steps"]
    least_single = (n_tgt * plain_steps + n_dft * (
        s["spec_draft_steps"] + sum(k + 1 for k in ladder)))
    require(got[kernel] == len(lanes[kernel]) == verify + single
            and not any(v for k, v in got.items() if k != kernel),
            f"spec {label}: launches {got}, tally {len(lanes[kernel])}")
    require(verify == n_tgt * (s["spec_dispatches"] + len(ladder)),
            f"spec {label}: {verify} verify launches, want {n_tgt} x "
            f"({s['spec_dispatches']} dispatches + {len(ladder)} warm)")
    require(single >= least_single, f"spec {label}: {single} single-query "
            f"launches < {least_single}")
    ntok = sum(len(t) for t in toks)
    same = sum(int(a == c) for x, y in zip(toks, plain_toks)
               for a, c in zip(x, y))
    acc = s["spec_accepted"] / max(s["spec_proposed"], 1)
    plain_tok_s = "n/a" if plain_wall is None else f"{ntok / plain_wall:.1f}"
    log(f"spec {label} kv={kv_dtype} spec_k={SPEC_K} B={b}: requests="
        f"{len(toks)} tokens={ntok} wall_s={wall:.4f} tok_s={ntok / wall:.1f}"
        f" (plain engine {plain_tok_s}) token match vs plain="
        f"{same / ntok:.4f} acceptance={acc:.4f} ({s['spec_accepted']}/"
        f"{s['spec_proposed']}) spec_dispatches={s['spec_dispatches']} "
        f"decode_dispatches={s['decode_dispatches']} spec_catchup_tokens="
        f"{s['spec_catchup_tokens']} spec_draft_prefills="
        f"{s['spec_draft_prefills']} prefix_hits={s['prefix_hits']} "
        f"preemptions={s['preemptions']} "
        f"{kernel} launches={got[kernel]}: verify={verify} (lanes "
        f"{sorted(set(n for n in lanes[kernel] if n > b))}) single-query="
        f"{single}")
    require(toks == plain_toks, f"spec {label} kv={kv_dtype}: streams "
            "differ from the plain engine's")
    return {kernel: got[kernel]}, s


def _verify_vs_chained(model, params, kind: str, seed: int) -> tuple:
    """One verify block (T = SPEC_K + 1) after 8 admitted prompts, against
    T chained decode_step calls from an identical cache: the largest
    |logit difference|, and the chained run's top-2 gap at the first row
    that differs (None where every row is equal bit for bit)."""
    cfg = model.cfg
    ps, maxp, t = 16, 4, SPEC_K + 1
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(6, 40, 8)]
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (8, t)),
                          dtype=torch.int32, device=model.device)
    with torch.no_grad():
        cache, _ = _admitted(model, params, prompts, ps, maxp, kind)
        steps = []
        for j in range(t):
            lg, cache = model.decode_step(params, cache, tokens[:, j])
            steps.append(lg)
        chained = torch.stack(steps, 1)
        cache, _ = _admitted(model, params, prompts, ps, maxp, kind)
        ver, _ = model.verify_block(params, cache, tokens)
    diff = (ver - chained).abs()
    differ = diff.amax(-1) > 0
    if not bool(differ.any()):
        return 0.0, None
    top2 = chained.topk(2, dim=-1).values
    return float(diff.max()), float((top2[..., 0] - top2[..., 1])[differ][0])


def spec_phase(dev, fits: dict) -> dict:
    """Speculative serving on the card through the paged cb engine
    (spec_k 4, B=8): the fitted reduced target with its clean and its
    disagreeing draft, on bf16 and int8 arenas, each stream required to
    equal the plain engine's on the same requests; then smollm-135m at
    full width on init_params weights drafting for itself (acceptance
    1.0 but for blocks cut short by a budget), in a pool with room for
    every lane, its streams required to equal the plain engine's.  The
    verify block must equal its chained decode steps bit for bit, on the
    reduced target and at full width (the row norm sums a row in an order
    fixed by its width, whatever the row count).  Returns the paged
    kernels' launches."""
    launches = dict.fromkeys(ATTN_KERNELS, 0)

    def add(d):
        for k, v in d.items():
            launches[k] += v

    model, params = fits["target"]
    requests = _spec_requests(model.cfg.vocab_size)
    _serve_requests(model, params, requests[:4], "bf16")  # process warm-up
    for kind in ("paged", "int8"):
        d, _ = _verify_vs_chained(model, params, kind, 1)
        log(f"spec {model.cfg.name} {kind}: max |verify_block - {SPEC_K + 1}"
            f" chained decode_step| logits = {d:.4g}")
        require(d == 0, f"spec {kind}: the verify pass parts from the "
                "chained decode steps")
    for kv in ("bf16", "int8"):
        toks, _, wall, got, _ = _serve_requests(model, params, requests, kv)
        add(got)
        for name in ("draft", "draft_disagree3"):
            add(_spec_run(f"{model.cfg.name} {name}", model, params,
                          requests, kv, *fits[name], toks, wall)[0])
    cfg = get_config("smollm-135m")
    model = make_model(cfg, device=dev)
    params = init_params(cfg, seed=0, device=dev)
    args = serve_cli.parse_args(["--requests", "16", "--max-new", "32",
                                 "--seed", "0"])
    requests = [(r.prompt, r.max_new_tokens) for r in
                serve_cli.make_stream(args, cfg.vocab_size, args.seed)]
    d, gap = _verify_vs_chained(model, params, "paged", 2)
    log(f"spec smollm-135m full width, init_params: max |verify_block - "
        f"{SPEC_K + 1} chained decode_step| logits = {d:.4g} (chained top-2 "
        f"gap at the first differing row: {gap})")
    require(d == 0, "spec smollm-135m full width: the verify pass parts "
            "from the chained decode steps")
    # a pool with room for every lane: on random weights a preempted
    # request's re-prefill may break a near-tie otherwise than the decode
    # steps it replaces, in either engine, whatever the verify pass does
    toks, _, wall, got, _ = _serve_requests(model, params, requests, "bf16",
                                            num_pages=None)
    add(got)
    add(_spec_run("smollm-135m self-draft", model, params, requests, "bf16",
                  model, params, toks, wall, num_pages=None)[0])
    return launches


# ---------------------------------------------------------------------------
# the attention-only families
# ---------------------------------------------------------------------------


def family_serve(model, params, seed: int, phase: str = "families") -> dict:
    """8 Poisson requests of 32 new tokens through the paged bf16 cb
    engine, the launch counts set to 0 just before and read just after:
    paged_flash_decode once per layer per fused decode step and no other
    attention kernel, row_norm 2 per layer and 1 per backbone call.
    Returns those two kernels' launches."""
    cfg = model.cfg
    args = serve_cli.parse_args(["--requests", "8", "--max-new", "32",
                                 "--seed", str(seed)])
    eng = ContinuousBatchingEngine(model, params, max_batch=8,
                                   buckets=serve_cli.BUCKETS)
    for r in serve_cli.make_stream(args, cfg.vocab_size, args.seed):
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: ops.launches[k] for k in ATTN_KERNELS}
    norms, steps = ops.launches["row_norm"], eng.stats["decode_steps"]
    what = f"{phase} {cfg.name} x{cfg.n_layers} serve"
    require(len(done) == 8 and all(
        r.done and (len(r.tokens_out) == r.max_new_tokens
                    or r.tokens_out[-1] == r.eos_id) for r in done),
        f"{what}: a request stopped short of its budget")
    want = {k: cfg.n_layers * steps if k == "paged_flash_decode" else 0
            for k in ATTN_KERNELS}
    require(got == want, f"{what}: launches {got} != {want}")
    _require_norms(what, norms, eng)
    toks = sum(len(r.tokens_out) for r in done)
    log(f"{what} cb paged bf16 poisson x8 (B=8, max_new 32): tokens={toks} "
        f"wall_s={wall:.4f} tok_s={toks / wall:.1f} decode_steps={steps} "
        f"paged_flash_decode_launches={got['paged_flash_decode']} (= "
        f"{cfg.n_layers} x {steps}) row_norm_launches={norms} "
        f"prefills={eng.stats['prefills']}")
    return {"paged_flash_decode": got["paged_flash_decode"], "row_norm": norms}


def _gemm_rows(params, tied: bool) -> str:
    """Which of a model's products would give a row other bits among 40
    rows, a verify pass (B=8 x T=5), than among 8, a decode step, on
    torch.matmul (cuBLAS), the reason the served products run on the
    K-ordered gemm: layer 0's weights and the head, on seeded bf16 rows."""
    emb = params["embed"]
    ws = {f"{blk} {k}": v[0] for blk in ("mix", "ffn")
          for k, v in params["scan"]["b0"][blk].items()}
    ws["head"] = emb["tok"].t() if tied else emb["head"]
    gen = torch.Generator(device=emb["tok"].device).manual_seed(0)
    parts = []
    for name, w in ws.items():
        x = torch.randn((8, SPEC_K + 1, w.shape[0]), generator=gen,
                        device=w.device).to(w.dtype)
        y = torch.matmul(x, w)
        bad = sum(int((torch.matmul(x[:, j:j + 1].contiguous(), w)[:, 0]
                       != y[:, j]).sum()) for j in range(SPEC_K + 1))
        parts.append(f"{name} {w.shape[0]}x{w.shape[1]}: {bad} of "
                     f"{y.numel()}")
    return "; ".join(parts)


def families_phase(dev) -> dict:
    """The attention-only families on the card, each at full width: card
    vs CPU on 2 of its layers (model_phase, paged); then served through
    the paged cb engine at full depth (deepseek-coder-33b at FAMILY_LAYERS'
    depth) and its verify block required equal to its chained decode
    steps (d = 0; logged beside the products whose rows would part
    between one 40-row product and 8-row ones).  Returns the paged
    kernel's and row_norm's launches."""
    launches = {"paged_flash_decode": 0, "row_norm": 0}
    for i, arch in enumerate(FAMILIES):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model_phase("paged", dataclasses.replace(cfg, n_layers=2),
                    note=f" (full width, depth cut to 2 of {cfg.n_layers} "
                    "layers)")
        n = FAMILY_LAYERS.get(arch, cfg.n_layers)
        cut = dataclasses.replace(cfg, n_layers=n)
        depth = f"x{n}" + (f" (depth cut from {cfg.n_layers})"
                           if n != cfg.n_layers else "")
        torch.cuda.reset_peak_memory_stats()
        model = make_model(cut, device=dev)
        params = init_params(cut, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"families {arch} {depth}: {cut.param_count() / 1e9:.3f} B "
            f"parameters, init peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        for k, v in family_serve(model, params, i).items():
            launches[k] += v
        d, gap = _verify_vs_chained(model, params, "paged", 2)
        log(f"families {arch} {depth}: max |verify_block - {SPEC_K + 1} "
            f"chained decode_step| logits = {d:.4g} (chained top-2 gap at "
            f"the first differing row: {gap}); torch.matmul's outputs that "
            f"differ between one (40, D) product and five 8-row ones, which "
            f"the verify pass's K-ordered gemm products do not part, per "
            f"product: {_gemm_rows(params, cfg.tie_embeddings)}")
        require(d == 0, f"families {arch}: the verify pass parts from the "
                "chained decode steps")
        del model, params
        torch.cuda.empty_cache()
        log(f"families {arch}: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the recurrent families
# ---------------------------------------------------------------------------


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def _quantized_leaves(tree) -> int:
    if is_quantized(tree):
        return 1
    if isinstance(tree, dict):
        return sum(_quantized_leaves(v) for v in tree.values())
    return 0


def recurrent_serve(model, params, seed: int, quant: bool) -> dict:
    """8 Poisson requests of 32 new tokens through the dense-slot cb
    engine (the only route these models have), the launch counts set to 0
    just before and read just after: flash_decode once per attention
    layer per fused decode step and no other attention kernel,
    int8_matmul once per quantized projection per backbone call (W8A8),
    row_norm `_norms_per_call` per backbone call.  Returns the three
    kernels' launches."""
    cfg = model.cfg
    args = serve_cli.parse_args(["--requests", "8", "--max-new", "32",
                                 "--seed", str(seed)])
    eng = ContinuousBatchingEngine(model, params, max_batch=8,
                                   buckets=serve_cli.BUCKETS,
                                   quant_weights=quant)
    require(not eng.paged, f"{cfg.name}: took the paged route")
    n_q = _quantized_leaves(eng.executor.params)
    for r in serve_cli.make_stream(args, cfg.vocab_size, args.seed):
        eng.submit(r)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats
    calls = s["decode_steps"] + s["prefills"]
    what = (f"recurrent {cfg.name} x{cfg.n_layers} serve "
            f"{'W8A8' if quant else 'bf16'}")
    require(len(done) == 8 and all(
        r.done and (len(r.tokens_out) == r.max_new_tokens
                    or r.tokens_out[-1] == r.eos_id) for r in done),
        f"{what}: a request stopped short of its budget")
    got = {k: ops.launches[k] for k in ATTN_KERNELS}
    want = {k: _attn_layers(cfg) * s["decode_steps"]
            if k == "flash_decode" else 0 for k in ATTN_KERNELS}
    require(got == want, f"{what}: launches {got} != {want}")
    i8, norms = ops.launches["int8_matmul"], ops.launches["row_norm"]
    require((n_q > 0) == quant and i8 == n_q * calls,
            f"{what}: {i8} int8_matmul launches, want {n_q} quantized "
            f"products x {calls} backbone calls")
    _require_norms(what, norms, eng)
    toks = sum(len(r.tokens_out) for r in done)
    log(f"{what} cb dense poisson x8 (B=8, max_new 32): tokens={toks} "
        f"wall_s={wall:.4f} tok_s={toks / wall:.1f} "
        f"decode_steps={s['decode_steps']} prefills={s['prefills']} "
        f"flash_decode_launches={got['flash_decode']} (= "
        f"{_attn_layers(cfg)} x {s['decode_steps']}) "
        f"int8_matmul_launches={i8} (= {n_q} x {calls}) "
        f"row_norm_launches={norms} (= {_norms_per_call(cfg)} x {calls}) "
        f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2 ** 30:.2f}")
    return {"flash_decode": got["flash_decode"], "int8_matmul": i8,
            "row_norm": norms}


def _recurrent_profile(model, params) -> None:
    """8 fused decode steps over 8 admitted prompts on dense slot rows,
    warm, under torch.profiler: the device's busy share, device ops per
    step and one kernel's share of device time (flash_decode; xlstm has
    none, so row_norm).  At these models' event rates (30-40 thousand
    device ops a second) the profiler can lose a few events (12,427 and
    12,459 ops recorded for the same recurrentgemma window in two runs on
    an H100), so the kernel's spans are required present and at most its
    launches, and both counts are logged."""
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(8, 60, 8)]
    act = torch.ones((8,), dtype=torch.bool, device=model.device)
    what = (f"recurrent {cfg.name} x{cfg.n_layers} 8 fused decode steps "
            "(B=8, dense slots)")
    with torch.no_grad():
        big, lg = _admitted(model, params, prompts, 16, 12, "dense")
        first = lg.argmax(-1).to(torch.int32)
        model.decode_steps(params, big, first, act, 8)  # warm
        big, lg = _admitted(model, params, prompts, 16, 12, "dense")
        n_attn = _attn_layers(cfg)
        kernel, n = (("flash_decode", n_attn * 8) if n_attn else
                     ("row_norm", _norms_per_call(cfg) * 8))
        spans, wall_us = _device_spans(
            lambda: model.decode_steps(params, big, first, act, 8))
    if not spans:
        log(f"profile {what}: the profiler recorded no device time (not "
            "measured)")
        return
    dev_total = sum(e - s for s, e, _ in spans)
    ks = [e - s for s, e, name in spans if f"{kernel}_kernel" in name]
    require(0 < len(ks) <= n, f"profile {what}: {len(ks)} {kernel} kernel "
            f"spans, {n} launches")
    log(f"profile {what}: wall_ms={wall_us / 1e3:.2f} "
        f"device_busy_share={_busy_us(spans) / wall_us:.4f} "
        f"device_kernel_ms={dev_total / 1e3:.3f} {kernel}_ms="
        f"{sum(ks) / 1e3:.3f} ({len(ks)} spans of {n} launches) "
        f"{kernel}_share_of_device={sum(ks) / dev_total:.4f} "
        f"device_ops={len(spans)}")


def _dense_state(ex, cfg, b: int, seed: int) -> dict:
    """A dense-slot decode state of `b` admitted lanes (prompts of 5 + 7i
    tokens, budget 64) on a drained-pipeline executor."""
    st = ex.fresh_state(ex.init_caches(False), paged=False)
    rng = np.random.default_rng(seed)
    for sl in range(b):
        p = rng.integers(0, cfg.vocab_size, 5 + 7 * sl).astype(np.int32)
        lg, small = ex.prefill_prompts([p], 1, bucket_cache=True)
        st["caches"] = ex.insert(st["caches"], small, sl)
        ex.admit_lane(st, sl, int(lg[0].argmax()), -1, 64)
    return st


def _stage_rows_probe(model, params, st, what: str) -> None:
    """The hazard a stage's rows meet, on the first layer period of an
    admitted dense state: each block on lanes 2-3 of the 12 (a stage's
    microbatch), its input the 12-lane call's output at those rows, run
    as the rows alone (cuBLAS's products at 2 rows) and at one device's
    12 lanes (`block_apply`'s ``lanes``), each against the 12-lane call
    at those rows.  The rows alone are logged; ``lanes`` must give d =
    0."""
    from repro_torch.models.transformer import _index, block_apply
    cfg, rows = model.cfg, slice(2, 4)
    caches = _whole(st["caches"])
    pp, pc = _index(params["scan"], 0), _index(caches["scan"], 0)
    act, pos = st["active"], caches["pos"][:, None]
    h = model.embed_inputs(params, tokens=st["cur"][:, None])
    b, parts = h.shape[0], []
    with torch.no_grad():
        for j in range(len(pp)):
            def run(x, state, sl, lanes=None):
                return block_apply(cfg, j, pp[f"b{j}"], x, pos[sl], None,
                                   {k: v.clone() for k, v in state.items()},
                                   active=act[sl], lanes=lanes)[0]
            whole = slice(0, b)
            out = run(h, pc[f"b{j}"], whole)
            full = out[rows].float()
            alone = run(h[rows], {k: v[rows] for k, v in pc[f"b{j}"].items()},
                        rows)
            lanes = run(h[rows], pc[f"b{j}"], rows, (rows, b))
            d_alone = (alone.float() - full).abs().max().item()
            d_lanes = (lanes.float() - full).abs().max().item()
            parts.append(f"{cfg.block_kind(j)} {d_alone:.4g} / {d_lanes:g}")
            require(d_lanes == 0, f"{what}: block {j} on a stage's rows at "
                    f"{b} lanes parts from the {b}-lane call by {d_lanes:.4g}")
            h = out
    log(f"{what}: period 0's blocks on 2 of {b} lanes against the "
        f"full call, max |d| rows alone / at one device's lanes: "
        + "; ".join(parts))


def family_pipeline(model, params, skewed: bool) -> dict:
    """A recurrent or MoE model at full width on PLAN_STAGES stages of a
    serve_pipeline plan (every stage on the card; its blocks are views of
    the weights the phase already holds), B = PLAN_SKEW_B: drained on
    dense slot rows (6 microbatches of 2 lanes), or request-skewed on a
    paged bf16 arena (6 lane groups of 2; odd lanes with forced-token
    queues).  On one admitted state the loop's tokens and each lane's
    last-step logits equal `Model.decode_steps`' on the whole state bit
    for bit (d = 0); ticks steps x pipeline_steps(6, 6), or steps x 6 + 5;
    every kernel's launches the one-device run's a step, scaled: drained,
    the layers' x 6 and the final norm's and head's once (on all 12
    rows); skewed, all x 6 (the head runs per lane group).  One fused
    step of each profiled (wall ms and device ops a step beside one
    device's); a MoE model's expert bytes a step logged.  Returns the
    kernels' launches."""
    from repro_torch.core.pipeline import pipeline_steps
    cfg, b, steps, n = model.cfg, PLAN_SKEW_B, 8, PLAN_STAGES
    plan = build_plan(cfg, make_mesh((n,), ("stage",)),
                      mode="serve_pipeline", exact=not skewed)
    what = (f"pipeline {cfg.name} x{cfg.n_layers} {n} "
            + ("skewed stages, paged bf16" if skewed
               else "drained stages, dense slots") + f" (B={b})")
    if skewed:
        ex = Executor(model, params, max_batch=b, cache_len=16 * 12,
                      buckets=serve_cli.BUCKETS, plan=plan)
        st = _skew_state(model, ex, b, 16, 12, 15)
        kw = dict(forced=st["forced"], forced_len=st["flen"])
    else:
        ex = Executor(model, params, max_batch=b, cache_len=176,
                      buckets=serve_cli.BUCKETS, plan=plan)
        st = _dense_state(ex, cfg, b, 13)
        kw = {}
        _stage_rows_probe(model, params, st, what)
    per = layer_plan(cfg)[0] // n
    for blk in st["caches"]["scan"].values():
        for name, leaf in blk.items():
            require([t.shape[0] for t in leaf] == [per] * n,
                    f"{what}: {name} stage blocks "
                    f"{[t.shape[0] for t in leaf]}")

    def one(k, caches):
        extra = dict(kw, forced_ptr=st["fptr"].clone()) if skewed else {}
        with torch.no_grad():
            return model.decode_steps(
                params, caches, st["cur"].clone(), st["active"].clone(), k,
                eos_id=st["eos"], budget=st["budget"].clone(), pad_token=0,
                **extra)

    want, one_wall, one_n = _launched(lambda: one(steps, _whole(
        st["caches"])))
    pre = one(steps - 1, _whole(st["caches"]))
    with torch.no_grad():
        want_logits, _ = model.decode_step(params, pre[-1], pre[1],
                                           active=pre[2])
    del pre
    t0 = ex.pipeline_ticks
    got, wall, got_n = _launched(lambda: ex.decode(st, steps, paged=skewed))
    require(torch.equal(got, want[0]), f"{what}: tokens part from "
            "Model.decode_steps")
    d = (ex.logits - want_logits).abs().max().item()
    require(d == 0, f"{what}: last-step logits part from Model."
            f"decode_steps by {d:.4g}")
    ticks = ex.pipeline_ticks - t0
    want_ticks = (steps * n + n - 1 if skewed
                  else steps * pipeline_steps(n, n))
    require(ticks == want_ticks, f"{what}: {ticks} ticks != {want_ticks}")
    heads = {"row_norm": 1, "gemm": 1}  # the final norm and the head
    need = {}
    for k, c in one_n.items():
        require(c % steps == 0, f"{what}: one device's {k} launches {c} "
                f"over {steps} steps")
        per, head = c // steps, heads.get(k, 0) if c else 0
        need[k] = steps * (per * n if skewed else (per - head) * n + head)
    require(got_n == need, f"{what}: launches {got_n} != {need}")
    kernel = "paged_flash_decode" if skewed else "flash_decode"
    extra = ""
    if cfg.n_experts:
        n_moe = sum(map(cfg.is_moe_layer, range(cfg.n_layers)))
        nbytes = n_moe * cfg.n_experts * cfg.ffn_params() * 2
        extra = (f" expert_bytes_per_step={n * nbytes} (= {n} x {nbytes}, "
                 f"one device's: every {'lane group' if skewed else 'micro'}"
                 f"{'' if skewed else 'batch'}'s MoE call reads every "
                 "expert, the dense dispatch)")
    log(f"{what}: {steps} fused steps equal Model.decode_steps bit for bit "
        f"(tokens; last-step logits d = {d:g}); ticks {ticks}; launches a "
        f"step {kernel}={got_n.get(kernel, 0) // steps} row_norm="
        f"{got_n['row_norm'] // steps} gemm={got_n['gemm'] // steps} (one "
        f"device: {one_n.get(kernel, 0) // steps}, "
        f"{one_n['row_norm'] // steps}, {one_n['gemm'] // steps}); "
        f"wall_ms_per_step={wall * 1e3 / steps:.2f} (one device "
        f"{one_wall * 1e3 / steps:.2f}){extra}")
    _route_profile(f"{what}, 1 fused step",
                   lambda: ex.decode(st, 1, paged=skewed), 1)
    whole = _whole(st["caches"])
    _route_profile(f"{what}: its state on one device, 1 fused step",
                   lambda: one(1, whole), 1)
    return {k: v for k, v in got_n.items() if v}


def _recurrent_plan_step(model, params, shape, exact: bool,
                         base=None, quant: bool = False) -> dict:
    """A recurrent model under a mode="serve" plan on `shape`, every
    shard on the card: one dense-slot state of 8 admitted lanes
    (`_dense_state`) through a one-device executor and through the
    plan's, each running 8 fused decode steps, then one more step fed
    the same tokens for its logits.  Exact: tokens and logits equal one
    device's (d = 0), and a step launches flash_decode once an attention
    layer (recurrentgemma's, whole on the controller), row_norm
    `_norms_per_call` and gemm and int8_matmul `_products_per_call`
    times, no other attention kernel; the placement's card memory, each
    route's wall ms a step and its device ops (profiled, 1 fused step)
    logged.  exact=False (`base`: the exact step's result): the token
    match and the logits' max |d| against it, logged.  quant: W8A8
    weights on both routes, each quantized MLP of the plan's placement
    (`layers.mlp` on its shards' blocks) equal to one device's bit for
    bit in either form.  Returns {"tokens", "logits", "launches"}."""
    cfg, steps = model.cfg, 8
    n = shape[1]
    form = ("exact" if exact else "no-exact") + (" W8A8" if quant else "")
    what = (f"recurrent plan serve {form} {cfg.name} x{cfg.n_layers} mesh "
            f"{shape}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    plan = build_plan(cfg, make_mesh(shape, ("data", "model")),
                      mode="serve", exact=exact)
    runs = {}
    for name, p in (("one device", None), ("plan", plan)):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        ex = Executor(model, params, max_batch=8, cache_len=176,
                      buckets=serve_cli.BUCKETS, plan=p, quant_weights=quant)
        if p is not None:
            torch.cuda.synchronize()
            placed = torch.cuda.memory_allocated() - held
            cut = [k for b in ex.params["scan"].values()
                   for k, v in b["mix"].items() if isinstance(v, list)]
            require(cut, f"{what}: no mixer leaf is cut")
            log(f"{what}: placement notes: " + "; ".join(ex.notes))
        st = _dense_state(ex, cfg, 8, 29)
        toks, wall, got = _launched(lambda: ex.decode(st, steps, False))
        with torch.no_grad(), ex._ctx():
            lg, _ = model.decode_step(ex.params, st["caches"], st["cur"],
                                      active=st["active"])
        runs[name] = dict(tokens=toks.cpu(), logits=lg.float().cpu(),
                          wall=wall, launches=got, ex=ex, st=st)
    one, run = runs["one device"], runs["plan"]
    got = run["launches"]
    kernels = ("flash_decode", "row_norm", "gemm", "int8_matmul")

    def want_at(shards, ex_):
        gemm, int8 = _products_per_call(cfg, shards, ex_, quant)
        return {"flash_decode": _attn_layers(cfg) * steps,
                "row_norm": _norms_per_call(cfg) * steps,
                "gemm": gemm * steps, "int8_matmul": int8 * steps}
    want = want_at(n, exact)
    require({k: one["launches"][k] for k in kernels} == want_at(1, True),
            f"{what}: one device's launches {one['launches']}")
    require({k: got[k] for k in kernels} == want and not any(
        got[k] for k in ATTN_KERNELS if k != "flash_decode"),
        f"{what}: launches {got} != {want}")
    require(quant == (want["int8_matmul"] > 0), f"{what}: W8A8 {quant} but "
            f"{want['int8_matmul']} int8_matmul launches")
    if quant:
        _quantized_mlps_equal(what, cfg, runs["plan"]["ex"],
                              runs["one device"]["ex"])
    if exact:
        require(torch.equal(run["tokens"], one["tokens"]), f"{what}: "
                "tokens part from one device's")
        d = (run["logits"] - one["logits"]).abs().max().item()
        require(d == 0, f"{what}: logits part from one device's by {d:.4g}")
        check = "tokens and logits equal one device's (d = 0)"
    else:
        match = (run["tokens"] == base["tokens"]).float().mean().item()
        d = (run["logits"] - base["logits"]).abs().max().item()
        check = (f"token match against the exact plan {match:.4f}, max "
                 f"|logits - exact| = {d:.4g} (logged: the reductions' row "
                 "blocks add their f32 partial sums in shard order)")
    log(f"{what}: {steps} fused steps on 8 lanes, {check}; launches a step "
        f"flash_decode={got['flash_decode'] // steps} row_norm="
        f"{got['row_norm'] // steps} gemm={got['gemm'] // steps} "
        f"int8_matmul={got['int8_matmul'] // steps} (one "
        f"device: {one['launches']['flash_decode'] // steps}, "
        f"{one['launches']['row_norm'] // steps}, "
        f"{one['launches']['gemm'] // steps}, "
        f"{one['launches']['int8_matmul'] // steps}); wall_ms_per_step="
        f"{run['wall'] * 1e3 / steps:.2f} (one device "
        f"{one['wall'] * 1e3 / steps:.2f}); the placement's copies "
        f"{placed / 2 ** 30:.2f} GiB, card peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    for name, r in runs.items():
        _route_profile(f"{what}, {name}, 1 fused step (B=8)",
                       lambda: r["ex"].decode(r["st"], 1, False), 1)
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return dict(tokens=run["tokens"], logits=run["logits"],
                launches={k: got[k] for k in kernels})


def _quantized_mlps_equal(what: str, cfg, ex, one) -> None:
    """Each W8A8 MLP of `ex`'s placement (its shards' {"q", "s"} blocks,
    under its plan's context) against one device's (`one`), on one
    random 8-lane decode input and one 32-row prefill input: equal bit
    for bit; `q`'s blocks column-major."""
    from repro_torch.models.layers import mlp
    gen = torch.Generator(device=one.device).manual_seed(31)
    for t, blk in ex.params["tail"].items():
        ffn = blk.get("ffn", {})
        wi = ffn.get("wi")
        if not is_quantized(wi[0] if isinstance(wi, list) else wi):
            continue
        for leaf in ("wi", "wg", "wo"):
            for b in (ffn[leaf] if isinstance(ffn[leaf], list)
                      else [ffn[leaf]]):
                require(b["q"].t().is_contiguous(), f"{what}: tail {t} "
                        f"{leaf}'s q block is not column-major")
        for shape in ((8, 1), (1, 32)):
            x = torch.randn(shape + (cfg.d_model,), generator=gen,
                            device=one.device).bfloat16()
            with torch.no_grad():
                want = mlp(x, one.params["tail"][t]["ffn"], cfg)
                with ex._ctx():
                    got = mlp(x, ffn, cfg)
            d = (got.float() - want.float()).abs().max().item()
            require(torch.equal(got, want), f"{what}: tail {t}'s W8A8 MLP "
                    f"at {shape} parts from one device's by {d:.4g}")
    log(f"{what}: each W8A8 tail MLP on its shards' blocks equals one "
        "device's bit for bit (8 x 1 and 1 x 32 rows); every q block "
        "column-major")


# the recurrent serve plans' steps: (layers, ((mesh, exact, W8A8), ...)),
# each on the first `layers` layers of the full-depth weights (views):
# recurrentgemma-2b's one period and its 2-layer tail (where its only
# 2-d, W8A8 leaves are), xlstm-1.3b's one period
RECURRENT_PLAN = {
    "recurrentgemma-2b": (5, (((1, 2), True, False), ((1, 2), False, False),
                              ((1, 2), True, True), ((1, 2), False, True))),
    "xlstm-1.3b": (8, (((1, 2), True, False), ((1, 4), True, False)))}


def recurrent_phase(dev) -> dict:
    """recurrentgemma-2b and xlstm-1.3b on the card at full width on
    init_params weights (seed 0): card vs CPU on RECURRENT_CUT's layers
    (model_phase, dense slot rows); served at full depth through the
    dense-slot cb engine (recurrentgemma with bf16 and W8A8 weights),
    with exact launch counts; 8 fused decode steps profiled; xlstm on 6
    drained pipeline stages (`family_pipeline`); each under the
    mode="serve" plans of RECURRENT_PLAN (`_recurrent_plan_step`, on its
    first layers as views; recurrentgemma with bf16 and W8A8 weights).
    Returns flash_decode's, int8_matmul's, row_norm's and the pipeline's
    and plans' gemm launches."""
    launches = {"flash_decode": 0, "int8_matmul": 0, "row_norm": 0,
                "gemm": 0}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for i, (arch, cut) in enumerate(RECURRENT_CUT.items()):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if arch == "xlstm-1.3b":
            # the gate runs both block kinds in 2 full-width layers, the
            # sLSTM every 2nd
            model_phase("dense", dataclasses.replace(
                cfg, n_layers=cut, slstm_every=2), note=f" (full width, "
                f"{cut} layers: mLSTM, then sLSTM with slstm_every=2)")
        else:
            model_phase("dense", dataclasses.replace(cfg, n_layers=cut),
                        note=f" (full width, depth cut to {cut} of "
                        f"{cfg.n_layers} layers, one period)")
        torch.cuda.reset_peak_memory_stats()
        model = make_model(cfg, device=dev)
        params = init_params(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"recurrent {arch} x{cfg.n_layers}: "
            f"{_n_params(params) / 1e9:.3f} B parameters, init peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        for quant in ((False, True) if arch == "recurrentgemma-2b"
                      else (False,)):
            torch.cuda.reset_peak_memory_stats()
            for k, v in recurrent_serve(model, params, i, quant).items():
                launches[k] += v
        _recurrent_profile(model, params)
        if layer_plan(cfg)[1] == 0:  # recurrentgemma's tail takes no stage
            _plan_step(f"recurrent pipeline {arch} drained", lambda: add(
                family_pipeline(model, params, skewed=False)))
        layers, plan_steps = RECURRENT_PLAN[arch]
        cut_cfg = dataclasses.replace(cfg, n_layers=layers)
        cut_model = make_model(cut_cfg, device=dev)
        cut_params = _first_layers(params, layer_plan(cut_cfg)[0])
        require(layer_plan(cut_cfg)[1] == layer_plan(cfg)[1],
                f"{arch} x{layers}: the cut keeps another tail")
        base = {}
        for shape, exact, quant in plan_steps:
            got = _recurrent_plan_step(cut_model, cut_params, shape, exact,
                                       base.get(quant), quant)
            add(got["launches"])
            if exact:
                base[quant] = got
        del model, params, cut_model, cut_params
        torch.cuda.empty_cache()
        log(f"recurrent {arch}: {time.perf_counter() - t0:.1f} s")
    return launches

# ---------------------------------------------------------------------------
# the K-ordered gemm (port-only) and the multi-device serve plans
# ---------------------------------------------------------------------------


def _gemm_case(label: str, x, w, nk: bool, flush, main: bool = False,
               out_dtype=torch.bfloat16):
    """The gemm kernel at one shape against its plain version (the f32
    product of the same bf16 inputs, rounded to bf16 once, or kept f32
    where out_dtype is, a shard's partial product): within 2^-8 |want| +
    1e-5 (|x| @ |w|) (the two sides' rounding and f32 summation order),
    then timed beside it and beside torch.matmul (cuBLAS, the library
    yardstick).  Bound: x and w read and out written once over the HBM
    rate, or 2 M N K operations over the bf16 tensor-core rate."""
    wk = w.t() if nk else w

    def kernel():
        return ops.gemm(x, w, w_nk=nk, out_dtype=out_dtype)

    def plain():
        return (x.float() @ wk.float()).to(out_dtype)

    out = kernel()
    want = x.float() @ wk.float()
    spread = x.float().abs() @ wk.float().abs()
    diff = (out.float() - want).abs()
    worst = (diff / (2 ** -8 * want.abs() + 1e-5 * spread + 1e-30)).max()
    err = diff.max().item()
    check = (f"max_abs_err={err:.3g} (limit 2^-8 |want| + 1e-5 |x||w|, "
             f"worst {worst.item():.3f} of it)")
    require(worst.item() <= 1.0, f"gemm {label}: kernel vs plain {check}")
    if not main:
        log(f"kernel gemm {label}: {check}")
        return None
    m, k = x.shape
    n = wk.shape[1]
    ms = time_ms(kernel, flush)
    plain_ms = time_ms(plain, flush)
    library_ms = time_ms(lambda: torch.matmul(x, wk), flush)
    nbytes = 2 * (m * k + k * n + m * n)
    bound_ms, bound_by = _bound(nbytes, 2 * m * n * k, BF16_FLOP_S)
    log(f"kernel gemm {label}: {check} ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={bound_ms:.6f} ({bound_by}; "
        f"{nbytes} bytes, {2 * m * n * k:.4g} flop)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def gemm_phase(dev, flush) -> dict:
    """The port-only gemm: each served product shape against its plain
    version and timed (a decode step's M = 8, a prefill bucket's 128, a
    wave's 1024; smollm-135m, its tensor-parallel shards, minitron-8b's
    and llama4-maverick's dense layer and head), then its invariance: a
    column block of w (a shard's) and a row block of x (a microbatch's, a
    decode step's inside a verify pass) give the whole product's bits,
    where cuBLAS parts (a
    1024-column block of minitron-8b's wq at M 1-64 on an H100).  Returns
    the metrics at a smollm-135m decode step's wi (M 8, K 576, N 1536)."""
    gen = torch.Generator(device=dev).manual_seed(7)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    main = None
    cases = [(8, 576, 1536, False, "smollm wi, decode"),
             (8, 576, 576, False, "smollm wq, decode"),
             (8, 576, 192, False, "smollm wq shard of 3, decode"),
             (8, 576, 64, False, "smollm wk shard of 3, decode"),
             (8, 576, 49152, True, "smollm tied head, decode"),
             (8, 576, 16384, True, "smollm head shard of 3, decode"),
             (128, 576, 1536, False, "smollm wi, prefill bucket"),
             (1024, 576, 1536, False, "smollm wi, a wave's prefill "
              "(EXACT_ROWS_MAX rows, the most the kernel takes)"),
             (8, 4096, 4096, False, "minitron wq, decode"),
             (8, 4096, 1024, False, "minitron wq shard of 4, decode"),
             (8, 4096, 16384, False, "minitron wi, decode"),
             (8, 4096, 4096, False, "minitron wi shard of 4, decode"),
             (128, 4096, 16384, False, "minitron wi, prefill bucket"),
             (8, 5120, 8192, False, "llama4 dense wi, decode"),
             (8, 5120, 202048, False, "llama4 head, decode")]
    for m, k, n, nk, what in cases:
        x = rnd(m, k)
        w = rnd(n, k, scale=0.02) if nk else rnd(k, n, scale=k ** -0.5)
        label = f"{what} M={m} K={k} N={n}{' (w as N x K)' if nk else ''}"
        got = _gemm_case(label, x, w, nk, flush,
                         main=True)
        if main is None:
            main = got
    # the MoE serve plans' products at a decode step, checked: a shard's
    # columns of wq/wk/wv, shared_wi/shared_wg (and llama4's dense wi/wg)
    # and the head, and the products that stay whole on the controller
    # (attention's wo, shared_wo, llama4's dense wo)
    for k, n, what in ((2048, 1024, "moonshot wq/wk/wv shard of 2"),
                       (2048, 512, "moonshot wq/wk/wv shard of 4"),
                       (2048, 1408, "moonshot shared_wi shard of 2"),
                       (2048, 704, "moonshot shared_wi shard of 4"),
                       (2048, 81920, "moonshot head shard of 2"),
                       (2048, 40960, "moonshot head shard of 4"),
                       (2048, 2048, "moonshot wo"),
                       (2816, 2048, "moonshot shared_wo"),
                       (5120, 640, "llama4 wq shard of 8"),
                       (5120, 128, "llama4 wk/wv shard of 8"),
                       (5120, 1024, "llama4 shared_wi / dense wi shard of 8"),
                       (5120, 25256, "llama4 head shard of 8"),
                       (5120, 5120, "llama4 wo"),
                       (8192, 5120, "llama4 shared_wo / dense wo")):
        _gemm_case(f"{what}, decode M=8 K={k} N={n}", rnd(8, k),
                   rnd(k, n, scale=k ** -0.5), False, flush)
    # the recurrent serve plans' products at a decode step: a shard's
    # columns and the reductions, whole on the controller
    for k, n, what in ((2048, 2048, "xlstm up_z/up_g shard of 2"),
                       (2048, 1024, "xlstm up_z/up_g shard of 4"),
                       (2048, 2730, "xlstm glu_wi shard of 2"),
                       (2048, 1365, "xlstm glu_wi shard of 4"),
                       (2560, 1280, "recurrentgemma w_gate_in/w_x_in/"
                        "w_rgate/w_igate shard of 2"),
                       (2560, 3840, "recurrentgemma MLP wi/wg shard of 2"),
                       (4096, 2048, "xlstm down"),
                       (2730, 2048, "xlstm glu_wo"),
                       (2560, 2560, "recurrentgemma w_out"),
                       (7680, 2560, "recurrentgemma MLP wo")):
        _gemm_case(f"{what}, decode M=8 K={k} N={n}", rnd(8, k),
                   rnd(k, n, scale=k ** -0.5), False, flush)
    # their tied heads' column blocks (w as N x K: the embedding's rows)
    # and, under exact=False, the f32 partial products through a shard's
    # rows of recurrentgemma's reductions (`layers.project_out`)
    for k, n, what in ((2560, 128000, "recurrentgemma head shard of 2"),
                       (2048, 25152, "xlstm head shard of 2"),
                       (2048, 12576, "xlstm head shard of 4")):
        _gemm_case(f"{what}, decode M=8 K={k} N={n} (w as N x K)",
                   rnd(8, k), rnd(n, k, scale=0.02), True, flush)
    for k, n, what in ((1280, 2560, "recurrentgemma w_out rows of 2"),
                       (3840, 2560, "recurrentgemma MLP wo rows of 2")):
        _gemm_case(f"{what}, decode M=8 K={k} N={n} (f32 partial product)",
                   rnd(8, k), rnd(k, n, scale=k ** -0.5), False, flush,
                   out_dtype=torch.float32)
    blocks = [(k, n, shards, False) for k, n, shards in (
        (576, 576, 3), (576, 1536, 3), (4096, 4096, 4), (4096, 1024, 4),
        (4096, 16384, 4), (2048, 2048, 2), (2048, 2048, 4), (2048, 2816, 2),
        (2048, 2816, 4), (5120, 5120, 8), (5120, 1024, 8), (5120, 8192, 8),
        (2048, 4096, 2), (2048, 4096, 4), (2048, 5460, 2), (2048, 5460, 4),
        (2560, 2560, 2), (2560, 7680, 2))]
    # the tied heads, w as N x K: a shard's block is rows of the embedding
    blocks += [(2048, 50304, 2, True), (2048, 50304, 4, True),
               (2560, 256000, 2, True)]
    for k, n, shards, nk in blocks:
        x = rnd(128, k)
        w = rnd(n, k, scale=0.02) if nk else rnd(k, n, scale=k ** -0.5)
        whole = ops.gemm(x, w, w_nk=nk)
        cols = n // shards
        parts = [(w[i * cols:(i + 1) * cols] if nk
                  else w[:, i * cols:(i + 1) * cols]).contiguous()
                 for i in range(shards)]
        cublas = torch.matmul(x, w.t() if nk else w)
        parted = []
        for m in (1, 6, 8, 40, 64, 128):
            got = torch.cat([ops.gemm(x[:m], p, w_nk=nk) for p in parts], 1)
            require(torch.equal(got, whole[:m])
                    and torch.equal(ops.gemm(x[m - 1:m], w, w_nk=nk),
                                    whole[m - 1:m]),
                    f"gemm K={k} N={n}{' (w as N x K)' if nk else ''}: a "
                    f"block parts from the whole at M={m}")
            cub = torch.cat([torch.matmul(x[:m], p.t() if nk else p)
                             for p in parts], 1)
            parted.append(int((cub != cublas[:m]).sum()))
        log(f"kernel gemm K={k} N={n}{' (w as N x K)' if nk else ''} in "
            f"{shards} column blocks at M 1, 6, 8, 40, 64, 128: equal to "
            f"the whole product bit for bit (torch.matmul parts at "
            f"{parted} outputs)")
        del x, w, whole, parts, cublas
    return main


# the MoE expert products a tensor-parallel shard runs over its block of
# experts: (arch, E, D, F, shard counts, rows an expert).  moonshot's rows:
# a decode step's 8 lanes at capacity 1, and one request's prefill at the
# buckets 32-256 (capacity ceil(6 S 1.25 / 64) = 4, 8, 15, 30); llama4's:
# a decode step's 8, and buckets at capacity ceil(S 1.25 / 128) = 1-3
EXPERT_PROBE = (("moonshot-v1-16b-a3b", 64, 2048, 1408, (2, 4),
                 (8, 4, 15, 30)),
                ("llama4-maverick-400b-a17b", 128, 5120, 8192, (2, 4, 8),
                 (8, 1, 3)))


def expert_bmm_probe(dev) -> None:
    """A tensor-parallel shard's expert products against one device's:
    torch.bmm over a block of E / n experts, the block's weights a
    contiguous copy (as a plan's placement holds them), must give the
    same bits as those experts' outputs in the E-expert call, for wi and
    wg ((E, rows, D) @ (E, D, F)) and wo ((E, rows, F) @ (E, F, D)) at
    each row count of EXPERT_PROBE.  cuBLAS picks its kernel by shape, and
    the batch count is part of the shape; on an H100 it does not part
    here, so models/moe.py keeps torch.bmm for the expert products, and
    this gate shows a cuBLAS that comes to part."""
    gen = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    cases = 0
    for arch, e, d, f, shards, rows_all in EXPERT_PROBE:
        for k, n, mat in ((d, f, "wi/wg"), (f, d, "wo")):
            w = (torch.randn((e, k, n), generator=gen, device=dev)
                 * k ** -0.5).bfloat16()
            for rows in rows_all:
                x = torch.randn((e, rows, k), generator=gen,
                                device=dev).bfloat16()
                whole = torch.bmm(x, w)
                for sh in shards:
                    per = e // sh
                    diff = sum(int((torch.bmm(x[i * per:(i + 1) * per], w[
                        i * per:(i + 1) * per].contiguous()) != whole[
                            i * per:(i + 1) * per]).sum()) for i in range(sh))
                    require(diff == 0, f"expert probe {arch} {mat} K={k} "
                            f"N={n} rows={rows}: {sh} blocks of {per} "
                            f"experts part from the {e}-expert call at "
                            f"{diff} of {e * rows * n} outputs")
                    cases += 1
            del w
    torch.cuda.empty_cache()
    log(f"expert probe: torch.bmm over blocks of E/n experts equals the "
        f"E-expert call bit for bit in all {cases} cases ("
        + "; ".join(f"{a} E {e}, K {d} <-> {f}, n {shards}, rows an expert "
                    f"{rows}" for a, e, d, f, shards, rows in EXPERT_PROBE)
        + f") in {time.perf_counter() - t0:.1f} s")


# the mLSTM cell over a block of heads, at xlstm-1.3b's widths: (lanes,
# steps) of a decode step and of one request's prefill chunks (a bucket
# of 32, and MLSTM_CHUNK = 128)
MLSTM_PROBE = ((8, 1), (1, 32), (1, 128))
# the cell's einsums and sums, each run over a block of heads alone in
# the probe: (name, the einsum or reduction, the head dim of each operand)
MLSTM_FORMS = (("q/k/v projection", "bsnh,nhk->bsnk", (2, 0)),
               ("scores", "binK,bjnK->bijn", (2, 2)),
               ("intra num", "bijn,bjnh->binh", (3, 2)),
               ("intra den", "sum2", (3,)),
               ("inter num", "binK,bnKh->binh", (2, 1)),
               ("inter den", "binK,bnK->bin", (2, 1)),
               ("inter den as mul-sum", "mulsum", (2, 1)),
               ("carry C", "bjn,bjnK,bjnh->bnKh", (2, 2, 2)),
               ("carry n", "bjn,bjnK->bnK", (2, 2)))


def mlstm_head_probe(dev) -> list:
    """Why a serve plan runs the mLSTM cell whole on the controller
    (models/recurrent.mlstm_block), logged, not gated (the plan runs no
    block of heads alone, so nothing on its path rests on it): at
    xlstm-1.3b's widths (nh 4, ih 1024, dk 512) and each (lanes, steps)
    of MLSTM_PROBE, each einsum and sum of the cell, MLSTM_FORMS, run
    over blocks of nh/2 and nh/4 heads alone (contiguous copies), against
    those heads of the nh-head call.  Returns [(form, B, S, outputs that
    part at nh/2, at nh/4, outputs)]."""
    cfg = get_config("xlstm-1.3b")
    _, nh, ih, dk = rec._mlstm_dims(cfg, cfg.d_model)
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()

    def rnd(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def block(t, dim, i, per):
        return t.narrow(dim, i * per, per).contiguous()

    def run(eq, ts):
        if eq == "sum2":
            return ts[0].sum(2)
        if eq == "mulsum":
            return (ts[0] * ts[1][:, None]).sum(-1)
        return torch.einsum(eq, *ts)

    wq, wk = (rnd((nh, ih, dk), ih ** -0.5, torch.bfloat16) for _ in "qk")
    wv = rnd((nh, ih, ih), ih ** -0.5, torch.bfloat16)
    table = []
    for b, s in MLSTM_PROBE:
        z = rnd((b, s, nh, ih), 1.0, torch.bfloat16)
        C, n_ = rnd((b, nh, dk, ih), 0.1), rnd((b, nh, dk)).abs()
        qf = (torch.einsum("bsnh,nhk->bsnk", z, wq) / dk ** 0.5).float()
        kf = (torch.einsum("bsnh,nhk->bsnk", z, wk) / dk ** 0.5).float()
        vf = torch.einsum("bsnh,nhj->bsnj", z, wv).float()
        sw = torch.einsum("binK,bjnK->bijn", qf, kf) * 0.01
        wj = rnd((b, s, nh)).exp()
        args = {"q/k/v projection": (z, wq), "scores": (qf, kf),
                "intra num": (sw, vf), "intra den": (sw,),
                "inter num": (qf, C), "inter den": (qf, n_),
                "inter den as mul-sum": (qf, n_),
                "carry C": (wj, kf, vf), "carry n": (wj, kf)}
        for name, eq, dims in MLSTM_FORMS:
            ts = args[name]
            whole = run(eq, ts)
            out_dim = whole.dim() - 1 if eq in ("sum2", "mulsum") else (
                eq.split("->")[1].index("n"))
            parted = []
            for n in (2, 4):
                per = nh // n
                parted.append(sum(int((run(eq, [
                    block(t, d, i, per) for t, d in zip(ts, dims)])
                    != whole.narrow(out_dim, i * per, per)).sum())
                    for i in range(n)))
            table.append((name, b, s, parted[0], parted[1], whole.numel()))
    del wq, wk, wv
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"mlstm probe (logged): the cell's forms over blocks of heads "
        f"alone against the {nh}-head call (xlstm-1.3b: ih {ih}, dk {dk}), "
        f"outputs that part at nh/2 / nh/4 heads a call, in "
        f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"{name} B={b} S={s} {p2}/{p4} of {m}"
            for name, b, s, p2, p4, m in table))
    return table


PLAN_ARCH = "smollm-135m"  # served on a (1, 3) model axis: 1 kv head a shard
PLAN_TP = (1, 3)
PLAN_BIG = ("minitron-8b", (1, 4), 8)  # 2 kv heads a shard, 8 of 32 layers
PLAN_STAGES = 6  # smollm-135m's 30 layers, 5 a stage: the paper's chain
PLAN_SKEW_B = 12  # the skewed pipeline's batch: 6 lane groups of 2
PLAN_BIG_STAGES = 4  # minitron-8b's 8 layers, 2 a stage, skewed at B 8
# the --no-exact band's instrument: Adam steps of its fit (the CPU's
# 300-step fit of the same config already gives token match 1.0)
PLAN_FIT_STEPS = 400


def _gemms_per_call(cfg, n: int, exact: bool) -> int:
    return _products_per_call(cfg, n, exact)[0]


def _products_per_call(cfg, n: int, exact: bool,
                       quant: bool = False) -> tuple:
    """(gemm, int8_matmul) launches of one backbone call and its head
    under a serve plan on n tensor-parallel shards (n = 1: one device): a
    projection group whose columns divide runs its column products once a
    shard and its reduction once (whole, exact) or once a shard (row
    blocks, psum form), else each once; attention whole where its heads
    do not divide.  A MoE layer's gemm products are its shared experts'
    (the router's f32 product and the experts' run elsewhere); an
    RG-LRU's are `w_gate_in`, `w_x_in`, `w_rgate`, `w_igate` and `w_out`,
    by width; an mLSTM's a whole `w_if`, then `up_z`, `up_g` and `down`
    by its inner width (its q/k/v projections are torch.matmul's, whole);
    an sLSTM's a whole `w_in`, then `glu_wi` by its 2 glu columns and
    `glu_wo` by its glu rows.  quant (W8A8): the tail layers' attention
    and MLP groups (their 2-d leaves, `models/quantized.py`) run in
    int8_matmul instead, each as its gemm products would."""
    def group(cols: int, width: int) -> int:
        split = width % n == 0
        return cols * (n if split else 1) + (n if split and not exact else 1)

    attn = cfg.n_kv_heads % n == 0 and cfg.n_heads % n == 0
    mats = 2 if cfg.mlp_style == "swiglu" else 1
    glu = int(4 * cfg.d_model / 3)
    counts = {"gemm": n if cfg.vocab_size % n == 0 else 1, "int8": 0}
    tail0 = cfg.n_layers - layer_plan(cfg)[1]
    for layer in range(cfg.n_layers):
        kind = cfg.block_kind(layer)
        w = "int8" if quant and layer >= tail0 else "gemm"
        if kind == "attn":
            counts[w] += 3 * (n if attn else 1) + (n if attn and not exact
                                                   else 1)
        elif kind == "rglru":
            counts["gemm"] += group(4, cfg.rnn_width or cfg.d_model)
        elif kind == "mlstm":
            counts["gemm"] += 1 + group(2, int(cfg.proj_factor * cfg.d_model))
        else:  # slstm: glu_wi by its columns, glu_wo by its rows
            counts["gemm"] += 1 + (n if 2 * glu % n == 0 else 1) + group(
                0, glu)
        if cfg.is_moe_layer(layer):
            if cfg.n_shared_experts:
                counts["gemm"] += group(mats, cfg.d_ff * cfg.n_shared_experts)
        elif cfg.mlp_style != "none" and cfg.d_ff:
            counts[w] += group(mats, cfg.d_ff)
    return counts["gemm"], counts["int8"]


def _plan_engine_pass(eng, reqs, what: str) -> tuple:
    """One pass of `reqs` through an engine, the launch counts set to 0
    just before and read just after.  Returns ({rid: tokens}, stats
    delta, launches, wall seconds)."""
    for r in reqs:
        eng.submit(r)
    s0 = dict(eng.stats)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.launches)
    require(len(done) == len(reqs) and all(
        r.done and (len(r.tokens_out) == r.max_new_tokens
                    or r.tokens_out[-1] == r.eos_id) for r in done),
        f"{what}: a request stopped short of its budget")
    ds = {k: v - s0.get(k, 0) for k, v in eng.stats.items()
          if isinstance(v, int)}
    return {r.rid: tuple(r.tokens_out) for r in done}, ds, got, wall


def _plan_serve(model, params, shape, kv: str, launches: dict,
                exact: bool = True, passes=("cold", "hits")) -> dict:
    """smollm-135m (or the model given) through the paged cb engine under
    a mode="serve" plan on `shape`, beside the plan-free engine, over the
    shared-prefix stream (8 requests of 32 tokens, B=8): a cold pass,
    then one whose admissions hit the radix tree on the sharded arena.
    Each pass: the plan's streams equal the plain engine's (exact),
    kernel 1 (or 2) launches n_shards x n_layers per decode step, the
    row norm 2 per layer and 1 per call, gemm as `_gemms_per_call`.
    Returns the plan's streams per pass."""
    cfg = model.cfg
    mesh = make_mesh(shape, ("data", "model"))
    n = mesh.shape["model"]
    plan = build_plan(cfg, mesh, mode="serve", exact=exact)
    kernel = "paged_flash_decode_q" if kv == "int8" else "paged_flash_decode"
    form = "exact" if exact else "no-exact"
    what = f"plans serve {form} {cfg.name} x{cfg.n_layers} {kv} mesh {shape}"
    args = serve_cli.parse_args(["--requests", "8", "--max-new", "32",
                                 "--stream", "shared-prefix", "--seed", "0"])
    engines = {name: ContinuousBatchingEngine(
        model, params, max_batch=8, buckets=serve_cli.BUCKETS, kv_dtype=kv,
        plan=p) for name, p in (("plain", None), ("plan", plan))}
    out = {}
    for pas in passes:
        streams = {}
        for name, eng in engines.items():
            reqs = serve_cli.make_stream(args, cfg.vocab_size, args.seed)
            streams[name], ds, got, wall = _plan_engine_pass(eng, reqs, what)
            steps = ds["decode_steps"]
            if name == "plain":
                log(f"{what} {pas}: the plain engine: wall_s={wall:.4f} "
                    f"wall_ms_per_decode_step="
                    f"{wall * 1e3 / max(steps, 1):.2f}")
                continue
            calls = steps + ds["prefills"]
            want = {k: n * cfg.n_layers * steps if k == kernel else 0
                    for k in ATTN_KERNELS}
            have = {k: got[k] for k in ATTN_KERNELS}
            require(have == want, f"{what} {pas}: launches {have} != {want}")
            per = _gemms_per_call(cfg, n, exact)
            require(got["gemm"] == per * calls, f"{what} {pas}: "
                    f"{got['gemm']} gemm launches != {per} x {calls} calls")
            require(got["row_norm"] == _norms_per_call(cfg) * calls,
                    f"{what} {pas}: {got['row_norm']} row_norm launches")
            for k in (kernel, "row_norm", "gemm"):
                launches[k] += got[k]
            toks = sum(len(t) for t in streams[name].values())
            log(f"{what} {pas}: tokens={toks} wall_s={wall:.4f} "
                f"tok_s={toks / wall:.1f} decode_steps={steps} "
                f"wall_ms_per_decode_step={wall * 1e3 / max(steps, 1):.2f} "
                f"prefix_hits={ds['prefix_hits']} prefills={ds['prefills']} "
                f"{kernel}_launches={got[kernel]} (= {n} shards x "
                f"{cfg.n_layers} x {steps}) gemm_launches={got['gemm']} "
                f"row_norm_launches={got['row_norm']}")
            if pas == "hits":
                require(ds["prefix_hits"] >= len(reqs) - 1,
                        f"{what}: {ds['prefix_hits']} hits in the second "
                        "pass")
        if exact:
            require(streams["plan"] == streams["plain"], f"{what} {pas}: "
                    "the plan's streams part from one device's")
        out[pas] = (streams["plan"], streams["plain"])
    arena = engines["plan"]._slot_caches["scan"]["b0"]
    if cfg.n_kv_heads % n == 0:
        heads = [t.shape[3] for t in arena["k"]]
        require(heads == [cfg.n_kv_heads // n] * n,
                f"{what}: arena kv heads per shard {heads}")
        log(f"{what}: each of the {n} shards' arenas holds "
            f"{heads[0]} kv head(s) (P, ps, KVH/n, hd) = "
            f"{tuple(arena['k'][0].shape[1:])}")
    return out


def _plan_logits(model, params, shape, kind: str, what: str,
                 exact: bool = True) -> float:
    """Prefill two prompts and 4 teacher-fed decode steps on the plain
    cache and on the same cache placed under a serve plan (paged, int8
    or dense): the largest |logit| difference (0 = bit for bit)."""
    plan = build_plan(model.cfg, make_mesh(shape, ("data", "model")),
                      mode="serve", exact=exact)
    ex = Executor(model, params, max_batch=2, plan=plan)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (21, 37)]
    act = torch.ones((2,), dtype=torch.bool, device=model.device)
    with torch.no_grad():
        plain, lg = _admitted(model, params, prompts, 16, 6, kind)
        placed, lg2 = _admitted(model, params, prompts, 16, 6, kind)
        placed = ex.place_caches(placed, kind != "dense")
        d = (lg - lg2).abs().max().item()
        for _ in range(4):
            tok = lg.argmax(-1).to(torch.int32)
            lg, plain = model.decode_step(params, plain, tok, active=act)
            with ex._ctx():
                lg2, placed = model.decode_step(ex.params, placed, tok,
                                                active=act)
            d = max(d, (lg - lg2).abs().max().item())
    log(f"{what} {kind} cache{'' if exact else ', --no-exact'}: prefill "
        f"+ 4 decode steps, max |plan - one device| logits = {d:.4g}")
    return d


def _route_profile(what: str, fn, steps: int) -> None:
    """One fused decode dispatch under torch.profiler: wall ms and device
    ops per step, and the device's busy share."""
    spans, wall_us = _device_spans(fn)
    if not spans:
        log(f"profile {what}: the profiler recorded no device time (not "
            "measured)")
        return
    log(f"profile {what}: wall_ms_per_step={wall_us / 1e3 / steps:.3f} "
        f"device_ops_per_step={len(spans) / steps:.1f} "
        f"device_busy_share={_busy_us(spans) / wall_us:.4f} "
        f"device_kernel_ms_per_step="
        f"{sum(e - s for s, e, _ in spans) / 1e3 / steps:.3f}")


def _plan_decode_profiles(model, params, shape) -> None:
    """Route A beside one device: 2 fused decode steps on a paged bf16
    arena (2 lanes admitted by `_admitted`), plain and under the serve
    plan, each profiled."""
    plan = build_plan(model.cfg, make_mesh(shape, ("data", "model")),
                      mode="serve")
    ex = Executor(model, params, max_batch=2, plan=plan)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).astype(np.int32)
               for n in (21, 37)]
    act = torch.ones((2,), dtype=torch.bool, device=model.device)
    for label, p in (("one device", params), (f"serve plan {shape}", None)):
        with torch.no_grad():
            big, lg = _admitted(model, params, prompts, 16, 6, "paged")
            if p is None:
                big, p = ex.place_caches(big, True), ex.params
            tok = lg.argmax(-1).to(torch.int32)
            model.decode_steps(p, big, tok, act, 1)  # warm

            def run():
                with torch.no_grad(), ex._ctx():
                    model.decode_steps(p, big, tok, act, 2)
            _route_profile(f"plans route A {model.cfg.name} paged bf16, "
                           f"{label}, 2 fused steps (B=2)", run, 2)


def _plan_gmi(dev) -> None:
    """Every GMI collective and pipelined_apply on CUDA shards (8 sharing
    the card, on a (2, 4) pod x data mesh) equal to the same on CPU
    shards, bit for bit, on integer-valued f32 inputs."""
    from repro_torch.core import gmi
    from repro_torch.core.pipeline import pipelined_apply
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.integers(-8, 9, (8, 16, 5)), dtype=torch.float32)
    meshes = {d: make_mesh((2, 4), ("pod", "data"), device=d)
              for d in ("cpu", "cuda")}
    cases = [("broadcast", ("data",), {"root": 2}),
             ("reduce", ("data",), {"root": 1}),
             ("gather", ("data",), {}), ("scatter", ("data",), {"root": 1}),
             ("allgather_composed", ("data",), {}),
             ("allreduce_composed", ("data",), {}),
             ("allgather", (("pod", "data"),), {}),
             ("allreduce", (("pod", "data"),), {}),
             ("reduce_scatter", ("data",), {}),
             ("hier_allreduce", ("data", "pod"), {}),
             ("flat_allreduce", ("data", "pod"), {}),
             ("hier_allgather", ("data", "pod"), {}),
             ("cluster_send", ("pod",), {})]
    for name, ax, kw in cases:
        res = {}
        for d, mesh in meshes.items():
            xs = [(t[:4] if name == "scatter" else t).to(d) for t in x]
            res[d] = getattr(gmi, name)(xs, mesh, *ax, **kw)
        require(all(torch.equal(a.cpu(), b) and a.device.type == "cuda"
                    for a, b in zip(res["cuda"], res["cpu"])),
                f"plans gmi {name}: CUDA shards part from CPU shards")
    w = torch.tensor(rng.integers(-2, 3, (6, 5, 5)), dtype=torch.float32)
    xm = torch.tensor(rng.integers(-2, 3, (6, 3, 5)), dtype=torch.float32)
    pipe = {d: pipelined_apply(lambda p, v: v @ p + 1.0,
                               make_mesh((6,), ("stage",), device=d), "stage",
                               w.to(d), xm.to(d)) for d in ("cpu", "cuda")}
    require(torch.equal(pipe["cuda"].cpu(), pipe["cpu"]),
            "plans pipelined_apply: CUDA stages part from CPU stages")
    log(f"plans gmi: {len(cases)} collectives on 8 CUDA shards (sharing "
        f"{len(set(meshes['cuda'].devices))} card) and pipelined_apply on 6 "
        "stages equal the CPU's bit for bit")


def _whole(tree):
    """A placed tree with every stage `Shards` joined back (stage blocks
    are contiguous periods: a join is a concatenation)."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return torch.cat(list(tree)) if isinstance(tree, list) else tree.clone()


def _plan_pipeline(model, params, launches: dict) -> None:
    """Route B: smollm-135m's 30 layers on a 6-stage serve_pipeline plan
    (5 a stage, all 6 stages on the card), dense slot rows, B = 6, so 6
    microbatches of one lane: the executor's pipelined loop equals
    `Model.decode_steps` on the same state, the engine's streams equal
    the plain dense-slot engine's, ticks per step =
    pipeline_steps(6, 6), flash_decode launches n_layers x n_micro per
    step; then Eq. 1 from the measured stage time."""
    from repro_torch.core.latency_model import StageTiming, total_latency
    from repro_torch.core.pipeline import pipeline_steps
    cfg, b, steps = model.cfg, PLAN_STAGES, 8
    plan = build_plan(cfg, make_mesh((PLAN_STAGES,), ("stage",)),
                      mode="serve_pipeline")
    n_micro = PLAN_STAGES if b % PLAN_STAGES == 0 else 1
    ticks = pipeline_steps(n_micro, PLAN_STAGES)
    what = f"plans serve_pipeline {cfg.name} x{cfg.n_layers} {PLAN_STAGES} stages"
    ex = Executor(model, params, max_batch=b, cache_len=176,
                  buckets=serve_cli.BUCKETS, plan=plan)
    st = _dense_state(ex, cfg, b, 13)
    k = st["caches"]["scan"]["b0"]["k"]
    require([t.shape[0] for t in k] == [cfg.n_layers // PLAN_STAGES] * b,
            f"{what}: stage blocks {[t.shape[0] for t in k]}")
    whole = _whole(st["caches"])
    with torch.no_grad():
        want, *_ = model.decode_steps(
            params, whole, st["cur"].clone(), st["active"].clone(), steps,
            eos_id=st["eos"], budget=st["budget"].clone(), pad_token=0)
    t0 = ex.pipeline_ticks
    (got,), wall, counted = _counted(
        lambda: (ex.decode(st, steps, paged=False),),
        {"flash_decode": cfg.n_layers * n_micro * steps}, what)
    require(torch.equal(got, want), f"{what}: the pipelined loop parts from "
            "Model.decode_steps")
    require(ex.pipeline_ticks - t0 == steps * ticks,
            f"{what}: {ex.pipeline_ticks - t0} ticks != {steps} x {ticks}")
    stage_ms = wall * 1e3 / steps / (n_micro * PLAN_STAGES)
    est = total_latency(StageTiming(T=stage_ms, X=stage_ms, d=0.0),
                        PLAN_STAGES)
    log(f"{what}: {steps} fused steps equal Model.decode_steps bit for bit; "
        f"ticks per step {ticks} = pipeline_steps({n_micro}, {PLAN_STAGES}); "
        f"flash_decode launches {counted['flash_decode']} (= {cfg.n_layers} "
        f"layers x {n_micro} microbatches x {steps}); wall_ms_per_step="
        f"{wall * 1e3 / steps:.2f}; one stage on one microbatch "
        f"{stage_ms:.3f} ms, so Eq. 1 T + (L-1)(X+d) with T = X = "
        f"{stage_ms:.3f} ms, d = 0 (one card), L = {PLAN_STAGES}: "
        f"{est:.3f} ms for one microbatch through the chain; the stages "
        f"share the card, so a step costs n_micro x L stage runs, not "
        f"{ticks} ticks")
    launches["flash_decode"] += counted["flash_decode"]
    _route_profile(f"plans route B {what}, 1 fused step (B={b})",
                   lambda: ex.decode(st, 1, paged=False), 1)
    args = serve_cli.parse_args(["--requests", "6", "--max-new", "16",
                                 "--seed", "4"])
    streams = {}
    for name, p in (("plain", None), ("plan", plan)):
        eng = ContinuousBatchingEngine(model, params, max_batch=b,
                                       buckets=serve_cli.BUCKETS,
                                       paged=False, plan=p)
        reqs = serve_cli.make_stream(args, cfg.vocab_size, args.seed)
        t0 = eng.executor.pipeline_ticks
        streams[name], ds, got, wall = _plan_engine_pass(eng, reqs, what)
        if p is None:
            log(f"{what}: the plain dense-slot engine (B={b}): wall_s="
                f"{wall:.4f} wall_ms_per_decode_step="
                f"{wall * 1e3 / max(ds['decode_steps'], 1):.2f}")
            continue
        require(eng.executor.pipeline_ticks - t0 == ds["decode_steps"] * ticks,
                f"{what}: engine ticks")
        want_fd = cfg.n_layers * n_micro * ds["decode_steps"]
        require(got["flash_decode"] == want_fd, f"{what}: engine "
                f"flash_decode launches {got['flash_decode']} != {want_fd}")
        for k_ in ("flash_decode", "row_norm", "gemm"):
            launches[k_] += got[k_]
        toks = sum(len(t) for t in streams[name].values())
        log(f"{what} engine (dense slots, B={b}): tokens={toks} "
            f"wall_s={wall:.4f} tok_s={toks / wall:.1f} decode_steps="
            f"{ds['decode_steps']} wall_ms_per_decode_step="
            f"{wall * 1e3 / max(ds['decode_steps'], 1):.2f} "
            f"flash_decode_launches={got['flash_decode']}")
    require(streams["plan"] == streams["plain"], f"{what}: the engine's "
            "streams part from the plain dense-slot engine's")


def _plan_no_exact(exact_streams, model, params, launches: dict) -> None:
    """--no-exact (psum-form TP) on smollm-135m at full width, (1, 3):
    its teacher-fed logits against one device's and its streams against
    the exact plan's, token by token (logged: on random weights the top
    two logits of a step often sit one bf16 ulp apart, and one flipped
    token parts the rest of its stream); then the band on the fitted
    instrument: reduced smollm-135m with 6 heads over 3 kv heads (the
    reduced config's 2 do not divide 3), fitted on the card, exact vs
    --no-exact streams on (1, 3), required >= 0.98 (the reference's
    band)."""
    def match(a, b):
        pairs = [(x, y) for k in a for x, y in zip(a[k], b[k])]
        return sum(x == y for x, y in pairs) / len(pairs), len(pairs)

    thr = _plan_serve(model, params, PLAN_TP, "bf16", launches, exact=False,
                      passes=("cold",))
    rate, n = match(exact_streams, thr["cold"][0])
    log(f"plans serve no-exact {model.cfg.name} x{model.cfg.n_layers} "
        f"(random weights): token match vs the exact plan {rate:.4f} over "
        f"{n} tokens (logged)")
    _plan_logits(model, params, PLAN_TP, "paged",
                 f"plans serve {model.cfg.name}", exact=False)
    cfg = dataclasses.replace(get_config(PLAN_ARCH).reduced(), n_heads=6,
                              n_kv_heads=3, name="smollm-135m-reduced-kv3")
    fm = make_model(cfg, device="cuda")
    fp = synthetic.fit_affine_lm(fm, steps=PLAN_FIT_STEPS)
    rng = np.random.default_rng(5)
    prompts = synthetic.affine_prompts(rng, 12, cfg.vocab_size, (6, 30))
    res = {}
    for exact in (True, False):
        plan = build_plan(cfg, make_mesh(PLAN_TP, ("data", "model")),
                          mode="serve", exact=exact)
        eng = ContinuousBatchingEngine(fm, fp, max_batch=4, buckets=(16, 32),
                                       plan=plan)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=24)
                for i, p in enumerate(prompts)]
        res[exact], _, got, _ = _plan_engine_pass(eng, reqs, cfg.name)
        launches["paged_flash_decode"] += got["paged_flash_decode"]
    rate, n = match(res[True], res[False])
    log(f"plans serve no-exact {cfg.name} (fitted, {PLAN_FIT_STEPS} steps): "
        f"token match "
        f"vs the exact plan {rate:.4f} over {n} tokens (band >= 0.98)")
    require(rate >= 0.98, f"no-exact token match {rate:.4f} < 0.98")


def _skew_state(model, ex, b: int, ps: int, maxp: int, seed: int) -> dict:
    """A paged decode state of `b` admitted lanes on a request-skewed
    executor: lane i owns pages 1 + i * maxp ..., even lanes prefilled
    whole, odd ones in the radix-hit form (a 16-token prefix in their
    pages, the rest of the prompt through the forced-token queue)."""
    st = ex.fresh_state(ex.init_caches(True, ps, 1 + b * maxp, maxp),
                        paged=True)
    rng = np.random.default_rng(seed)
    for sl in range(b):
        p = rng.integers(0, model.cfg.vocab_size, 20 + 7 * sl).astype(
            np.int32)
        pages = np.arange(1 + sl * maxp, 1 + (sl + 1) * maxp, dtype=np.int32)
        cut = 16 if sl % 2 else len(p)
        lg, small = ex.prefill_prompts([p[:cut]], 1, bucket_cache=True)
        bucket = bucket_len(cut, ex.buckets, lane=8)
        ex.admit_cold(st, sl, small, pages, cut, pages,
                      pages[:-(-bucket // ps)])
        tok, rest = ((int(lg[0].argmax()), p[:0]) if cut == len(p)
                     else (int(p[cut]), p[cut + 1:]))
        ex.admit_lane_paged(st, sl, tok, -1, 64, rest, len(rest))
    return st


def _plan_skew_loop(model, params, launches: dict) -> None:
    """Route C: the request-skewed serve_pipeline (exact=False) on
    smollm-135m's 30 layers, 6 stages of 5, B = 12 (6 lane groups of 2),
    pages of 16.  On one admitted state (forced-token queues included)
    the skewed loop's tokens, lane state, counters and stage-local arena
    equal `Model.decode_steps`' on the whole state; n*6 + 5 ticks a
    horizon; kernel 1 30 x 6 launches a step.  Then one step of each
    profiled: the skewed loop and the plain fused loop on the whole
    state (one device)."""
    cfg, b, steps, ps, maxp = model.cfg, PLAN_SKEW_B, 4, 16, 12
    plan = build_plan(cfg, make_mesh((PLAN_STAGES,), ("stage",)),
                      mode="serve_pipeline", exact=False)
    what = (f"plans serve_pipeline --no-exact {cfg.name} x{cfg.n_layers} "
            f"{PLAN_STAGES} stages")
    ex = Executor(model, params, max_batch=b, cache_len=ps * maxp,
                  buckets=serve_cli.BUCKETS, plan=plan)
    st = _skew_state(model, ex, b, ps, maxp, 15)
    per = cfg.n_layers // PLAN_STAGES
    for name, leaf in st["caches"]["scan"]["b0"].items():
        require([t.shape[0] for t in leaf] == [per] * PLAN_STAGES,
                f"{what}: {name} stage blocks {[t.shape[0] for t in leaf]}")
    whole = _whole(st["caches"])
    lanes = {k: st[k].clone() for k in ("cur", "active", "budget", "fptr")}
    with torch.no_grad():
        want = model.decode_steps(
            params, whole, lanes["cur"], lanes["active"], steps,
            eos_id=st["eos"], budget=lanes["budget"], pad_token=0,
            forced=st["forced"], forced_len=st["flen"],
            forced_ptr=lanes["fptr"])
    t0 = ex.pipeline_ticks
    (got,), wall, counted = _counted(
        lambda: (ex.decode(st, steps, paged=True),),
        {"paged_flash_decode": cfg.n_layers * PLAN_STAGES * steps}, what)
    require(torch.equal(got, want[0]), f"{what}: the skewed loop's tokens "
            "part from Model.decode_steps")
    for name, w in zip(("cur", "active", "budget", "fptr"), want[1:5]):
        require(torch.equal(st[name], w), f"{what}: lane state {name} parts")
    require(torch.equal(st["caches"]["pos"], whole["pos"]),
            f"{what}: position counters part")
    arena = _whole(st["caches"]["scan"])["b0"]
    for name, t in want[5]["scan"]["b0"].items():
        require(torch.equal(arena[name], t), f"{what}: arena {name} parts")
    ticks = ex.pipeline_ticks - t0
    require(ticks == steps * PLAN_STAGES + PLAN_STAGES - 1,
            f"{what}: {ticks} ticks for {steps} steps")
    launches["paged_flash_decode"] += counted["paged_flash_decode"]
    log(f"{what} (B={b}, {PLAN_STAGES} lane groups of {b // PLAN_STAGES}): "
        f"{steps} fused steps equal Model.decode_steps bit for bit (tokens, "
        f"lane state, counters, every arena leaf; 6 lanes with forced "
        f"queues); ticks {ticks} = {steps} x {PLAN_STAGES} + "
        f"{PLAN_STAGES - 1} (drained: {steps} x "
        f"{pipeline_ticks_per_step(PLAN_STAGES, True)}); paged_flash_decode "
        f"launches {counted['paged_flash_decode']} (= {cfg.n_layers} layers"
        f" x {PLAN_STAGES} groups x {steps}); each stage's arena block "
        f"holds {per} periods; wall_ms_per_step={wall * 1e3 / steps:.2f}")
    _route_profile(f"plans route C {what}, 1 fused step (B={b})",
                   lambda: ex.decode(st, 1, paged=True), 1)
    act = want[2]

    def plain():
        with torch.no_grad():
            model.decode_steps(params, whole, want[1], act, 1,
                               eos_id=st["eos"], budget=want[3],
                               pad_token=0, forced=st["forced"],
                               forced_len=st["flen"], forced_ptr=want[4])
    _route_profile(f"plans route C's state on one device, 1 fused step "
                   f"(B={b})", plain, 1)


def _plan_skew_serve(model, params, n_stages: int, b: int, kvs: dict,
                     launches: dict) -> None:
    """The cb engine under a request-skewed serve_pipeline plan on
    `n_stages` stages at B = b, beside the plan-free paged engine, over
    the shared-prefix stream (b requests of 16 tokens): each kv dtype's
    passes (`kvs`: kv dtype -> passes; cold, then radix hits on the
    stage-local arenas) must give
    the plain engine's streams, kernel 1 (2) n_layers x n_stages launches
    a decode step, row_norm and gemm once a layer (and the head) per
    group a step and per prefill, n*S + S - 1 ticks a dispatch; each
    stage's arena block n_rep / S periods, a page's bytes 1/S of one
    device's."""
    cfg = model.cfg
    plan = build_plan(cfg, make_mesh((n_stages,), ("stage",)),
                      mode="serve_pipeline", exact=False)
    what = (f"plans serve_pipeline --no-exact {cfg.name} x{cfg.n_layers} "
            f"{n_stages} stages engine (B={b})")
    args = serve_cli.parse_args(["--requests", str(b), "--max-new", "16",
                                 "--stream", "shared-prefix", "--seed", "0"])
    for kv, passes in kvs.items():
        kernel = ("paged_flash_decode_q" if kv == "int8"
                  else "paged_flash_decode")
        engines = {name: ContinuousBatchingEngine(
            model, params, max_batch=b, buckets=serve_cli.BUCKETS,
            kv_dtype=kv, plan=p) for name, p in (("plain", None),
                                                 ("skew", plan))}
        skew = engines["skew"]
        require(skew.sched.n_lane_groups == n_stages
                and skew.kv.shards == n_stages, f"{what}: lane groups "
                f"{skew.sched.n_lane_groups}, ledger shards {skew.kv.shards}")
        for pas in passes:
            streams = {}
            for name, eng in engines.items():
                reqs = serve_cli.make_stream(args, cfg.vocab_size, args.seed)
                t0 = eng.executor.pipeline_ticks
                streams[name], ds, got, wall = _plan_engine_pass(eng, reqs,
                                                                 what)
                steps = ds["decode_steps"]
                if name == "plain":
                    log(f"{what} {kv} {pas}: the plain paged engine: wall_s="
                        f"{wall:.4f} wall_ms_per_decode_step="
                        f"{wall * 1e3 / max(steps, 1):.2f}")
                    continue
                calls = n_stages * steps + ds["prefills"]
                want = {k: cfg.n_layers * n_stages * steps if k == kernel
                        else 0 for k in ATTN_KERNELS}
                have = {k: got[k] for k in ATTN_KERNELS}
                require(have == want, f"{what} {kv} {pas}: launches {have} "
                        f"!= {want}")
                per = _gemms_per_call(cfg, 1, True)
                require(got["gemm"] == per * calls, f"{what} {kv} {pas}: "
                        f"{got['gemm']} gemm launches != {per} x {calls}")
                require(got["row_norm"] == _norms_per_call(cfg) * calls,
                        f"{what} {kv} {pas}: {got['row_norm']} row_norm "
                        "launches")
                ticks = eng.executor.pipeline_ticks - t0
                require(ticks == n_stages * steps + (n_stages - 1)
                        * ds["decode_dispatches"], f"{what} {kv} {pas}: "
                        f"{ticks} ticks")
                for k in (kernel, "row_norm", "gemm"):
                    launches[k] += got[k]
                toks = sum(len(t) for t in streams[name].values())
                log(f"{what} {kv} {pas}: tokens={toks} wall_s={wall:.4f} "
                    f"tok_s={toks / wall:.1f} decode_steps={steps} "
                    f"decode_dispatches={ds['decode_dispatches']} ticks="
                    f"{ticks} wall_ms_per_decode_step="
                    f"{wall * 1e3 / max(steps, 1):.2f} prefix_hits="
                    f"{ds['prefix_hits']} {kernel}_launches={got[kernel]} "
                    f"(= {cfg.n_layers} x {n_stages} groups x {steps})")
                if pas == "hits":
                    require(ds["prefix_hits"] >= len(reqs) - 1,
                            f"{what}: {ds['prefix_hits']} hits")
            require(streams["skew"] == streams["plain"], f"{what} {kv} "
                    f"{pas}: the skewed engine's streams part from the "
                    "plain paged engine's")
        arena = skew._slot_caches["scan"]["b0"]
        per = cfg.n_layers // n_stages
        for name, leaf in arena.items():
            require([t.shape[0] for t in leaf] == [per] * n_stages,
                    f"{what}: {name} stage blocks")
        one = engines["plain"].kv_page_bytes()
        require(skew.kv_page_bytes() * n_stages == one,
                f"{what}: kv_page_bytes {skew.kv_page_bytes()} x {n_stages}"
                f" != {one}")
        log(f"{what} {kv}: streams equal the plain paged engine's "
            f"({', '.join(passes)}); {n_stages} lane groups, a {n_stages}-"
            f"shard page ledger drained; each stage's arena holds {per} "
            f"periods ({tuple(arena['k'][0].shape)}); kv_page_bytes "
            f"{skew.kv_page_bytes()} = {one} / {n_stages}")


def _plan_spec(model, params, plain_streams: dict, launches: dict) -> None:
    """Speculation under the (1, 3) serve plan: smollm-135m drafting for
    itself (spec_k 4, the draft whole on the controller, the verify pass
    per shard), on bf16 and int8 arenas, over the plans' shared-prefix
    requests at 16 new tokens: one device's spec engine must give the
    plan's plain streams (their first 16 tokens; `_spec_run` checks its
    verify launches), and the plan's spec engine the same streams, the
    same spec counters, and one device's kernel launches plus the other
    shards' (2 x 30 a verify pass, warm-up included, and a plain step)."""
    cfg = model.cfg
    plan = build_plan(cfg, make_mesh(PLAN_TP, ("data", "model")),
                      mode="serve")
    n = plan.mesh.shape["model"]
    args = serve_cli.parse_args(["--requests", "8", "--max-new", "32",
                                 "--stream", "shared-prefix", "--seed", "0"])
    reqs = [(r.prompt, 16) for r in
            serve_cli.make_stream(args, cfg.vocab_size, args.seed)]
    spec = dict(draft_model=model, draft_params=params, spec_k=SPEC_K)
    for kv in ("bf16", "int8"):
        kernel = ("paged_flash_decode_q" if kv == "int8"
                  else "paged_flash_decode")
        plain = [list(plain_streams[kv][i][:16]) for i in range(len(reqs))]
        one, s1 = _spec_run("plans smollm-135m self-draft, one device",
                            model, params, reqs, kv, model, params, plain,
                            None, num_pages=None)
        toks, eng, wall, got, _ = _serve_requests(
            model, params, reqs, kv, spec, num_pages=None, plan=plan)
        s = eng.stats
        what = f"plans spec serve {PLAN_TP} {cfg.name} self-draft {kv}"
        require(toks == plain, f"{what}: streams part from the plan's plain "
                "streams")
        keys = [k for k in s if k.startswith("spec_")] + ["decode_steps"]
        require({k: s[k] for k in keys} == {k: s1[k] for k in keys},
                f"{what}: counters {[(k, s[k], s1[k]) for k in keys]}")
        sharded = (s["spec_dispatches"] + len(eng.sched.spec_ladder)
                   + s["decode_steps"] - s["spec_draft_steps"])
        want = one[kernel] + (n - 1) * cfg.n_layers * sharded
        require(got[kernel] == want and not any(
            v for k, v in got.items() if k != kernel),
            f"{what}: launches {got}, want {kernel} {want}")
        launches[kernel] += got[kernel]
        ntok = sum(len(t) for t in toks)
        log(f"{what}: streams equal the plan's plain streams and one "
            f"device's spec streams; tokens={ntok} wall_s={wall:.4f} tok_s="
            f"{ntok / wall:.1f} acceptance="
            f"{s['spec_accepted'] / max(s['spec_proposed'], 1):.4f} "
            f"({s['spec_accepted']}/{s['spec_proposed']}) spec_dispatches="
            f"{s['spec_dispatches']} {kernel}_launches={got[kernel]} (one "
            f"device {one[kernel]} + {n - 1} shards x {cfg.n_layers} x "
            f"{sharded} target passes)")


def _plan_wave(model, params, launches: dict) -> None:
    """The wave engine under the (1, 3) serve plan at EngineBase's
    default buckets (up to 256), 8 prompts of 140-250 tokens and 16 new
    tokens: one wave, whose 8 x 256 prefill rows pass EXACT_ROWS_MAX and
    run in request blocks of 4 (on one device too, so that every product
    stays on the K-ordered gemm); its streams must equal one device's
    wave engine's, and flash_decode launch once per shard a layer a
    step."""
    from repro_torch.models import layers
    from repro_torch.serving.wave import WaveEngine
    cfg = model.cfg
    plan = build_plan(cfg, make_mesh(PLAN_TP, ("data", "model")),
                      mode="serve")
    n = plan.mesh.shape["model"]
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32)
               for k in rng.integers(140, 251, 8)]
    what = f"plans wave serve {PLAN_TP} {cfg.name} x{cfg.n_layers}"
    streams, rows = {}, []
    real = model.prefill

    def spy(p, caches, tokens=None, **kw):
        rows.append(tokens.numel())
        return real(p, caches, tokens=tokens, **kw)

    for name, p in (("one device", None), ("plan", plan)):
        eng = WaveEngine(model, params, max_batch=8, plan=p)
        reqs = [Request(rid=i, prompt=q, max_new_tokens=16)
                for i, q in enumerate(prompts)]
        rows.clear()
        model.prefill = spy
        try:
            streams[name], ds, got, wall = _plan_engine_pass(eng, reqs, what)
        finally:
            del model.prefill
        steps, shards = ds["decode_steps"], 1 if p is None else n
        want = {k: shards * cfg.n_layers * steps if k == "flash_decode"
                else 0 for k in ATTN_KERNELS}
        have = {k: got[k] for k in ATTN_KERNELS}
        require(have == want, f"{what} {name}: launches {have} != {want}")
        require(max(rows) <= layers.EXACT_ROWS_MAX < sum(rows),
                f"{what} {name}: prefill blocks of {rows} rows")
        if p is not None:
            launches["flash_decode"] += got["flash_decode"]
        log(f"{what} {name}: waves={ds['waves']} prefill rows per call "
            f"{rows} decode_steps={steps} wall_s={wall:.4f} "
            f"wall_ms_per_decode_step={wall * 1e3 / max(steps, 1):.2f} "
            f"flash_decode_launches={got['flash_decode']} (= {shards} x "
            f"{cfg.n_layers} x {steps})")
    require(streams["plan"] == streams["one device"],
            f"{what}: the plan's wave streams part from one device's")


def _plan_step(name: str, fn) -> None:
    """fn(), then a log line of the step's wall seconds."""
    t0 = time.perf_counter()
    fn()
    log(f"plans step {name}: {time.perf_counter() - t0:.1f} s")


def plans_phase(dev) -> dict:
    """Multi-device serve plans on the single-controller mesh, every shard
    on the one card (see the module docstring).  Returns the decode
    kernels', row_norm's and gemm's launches."""
    launches = {k: 0 for k in DECODE_KERNELS + ("row_norm", "gemm")}
    _plan_gmi(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
    shard = {}  # kernels 1-3 at the per-shard shapes
    shard["paged_flash_decode"] = [
        kernel_phase(dev, flush, maxp=12, kvh=1, g=3, hd=64),
        kernel_phase(dev, flush, maxp=12, kvh=2, g=4, hd=128)]
    shard["paged_flash_decode_q"] = [
        paged_q_phase(dev, flush, maxp=12, kvh=1, g=3, hd=64),
        paged_q_phase(dev, flush, maxp=12, kvh=2, g=4, hd=128)]
    shard["flash_decode"] = [flash_decode_phase(dev, flush, sk=176, kvh=3,
                                                g=3, hd=64)]
    # a skewed pipeline's lane group: mb = 12 / 6 = 2 lanes a launch
    shard["paged_flash_decode"].append(kernel_phase(
        dev, flush, maxp=12, b=PLAN_SKEW_B // PLAN_STAGES))
    shard["paged_flash_decode_q"].append(paged_q_phase(
        dev, flush, maxp=12, b=PLAN_SKEW_B // PLAN_STAGES))
    del flush
    torch.cuda.empty_cache()
    cfg = get_config(PLAN_ARCH)
    model = make_model(cfg, device=dev)
    params = init_params(cfg, seed=0, device=dev)
    mesh = make_mesh(PLAN_TP, ("data", "model"))
    log(f"plans: mesh {mesh.shape} puts {mesh.size} shards on "
        f"{len(set(mesh.devices))} card(s) ({torch.cuda.device_count()} "
        f"visible): shards share the card, so these runs measure the "
        f"program and its contract, not multi-card scaling")
    served = {}
    for kv in ("bf16", "int8"):
        served[kv] = _plan_serve(model, params, PLAN_TP, kv, launches)
        d = _plan_logits(model, params, PLAN_TP, "int8" if kv == "int8"
                         else "paged", f"plans serve {cfg.name}")
        require(d == 0, f"plans serve {cfg.name} {kv}: logits part")
    d = _plan_logits(model, params, PLAN_TP, "dense",
                     f"plans serve {cfg.name}")
    require(d == 0, f"plans serve {cfg.name} dense slots: logits part")
    _plan_decode_profiles(model, params, PLAN_TP)
    _plan_no_exact(served["bf16"]["cold"][0], model, params, launches)
    _plan_pipeline(model, params, launches)
    plain = {kv: served[kv]["cold"][0] for kv in served}
    _plan_step("spec", lambda: _plan_spec(model, params, plain, launches))
    _plan_step("wave", lambda: _plan_wave(model, params, launches))
    _plan_step("skewed loop",
               lambda: _plan_skew_loop(model, params, launches))
    _plan_step("skewed engine", lambda: _plan_skew_serve(
        model, params, PLAN_STAGES, PLAN_SKEW_B,
        {"bf16": ("cold", "hits"), "int8": ("cold",)}, launches))
    del model, params
    torch.cuda.empty_cache()
    arch, shape, layers = PLAN_BIG
    big = dataclasses.replace(get_config(arch), n_layers=layers)
    model = make_model(big, device=dev)
    params = init_params(big, seed=0, device=dev)
    log(f"plans {arch}: full width, depth cut to {layers} of "
        f"{get_config(arch).n_layers} layers ({big.param_count() / 1e9:.2f} "
        f"B parameters)")
    torch.cuda.reset_peak_memory_stats()
    _plan_serve(model, params, shape, "bf16", launches, passes=("cold",))
    _plan_step(f"skewed engine {arch}", lambda: _plan_skew_serve(
        model, params, PLAN_BIG_STAGES, 8, {"bf16": ("cold",)}, launches))
    log(f"plans {arch}: peak device memory with the plain and the plan "
        f"engine's params "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    d = _plan_logits(model, params, shape, "paged", f"plans serve {arch}")
    require(d == 0, f"plans serve {arch}: logits part (d = {d})")
    del model, params
    torch.cuda.empty_cache()
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--plan", "serve", "--mesh", "1,3", "--dryrun"])
    text = buf.getvalue()
    for marker in ("mode=serve", "paged arena", "scan/b0/mix/wq", "'model'"):
        require(marker in text, f"--dryrun output lacks {marker!r}")
    lines = text.splitlines()
    log(f"plans --dryrun --plan serve --mesh 1,3: {len(lines)} lines, "
        f"e.g. {lines[0]!r} / {[ln for ln in lines if 'mix/wq' in ln][0]!r}")
    launches["shard"] = shard
    return launches


# ---------------------------------------------------------------------------
# the replica fleet and the disaggregated pools
# ---------------------------------------------------------------------------


def _engines(target) -> list:
    """The engines behind a fleet router, or [the engine]."""
    return ([r.engine for r in target.replicas]
            if hasattr(target, "replicas") else [target])


def _fleet_pass(target, reqs, what: str, kernel: str) -> dict:
    """One pass of `reqs` (clones) through an engine or a fleet router,
    the launch counts set to 0 just before its run and read just after:
    `kernel` must launch once per layer per decode step summed over the
    engines, the other attention kernels never, the row norm and gemm
    once a layer's share per backbone call.  Returns the streams of the
    requests run, the engines' summed stats deltas, the launches and the
    wall seconds and TTFTs (ms)."""
    engines = _engines(target)
    for r in clone_requests(reqs):
        target.submit(r)
    s0 = [dict(e.stats) for e in engines]
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = target.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.launches)
    ds = {}
    for e, st0 in zip(engines, s0):
        for k, v in e.stats.items():
            if isinstance(v, int):
                ds[k] = ds.get(k, 0) + v - st0.get(k, 0)
    require(all(r.done and (len(r.tokens_out) == r.max_new_tokens
                            or r.tokens_out[-1] == r.eos_id) for r in done),
            f"{what}: a request stopped short of its budget")
    cfg = engines[0].model.cfg
    steps, calls = ds["decode_steps"], ds["decode_steps"] + ds["prefills"]
    want = {k: cfg.n_layers * steps if k == kernel else 0
            for k in ATTN_KERNELS}
    have = {k: got[k] for k in ATTN_KERNELS}
    require(have == want, f"{what}: launches {have} != {want}")
    require(got["row_norm"] == _norms_per_call(cfg) * calls,
            f"{what}: {got['row_norm']} row_norm launches")
    per = 7 * cfg.n_layers + 1  # q, k, v, o, wi, wg, wo a layer; the head
    require(got["gemm"] == per * calls,
            f"{what}: {got['gemm']} gemm launches != {per} x {calls} calls")
    toks = sum(len(r.tokens_out) for r in done)
    ttft = sorted((r.t_first_token - r.t_enqueue) * 1e3 for r in done)
    log(f"{what}: requests={len(done)} tokens={toks} wall_s={wall:.4f} "
        f"tok_s={toks / wall:.1f} ttft_p50_ms={ttft[len(ttft) // 2]:.2f} "
        f"decode_steps={steps} prefills={ds['prefills']} "
        f"prefix_hits={ds.get('prefix_hits', 0)} {kernel}_launches="
        f"{got[kernel]} (= {cfg.n_layers} x {steps}) row_norm_launches="
        f"{got['row_norm']} gemm_launches={got['gemm']}")
    return dict(streams={r.rid: tuple(r.tokens_out) for r in done},
                stats=ds, launches={k: got[k] for k in
                                    ATTN_KERNELS + ("row_norm", "gemm")},
                wall=wall, tok_s=toks / wall, ttft=ttft)


def _bytes_per_page(caches) -> dict:
    """Bytes one page holds in each kind of paged arena leaf, summed over
    the blocks."""
    out = {}

    def add(ax, name, leaf):
        out[name] = out.get(name, 0) + (leaf.numel() // leaf.shape[ax]
                                        * leaf.element_size())

    paged_cache_map(add, caches)
    return out


def _device_types(tree) -> set:
    if isinstance(tree, dict):
        return set().union(*(_device_types(v) for v in tree.values()))
    return {tree.device.type}


def _on_card(eng, what: str) -> None:
    """No replica or pool quietly on the CPU: the executor's device, every
    param leaf and (under disagg) the prefill pool's are the card's."""
    ex = eng.executor
    devs = {ex.device.type} | _device_types(ex.params)
    if eng.disagg is not None:
        require(ex.prefill_model is not None, f"{what}: no prefill pool")
        devs |= {ex.prefill_model.device.type} | _device_types(
            ex.prefill_params)
    require(devs == {"cuda"}, f"{what}: devices {devs}")


def fleet_phase(dev) -> dict:
    """The replica fleet (serving/router.py, serving/replica.py) and the
    disaggregated prefill/decode pools (engine disagg=(1, 1)) on
    smollm-135m x30 at full width (init_params seed 0, the serve phase's
    weights), every replica and pool on the one card.  Returns the
    launches of the decode kernels, row_norm and gemm."""
    launches = {k: 0 for k in DECODE_KERNELS + ("row_norm", "gemm")}

    def add(res):
        for k, v in res["launches"].items():
            if k in launches:
                launches[k] += v
        return res

    cfg = get_config("smollm-135m")
    model = make_model(cfg, device=dev)
    params = init_params(cfg, seed=0, device=dev)
    # deadline 0: strict FIFO admission (disaggregated colds are all
    # overdue, so FIFO too), whatever the host's speed: each request takes
    # the same path (cold or radix hit) and the same decode steps in
    # every engine it is compared across
    kw = dict(max_batch=FLEET_B, buckets=serve_cli.BUCKETS, deadline_s=0.0)
    reqs = multi_prefix_requests(
        np.random.default_rng(0), 16, cfg.vocab_size, n_prefixes=4,
        prefix_len=64, suffix_range=(4, 12), budgets=16)
    k1 = "paged_flash_decode"
    # (a) the fleet against the plain engine; a margin past any backlog
    # here keeps every prefix group on one replica, so each request takes
    # the plain engine's path (cold or radix hit)
    aff = router.FleetConfig(route="affinity",
                             rebalance_margin=FLEET_MARGIN)
    plain = add(_fleet_pass(ContinuousBatchingEngine(model, params, **kw),
                            reqs, "fleet plain engine", k1))
    want = plain["streams"]
    hits = {}
    for n, route in ((1, "affinity"), (2, "affinity"), (2, "round-robin")):
        fleet = router.build_fleet(
            model, params, n, config=dataclasses.replace(aff, route=route),
            **kw)
        what = f"fleet {n} replica(s) {route}"
        res = add(_fleet_pass(fleet, reqs, what, k1))
        for e in _engines(fleet):
            _on_card(e, what)
        st = fleet.stats()
        log(f"{what}: by_kind={st['by_kind']} prefix_hits="
            f"{st['prefix_hits']} per replica " + ", ".join(
                f"{p['replica']}: routed={p['routed']} hits="
                f"{p['prefix_hits']} prefills={p['prefills']}"
                for p in st["replicas"]))
        hits[(n, route)] = st["prefix_hits"]
        if route == "affinity":
            require(res["streams"] == want,
                    f"{what}: streams part from the plain engine's")
    require(hits[(2, "affinity")] > hits[(2, "round-robin")],
            f"fleet: affinity hits {hits[(2, 'affinity')]} <= round-robin's "
            f"{hits[(2, 'round-robin')]}")
    # (b) each replica under a 1x1 serve plan on its own device group;
    # the one card listed twice
    groups = replica.replica_device_groups(2, 1, devices=[dev, dev])
    plans = [build_plan(cfg, replica.make_group_mesh(
        g, (1, 1), ("data", "model")), mode="serve") for g in groups]
    fleet = router.build_fleet(model, params, 2, plans=plans, config=aff,
                               **kw)
    res = add(_fleet_pass(fleet, reqs, "fleet 2 plan-placed replicas", k1))
    for e in _engines(fleet):
        _on_card(e, "fleet plan-placed replica")
    require(res["streams"] == want,
            "fleet plan-placed: streams part from the plain engine's")
    # (c) shedding: all 16 submitted at once, one queued request a replica
    fleet = router.build_fleet(
        model, params, 2, config=dataclasses.replace(aff, shed_depth=1),
        **kw)
    res = add(_fleet_pass(fleet, reqs, "fleet shed_depth=1", k1))
    require(fleet.shed and all("saturated" in why for _, why in fleet.shed),
            f"fleet shed_depth=1: shed {len(fleet.shed)}")
    require(len(res["streams"]) + len(fleet.shed) == len(reqs),
            "fleet shed_depth=1: requests lost")
    require(all(want[rid] == t for rid, t in res["streams"].items()),
            "fleet shed_depth=1: a served stream parts from the plain "
            "engine's")
    log(f"fleet shed_depth=1: served {len(res['streams'])}, shed "
        f"{len(fleet.shed)}, e.g. {fleet.shed[0][1]!r}")
    # (d) disaggregated pools (1, 1) against colocated serving, on pages
    # of 8 rows, so that a replayed short prompt (10-15 tokens) finds a
    # whole page in the radix tree
    burst = bursty_requests(
        np.random.default_rng(0), 12, cfg.vocab_size, short_range=(10, 16),
        long_range=(180, 240), burst_every=4, burst_size=2, budgets=(8, 16))
    for kv, kernel in (("bf16", k1), ("int8", "paged_flash_decode_q")):
        dkw = dict(kw, buckets=serve_cli.stream_buckets(burst), kv_dtype=kv,
                   page_size=8)
        colo = ContinuousBatchingEngine(model, params, **dkw)
        dis = ContinuousBatchingEngine(model, params, disagg=(1, 1), **dkw)
        _on_card(dis, f"fleet disagg {kv}")
        for pas in ("cold", "replay"):
            c = add(_fleet_pass(colo, burst, f"fleet colocated {kv} {pas}",
                                kernel))
            d = add(_fleet_pass(dis, burst, f"fleet disagg (1, 1) {kv} {pas}",
                                kernel))
            what = f"fleet disagg {kv} {pas}"
            require(d["streams"] == c["streams"],
                    f"{what}: streams part from colocated serving's")
            require(d["launches"][kernel] == c["launches"][kernel],
                    f"{what}: {kernel} launches {d['launches'][kernel]} != "
                    f"colocated {c['launches'][kernel]}")
            s = d["stats"]
            # the bytes gathered off the staging arena's leaves (padding
            # pages included) against the decode arena's own bytes a page
            gathered = dict(dis.executor.gathered)
            dis.executor.gathered.update(pages=0, bytes=0)
            per_page = _bytes_per_page(dis._slot_caches)
            require(s["shipped_pages"] <= gathered["pages"]
                    < 2 * max(s["shipped_pages"], 1)
                    and gathered["bytes"] == gathered["pages"]
                    * sum(per_page.values())
                    and dis.kv_page_bytes() == sum(
                        v for k, v in per_page.items() if k != "kpos"),
                    f"{what}: gathered {gathered} for "
                    f"{s['shipped_pages']} pages shipped; bytes a page "
                    f"{per_page}, kv_page_bytes {dis.kv_page_bytes()}")
            if pas == "cold":
                require(s["ship_dispatches"] == s["prefills"] == len(burst)
                        and s["shipped_pages"] > 0,
                        f"{what}: ships {s['ship_dispatches']}, prefills "
                        f"{s['prefills']}")
            else:
                require(s["prefix_hits"] > 0 and s["ship_dispatches"] == 0,
                        f"{what}: hits {s['prefix_hits']}, ships "
                        f"{s['ship_dispatches']}")
            dis.kv.assert_drained()
            dis.kv_prefill.assert_drained()
            log(f"{what} (pools share one card: the program's figures, not "
                f"a scaling result): colocated tok_s={c['tok_s']:.1f} "
                f"ttft_p50_ms={c['ttft'][len(c['ttft']) // 2]:.2f}; "
                f"disaggregated tok_s={d['tok_s']:.1f} ttft_p50_ms="
                f"{d['ttft'][len(d['ttft']) // 2]:.2f}; ship_dispatches="
                f"{s['ship_dispatches']} shipped_pages={s['shipped_pages']}"
                f" shipped_bytes={s['shipped_bytes']} (kv_page_bytes); "
                f"gathered pages={gathered['pages']} (padding included) "
                f"bytes={gathered['bytes']} (kpos too)")
    del model, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# plan search
# ---------------------------------------------------------------------------


def _calibrate(eng, reps: int = 3, ns=(1, 8)):
    """The two-point decode calibration (the reference's
    `benchmarks/run.py` `_calibrate_engine`) on one engine's executor:
    its fused n-step dispatch timed at n = 1 and 8 on probe caches (the
    serving caches untouched), and one batch-1 prefill at the largest
    bucket."""
    ex = eng.executor
    pargs = ((eng.page_size, eng.kv.num_pages, eng.max_pages,
              eng.kv_dtype) if eng.paged else ())
    st = ex.fresh_state(ex.init_caches(eng.paged, *pargs), eng.paged)
    t = {}
    for n in ns:
        ex.decode(st, n, eng.paged).cpu()  # warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ex.decode(st, n, eng.paged).cpu()
            ts.append(time.perf_counter() - t0)
        t[n] = float(np.median(ts))
    log(f"plansearch calibration probes: fused decode n={ns[0]} "
        f"{t[ns[0]] * 1e3:.4f} ms, n={ns[1]} {t[ns[1]] * 1e3:.4f} ms "
        f"(median of {reps})")
    prompt = [[1] * (max(eng.buckets) - 1)]
    ex.prefill_prompts(prompt, 1, bucket_cache=True)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ex.prefill_prompts(prompt, 1, bucket_cache=True)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return plan_search.DeviceCalibration.from_two_point(
        t[ns[0]], ns[0], t[ns[1]], ns[1], t_prefill=float(np.median(ts)))


def _served_pass(argv, what: str, **engine_kw) -> dict:
    """serve.serve on argv, the launch counts set to 0 just before and
    read just after: paged_flash_decode_q must launch once per layer per
    decode step summed over the engines, the other attention kernels
    never.  Returns the engines, streams, launches, tokens and wall."""
    args = serve_cli.parse_args(argv)
    torch.cuda.synchronize()
    ops.reset_launches()
    target, done, wall = serve_cli.serve(args, **engine_kw)
    torch.cuda.synchronize()
    got = dict(ops.launches)
    engines = _engines(target)
    steps = sum(e.stats["decode_steps"] for e in engines)
    cfg = engines[0].model.cfg
    require(len(done) == args.requests
            and all(r.done and (len(r.tokens_out) == r.max_new_tokens
                                or r.tokens_out[-1] == r.eos_id)
                    for r in done),
            f"{what}: a request did not finish its budget")
    k2 = "paged_flash_decode_q"
    want = {k: cfg.n_layers * steps if k == k2 else 0 for k in ATTN_KERNELS}
    have = {k: got[k] for k in ATTN_KERNELS}
    require(steps > 0 and have == want,
            f"{what}: launches {have} != {want}")
    toks = sum(len(r.tokens_out) for r in done)
    log(f"{what}: engines={len(engines)} requests={len(done)} tokens={toks}"
        f" wall_s={wall:.4f} tok_s={toks / wall:.1f} decode_steps={steps} "
        f"{k2}_launches={got[k2]} (= {cfg.n_layers} x {steps}) "
        f"row_norm_launches={got['row_norm']} gemm_launches={got['gemm']}")
    return dict(args=args, engines=engines, done=done, wall=wall, toks=toks,
                streams={r.rid: tuple(r.tokens_out) for r in done},
                launches={k: got[k] for k in ATTN_KERNELS
                          + ("row_norm", "gemm")})


def plansearch_phase(dev) -> dict:
    """The plan search (core/plan_search.py) for smollm-135m under the
    H100 table at 1, 2 and 4 devices of the card's memory, then the
    devices-2 choice served through `serve.serve` (--plan auto
    --traffic), gated against one plain engine, then the reference's
    two-point calibration and its prediction beside the measured tok/s.
    Returns the launches of the served streams."""
    card = _card()
    total = torch.cuda.get_device_properties(dev).total_memory
    hbm_gb = total / (1 << 30)
    log(f"plansearch: {card}; total_memory {total} B = {hbm_gb:.6f} GiB "
        f"(plan_search.CARD_HBM_BYTES {plan_search.CARD_HBM_BYTES}); "
        f"HardwareModel {dataclasses.asdict(plan_search.HardwareModel())}")
    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    costs = plan_search.block_costs(cfg)
    log(f"plansearch block_costs (fake-tensor count, host): "
        f"{time.perf_counter() - t0:.1f} s {dataclasses.asdict(costs)}")
    results = {}
    for n in (1, 2, 4):
        prof = plan_search.TrafficProfile(name=f"devices{n}", devices=n,
                                          hbm_gb=hbm_gb)
        res = results[n] = plan_search.search(cfg, prof)
        ch = res.chosen
        require(ch is not None, f"plansearch devices={n}: nothing feasible")
        log(f"plansearch devices={n}: {len(res.scores)} candidates, "
            f"{res.n_feasible} feasible, frontier "
            f"{[s.key for s in res.frontier]}; chosen {ch.key} "
            f"pred_tok_s={ch.tok_s:.3f} pred_ttft_ms={ch.ttft_ms:.4f} "
            f"pred_hbm_frac={ch.hbm_frac:.6f}")
    choice = results[2].chosen
    cand = choice.cand
    fd, path = tempfile.mkstemp(suffix=".json", prefix="plansearch_")
    with os.fdopen(fd, "w") as f:
        json.dump(results[2].profile.to_dict(), f)
    try:
        base = ["--requests", "16", "--max-new", "32"]
        # FIFO admission, as the fleet phase: each request takes the same
        # path and decode steps in both engines
        auto = _served_pass(base + ["--plan", "auto", "--traffic", path],
                            "plansearch --plan auto", deadline_s=0.0)
    finally:
        os.unlink(path)
    require(auto["args"].chosen.key == choice.key,
            f"plansearch: the CLI chose {auto['args'].chosen.key}, the "
            f"search {choice.key}")
    engines = auto["engines"]
    require(len(engines) == choice.replicas
            and all(e.paged and e.page_size == cand.page_size
                    and e.kv_dtype == cand.kv_dtype
                    and e.executor.device.type == "cuda" for e in engines),
            f"plansearch: engines "
            f"{[(e.page_size, e.kv_dtype) for e in engines]} do not carry "
            f"the choice {choice.key}")
    plain = _served_pass(base + ["--plan", "none", "--page-size",
                                 str(cand.page_size), "--kv-dtype",
                                 cand.kv_dtype]
                         + (["--quant-weights"] if cand.quant_weights
                            else []),
                         "plansearch plain engine", deadline_s=0.0)
    require(auto["streams"] == plain["streams"],
            "plansearch: the chosen plan's streams part from the plain "
            "engine's")
    calib = _calibrate(engines[0])
    done = auto["done"]
    measured = auto["toks"] / auto["wall"]
    # the replicas share one card and one host thread: the stream costs
    # what one engine of their lanes serving all of it costs
    pred = plan_search.predict_engine_tok_s(
        calib, n_requests=len(done), total_tokens=auto["toks"],
        prompt_tokens=sum(len(r.prompt) for r in done),
        max_batch=engines[0].max_batch,
        horizon=engines[0].sched.decode_horizon)
    ratio = pred / measured
    nums = (calib.t_step_s, calib.t_dispatch_s, calib.t_prefill_s, pred,
            measured, ratio)
    require(all(np.isfinite(v) for v in nums),
            f"plansearch: calibration or prediction not finite {nums}")
    log(f"plansearch calibration ({card}; one replica of {choice.key}, "
        f"B={engines[0].max_batch}): t_step_ms={calib.t_step_s * 1e3:.4f} "
        f"t_dispatch_ms={calib.t_dispatch_s * 1e3:.4f} "
        f"t_prefill_ms={calib.t_prefill_s * 1e3:.4f} (bucket "
        f"{max(engines[0].buckets)}); predict_engine_tok_s={pred:.2f} "
        f"measured_tok_s={measured:.2f} ratio={ratio:.4f} in "
        f"PREDICTION_BAND {plan_search.PREDICTION_BAND}: "
        f"{plan_search.prediction_ratio_ok(ratio)}; the search's own "
        f"pred_tok_s for the declared profile={choice.tok_s:.3f}")
    torch.cuda.empty_cache()
    return {k: auto["launches"][k] + plain["launches"][k]
            for k in auto["launches"]}


# ---------------------------------------------------------------------------
# the MoE families
# ---------------------------------------------------------------------------


class _RouteTally:
    """Records the keep mask (B, S*k) of every `moe.route` call while
    installed (a pass-through around the port's function, which `moe_ffn`
    looks up at each call)."""

    def __enter__(self):
        self.calls = []
        self.orig = moe.route

        def spy(x, p, cfg, columns=False):
            r = self.orig(x, p, cfg, columns)
            self.calls.append(dict(keep=r.keep.cpu()))
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        moe.route = self.orig


def _moe_verify(model, params, seed: int) -> dict:
    """One verify block (T = SPEC_K + 1) after 8 admitted prompts against
    T chained decode_step calls from an identical cache, as
    `_verify_vs_chained`, with the block's routing tallied: a MoE layer
    routes each lane's T tokens as one group at the capacity of S = T
    (the reference's verify pass), so a dropped pair parts its row from
    the chained steps, which never drop.  A (lane, column) row is clean
    when its lane dropped no pair at that column or before it in any
    layer: its routing and its inputs are the chained steps', so it must
    equal them bit for bit."""
    cfg = model.cfg
    ps, maxp, t = 16, 4, SPEC_K + 1
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(6, 40, 8)]
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (8, t)),
                          dtype=torch.int32, device=model.device)
    with torch.no_grad():
        cache, _ = _admitted(model, params, prompts, ps, maxp, "paged")
        steps = []
        for j in range(t):
            lg, cache = model.decode_step(params, cache, tokens[:, j])
            steps.append(lg)
        chained = torch.stack(steps, 1)
        cache, _ = _admitted(model, params, prompts, ps, maxp, "paged")
        with _RouteTally() as tally:
            ver, _ = model.verify_block(params, cache, tokens)
    drop = torch.zeros((8, t), dtype=torch.bool)
    for c in tally.calls:
        drop |= ~c["keep"].reshape(8, t, cfg.top_k).all(-1)
    dirty = torch.cummax(drop.to(torch.int32), 1).values.bool()
    diff = (ver - chained).abs().amax(-1).cpu()
    return dict(d=float(diff.max()), clean=int((~dirty).sum()),
                d_clean=float(diff[~dirty].max()) if (~dirty).any() else 0.0,
                d_dirty=float(diff[dirty].max()) if dirty.any() else 0.0,
                dropped=sum(int((~c["keep"]).sum()) for c in tally.calls),
                pairs=sum(c["keep"].numel() for c in tally.calls))


def _bmm_device_us(prof) -> float:
    """Device time (us) of the window's aten::bmm ops, the MoE expert
    products (a decode step's other products are 2-d matmuls)."""
    for row in prof.key_averages():
        if row.key == "aten::bmm":
            return float(getattr(row, "device_time_total", None)
                         or getattr(row, "cuda_time_total", 0.0))
    return 0.0


def _moe_profile(model, params) -> None:
    """8 fused decode steps over 8 admitted prompts on a paged bf16
    arena, warm, under torch.profiler: device ops a step, the device's
    busy share, the expert products' share of device time, and the
    expert bytes a step reads against their bound.  The dispatch is
    dense (the reference's): every expert computes its capacity's slots
    at every step, so a step reads every expert's three matrices."""
    cfg = model.cfg
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(8, 60, 8)]
    act = torch.ones((8,), dtype=torch.bool, device=model.device)
    n_moe = sum(map(cfg.is_moe_layer, range(cfg.n_layers)))
    nbytes = n_moe * cfg.n_experts * cfg.ffn_params() * 2
    what = (f"moe {cfg.name} x{cfg.n_layers} 8 fused decode steps (B=8, "
            "paged bf16)")
    out = {}
    with torch.no_grad():
        big, lg = _admitted(model, params, prompts, 16, 12, "paged")
        first = lg.argmax(-1).to(torch.int32)
        model.decode_steps(params, big, first, act, 8)  # warm
        big, lg = _admitted(model, params, prompts, 16, 12, "paged")
        spans, wall_us = _device_spans(
            lambda: model.decode_steps(params, big, first, act, 8), out)
    if not spans:
        log(f"profile {what}: the profiler recorded no device time (not "
            "measured)")
        return
    dev_total = sum(e - s for s, e, _ in spans)
    ks = [e - s for s, e, name in spans if "paged_flash_decode_kernel" in name]
    n = cfg.n_layers * 8
    require(0 < len(ks) <= n, f"profile {what}: {len(ks)} paged_flash_decode"
            f" kernel spans, {n} launches")
    bmm_us = _bmm_device_us(out["prof"])
    busy = _busy_us(spans) / wall_us
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    step_ms = bmm_us / 8 / 1e3
    log(f"profile {what}: wall_ms={wall_us / 1e3:.2f} wall_ms_per_step="
        f"{wall_us / 8e3:.3f} device_busy_share={busy:.4f} "
        f"device_kernel_ms={dev_total / 1e3:.3f} device_ops_per_step="
        f"{len(spans) / 8:.1f} expert_gemm_ms_per_step={step_ms:.3f} "
        f"expert_gemm_share_of_device={bmm_us / dev_total:.4f} "
        f"expert_bytes_per_step={nbytes} ({n_moe} MoE layers x "
        f"{cfg.n_experts} experts x 3 matrices; bound {bound_ms:.3f} ms at "
        f"{HBM_BYTES_S:.3g} B/s, read at "
        f"{nbytes / max(step_ms, 1e-9) / 1e9:.4g} TB/s = "
        f"{bound_ms / max(step_ms, 1e-9):.3f} of the bound) "
        f"paged_flash_decode_spans={len(ks)} of {n} launches")


def _first_layers(tree, n: int, scan: bool = False):
    """A params tree with every scan leaf narrowed to its first n layer
    periods (views, no copy), for a model of fewer layers on the same
    weights."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n, scan or k == "scan")
                for k, v in tree.items()}
    return tree.narrow(0, 0, n) if scan else tree


def _moe_plan_step(model, params, shape, exact: bool, base=None) -> dict:
    """A MoE model under a mode="serve" plan on `shape`, every shard on
    the card: one paged bf16 state of 8 admitted lanes (`_skew_state`:
    odd lanes in the radix-hit form) through a one-device executor and
    through the plan's, each running 8 fused decode steps, then one more
    step fed the same tokens for its logits.  Exact: tokens and logits
    equal one device's (d = 0), and a step launches paged_flash_decode
    n x L times, row_norm 2 L + 1 and gemm `_gemms_per_call`; the
    placement's card memory, each route's wall ms and device ops a step
    (profiled, 1 fused step), and the expert bytes a step logged.
    exact=False (`base`: the exact step's result): the token match and
    the logits' max |d| against it, logged.  Returns {"tokens",
    "logits", "launches"}."""
    cfg, steps = model.cfg, 8
    n = shape[1]
    form = "exact" if exact else "no-exact"
    what = f"moe plan serve {form} {cfg.name} x{cfg.n_layers} mesh {shape}"
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    plan = build_plan(cfg, make_mesh(shape, ("data", "model")),
                      mode="serve", exact=exact)
    runs = {}
    for name, p in (("one device", None), ("plan", plan)):
        ex = Executor(model, params, max_batch=8, cache_len=16 * 12,
                      buckets=serve_cli.BUCKETS, plan=p)
        if p is not None:
            torch.cuda.synchronize()
            placed = torch.cuda.memory_allocated() - held
            ffn = next(b["ffn"] for b in ex.params["scan"].values()
                       if "router" in b.get("ffn", {}))
            require([t.shape[1] for t in ffn["wi"]] == [cfg.n_experts // n]
                    * n and isinstance(ffn["wo"], list) != exact,
                    f"{what}: experts placed as {[tuple(t.shape) for t in ffn['wi']]}"
                    f", wo {'whole' if exact else 'by expert'} wanted")
        st = _skew_state(model, ex, 8, 16, 12, 23)
        toks, wall, got = _launched(lambda: ex.decode(st, steps, True))
        with torch.no_grad(), ex._ctx():
            lg, _ = model.decode_step(ex.params, st["caches"], st["cur"],
                                      active=st["active"])
        runs[name] = dict(tokens=toks.cpu(), logits=lg.float().cpu(),
                          wall=wall, launches=got, ex=ex, st=st)
    one, run = runs["one device"], runs["plan"]
    d = (run["logits"] - one["logits"]).abs().max().item()
    got = run["launches"]
    if exact:
        require(torch.equal(run["tokens"], one["tokens"]), f"{what}: "
                "tokens part from one device's")
        require(d == 0, f"{what}: logits part from one device's by {d:.4g}")
        want = {"paged_flash_decode": n * cfg.n_layers * steps,
                "row_norm": _norms_per_call(cfg) * steps,
                "gemm": _gemms_per_call(cfg, n, True) * steps}
        have = {k: got[k] for k in want}
        require(have == want and not any(
            got[k] for k in ATTN_KERNELS if k != "paged_flash_decode"),
            f"{what}: launches {got} != {want}")
        check = "tokens and logits equal one device's (d = 0)"
    else:
        match = (run["tokens"] == base["tokens"]).float().mean().item()
        d = (run["logits"] - base["logits"]).abs().max().item()
        check = (f"token match against the exact plan {match:.4f}, max "
                 f"|logits - exact| = {d:.4g} (logged: the row blocks of "
                 "attention's wo and of shared_wo add their f32 partial sums "
                 "in shard order)")
    n_moe = sum(map(cfg.is_moe_layer, range(cfg.n_layers)))
    nbytes = n_moe * cfg.n_experts * cfg.ffn_params() * 2
    log(f"{what}: {steps} fused steps on 8 lanes, {check}; launches a step "
        f"paged_flash_decode={got['paged_flash_decode'] // steps} row_norm="
        f"{got['row_norm'] // steps} gemm={got['gemm'] // steps} (one "
        f"device: {one['launches']['paged_flash_decode'] // steps}, "
        f"{one['launches']['row_norm'] // steps}, "
        f"{one['launches']['gemm'] // steps}); wall_ms_per_step="
        f"{run['wall'] * 1e3 / steps:.2f} (one device "
        f"{one['wall'] * 1e3 / steps:.2f}); the placement's copies "
        f"{placed / 2 ** 30:.2f} GiB, card peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
        f"expert_bytes_per_step={nbytes} (one device's: each shard reads "
        f"its own {cfg.n_experts // n} experts once)")
    for name, r in runs.items():
        _route_profile(f"{what}, {name}, 1 fused step (B=8)",
                       lambda: r["ex"].decode(r["st"], 1, True), 1)
    log(f"{what}: {time.perf_counter() - t0:.1f} s")
    return dict(tokens=run["tokens"], logits=run["logits"],
                launches={k: got[k] for k in ("paged_flash_decode",
                                              "row_norm", "gemm")})


def moe_phase(dev) -> dict:
    """moonshot-v1-16b-a3b and llama4-maverick-400b-a17b on the card at
    full width on init_params weights (seed 0): card vs CPU (model_phase,
    paged; routing compared); served through the paged cb engine
    (moonshot at all 48 layers, llama4 at its 2-layer period) with exact
    launch counts; one verify block against its chained decode steps,
    logged, d = 0 required on its clean rows; 8 fused decode steps
    profiled; moonshot's first MOE_PIPELINE_LAYERS on 6 drained and 6
    skewed pipeline stages (`family_pipeline`).  Returns the decode kernels', row_norm's and the
    pipelines' gemm launches."""
    launches = {"paged_flash_decode": 0, "row_norm": 0, "flash_decode": 0,
                "gemm": 0}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    torch.cuda.empty_cache()
    log(f"moe: card memory allocated before the phase "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB (peak so far "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB); host "
        f"{_mem_available_gib():.1f} GiB available")
    for i, arch in enumerate(MOE_ARCHS):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        n = MOE_LAYERS.get(arch, cfg.n_layers)
        cut = dataclasses.replace(cfg, n_layers=n)
        depth = f"x{n}" + (f" (depth cut from {cfg.n_layers})"
                           if n != cfg.n_layers else "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        model = make_model(cut, device=dev)
        params = init_params(cut, seed=0, device=dev)
        torch.cuda.synchronize()
        log(f"moe {arch} {depth}: {_n_params(params) / 1e9:.3f} B "
            f"parameters, init {time.perf_counter() - t1:.1f} s, init peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        for k, v in family_serve(model, params, i, "moe").items():
            launches[k] += v
        v = _moe_verify(model, params, 2)
        log(f"moe {arch} {depth}: max |verify_block - {SPEC_K + 1} chained "
            f"decode_step| logits = {v['d']:.4g} (logged: the reference's "
            f"MoE verify routes the block's {SPEC_K + 1} tokens as one "
            f"group at capacity {moe._capacity(cut, SPEC_K + 1)} and parts "
            f"from its chained steps by design); the block dropped "
            f"{v['dropped']} of {v['pairs']} (token, choice) pairs; "
            f"{v['clean']} of {8 * (SPEC_K + 1)} (lane, column) rows clean "
            f"(no drop there or before), d there = {v['d_clean']:.4g} "
            f"(want 0); d on the others = {v['d_dirty']:.4g}")
        require(v["d_clean"] == 0, f"moe {arch}: a verify row with no "
                "dropped pair parts from the chained decode steps")
        _moe_profile(model, params)
        if layer_plan(cut)[0] % PLAN_STAGES == 0:  # not llama4's one period
            pipe_cfg = dataclasses.replace(cut, n_layers=MOE_PIPELINE_LAYERS)
            pipe_model = make_model(pipe_cfg, device=dev)
            pipe_params = _first_layers(params, layer_plan(pipe_cfg)[0])
            for skewed in (False, True):
                _plan_step(f"moe pipeline {arch} x{MOE_PIPELINE_LAYERS} "
                           f"{'skewed' if skewed else 'drained'}",
                           lambda: add(family_pipeline(
                               pipe_model, pipe_params, skewed)))
            del pipe_model, pipe_params
        layers, shapes = MOE_PLAN[arch]
        tp_cfg = dataclasses.replace(cut, n_layers=layers)
        tp_model = make_model(tp_cfg, device=dev)
        tp_params = _first_layers(params, layer_plan(tp_cfg)[0])
        if shapes[0] != (1, 2):  # the narrowest mesh keeps FSDP
            kept = build_plan(tp_cfg, make_mesh((1, 2), ("data", "model")),
                              mode="serve").fsdp
            require(kept, f"moe serve plan {arch} x{layers} (1, 2): FSDP "
                    "dropped, so MOE_PLAN can serve it exact")
            log(f"moe serve plan {arch} x{layers} (1, 2): the plan keeps "
                f"FSDP ({tp_cfg.param_count() * 2 / 2e9:.1f} GB of weights "
                "a shard, past the 8 GB line), so its exact plan's "
                "reductions are row blocks (psum form) and its bits are "
                f"not one device's; gated on {shapes} instead")
        exact = {}
        for shape in shapes:
            _plan_step(f"moe serve plan {arch} x{layers} {shape}",
                       lambda: exact.setdefault(shape, _moe_plan_step(
                           tp_model, tp_params, shape, True)))
            add(exact[shape]["launches"])
        if arch in MOE_NO_EXACT:
            shape = shapes[0]
            _plan_step(f"moe serve plan {arch} x{layers} {shape} no-exact",
                       lambda: add(_moe_plan_step(
                           tp_model, tp_params, shape, False,
                           exact[shape])["launches"]))
        del model, params, tp_model, tp_params
        torch.cuda.empty_cache()
        log(f"moe {arch}: {time.perf_counter() - t0:.1f} s; card peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    return launches


# the train phase: smollm-135m at full width through the train CLI
TRAIN_ARCH = "smollm-135m"
TRAIN_ARGS = ("--arch", TRAIN_ARCH, "--batch", "8", "--seq", "512",
              "--seed", "0")
TRAIN_FAIL_AT = 15


def _train_run(argv, ckpt_dir: str) -> tuple:
    """`train.main(argv)` with the launch counts set to 0 just before and
    read just after: (its result, the launches, wall seconds)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = train_cli.main(list(TRAIN_ARGS) + list(argv)
                         + ["--ckpt-dir", ckpt_dir])
    torch.cuda.synchronize()
    return out, dict(ops.launches), time.perf_counter() - t0


def _require_train_launches(what: str, cfg, got: dict, steps: int) -> int:
    """row_norm 4n + 1 a step (the forward's 2n + 1 and the remat
    recompute's 2n; its backward is the plain version's), no other
    kernel (recorded products run in torch.matmul, S <= 1,024 on the
    dense attention route).  Returns the row_norm launches."""
    per = _norms_per_call(cfg) + 2 * cfg.n_layers
    others = {k: v for k, v in got.items() if k != "row_norm" and v}
    require(got["row_norm"] == per * steps and not others,
            f"{what}: launches {got}, want row_norm {per} x {steps} steps "
            "and nothing else")
    return got["row_norm"]


def _verify_checkpoint(mgr, step: int) -> int:
    """Every leaf file's sha256 against the manifest; returns the bytes
    read."""
    import hashlib
    d = os.path.join(mgr.dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    total = 0
    for key, meta in manifest["leaves"].items():
        with open(os.path.join(d, meta["file"]), "rb") as f:
            raw = f.read()
        total += len(raw)
        require(hashlib.sha256(raw).hexdigest() == meta["sha256"],
                f"checkpoint step {step}: {key}'s checksum fails")
    return total


def train_phase(dev) -> dict:
    """Training on the card through the train CLI (module docstring, phase
    17).  Returns the CLI runs' row_norm launches."""
    cfg = get_config(TRAIN_ARCH)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        out, got, wall = _train_run(
            ["--steps", "30", "--ckpt-every", "10", "--inject-failure-at",
             str(TRAIN_FAIL_AT), "--optimizer", "adamw"],
            os.path.join(root, "adamw"))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        what = f"train {cfg.name} x{cfg.n_layers} adamw"
        rep, losses = out["report"], out["losses"]
        require((rep.restarts, rep.failed_steps, rep.recovered_from,
                 rep.completed_steps) == (1, [TRAIN_FAIL_AT], [10], 30),
                f"{what}: recovery report {rep}, want exactly the injected "
                "failure's (a restart hides no fault of the program)")
        require(len(losses) == 35 and all(np.isfinite(losses)),
                f"{what}: {len(losses)} losses, want 35 finite (steps 10-14 "
                "replayed)")
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        require(last < first, f"{what}: loss {first:.4f} -> {last:.4f} did "
                "not fall")
        require(out["restored_devices"] == [["cuda:0"]], f"{what}: the "
                f"restore put the params on {out['restored_devices']}")
        leaves = tree_leaves(out["state"]["params"])
        require(all(p.is_cuda for p in leaves), f"{what}: final params "
                "left the card")
        norms = _require_train_launches(what, cfg, got, len(losses))
        mgr = out["ckpt"]
        kept = mgr.all_steps()
        require(kept == [20, 30], f"{what}: checkpoints kept {kept}")
        nbytes = sum(_verify_checkpoint(mgr, st) for st in kept)
        t0 = time.perf_counter()
        mgr.save(1000, {"params": out["state"]["params"]}, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, back = mgr.restore(1000, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(all(torch.equal(a, b) for a, b in zip(
            leaves, tree_leaves(back["params"]))), f"{what}: a saved and "
            "restored leaf parts from the trained one")
        steady = sorted(out["step_s"][2:])
        step_s = steady[len(steady) // 2]
        log(f"{what}: B=8 S=512, 30 steps (35 run: failure at "
            f"{TRAIN_FAIL_AT}, recovered from 10), loss {first:.4f} -> "
            f"{last:.4f}; median step {step_s * 1e3:.1f} ms = "
            f"{1 / step_s:.2f} steps/s = {8 * 512 / step_s:.0f} tokens/s "
            f"(host clock to the loss on the host, steps 3 on); wall "
            f"{wall:.1f} s; card peak {peak:.2f} GiB; row_norm launches "
            f"{norms} (= {norms // len(losses)} a step x {len(losses)}), "
            f"no other kernel; checkpoints {kept} verified "
            f"({nbytes / 2 ** 20:.1f} MiB); the CLI's restore "
            f"{out['restore_s'][0]:.3f} s; the final params saved in "
            f"{save_s:.3f} s (host copy and blocking write) and restored "
            f"in {restore_s:.3f} s, bit for bit; {_card()}")
        del out, leaves, back

        out8, got8, wall8 = _train_run(
            ["--steps", "5", "--ckpt-every", "5", "--optimizer", "adamw8"],
            os.path.join(root, "adamw8"))
        what8 = f"train {cfg.name} x{cfg.n_layers} adamw8"
        require(out8["opt"] == "adamw8" and len(out8["losses"]) == 5
                and all(np.isfinite(out8["losses"])),
                f"{what8}: losses {out8['losses']}")
        q = out8["state"]["opt"]["m"]["embed"]["tok"]["q"]
        require(q.dtype == torch.int8 and q.is_cuda, f"{what8}: moment "
                f"{q.dtype} on {q.device}")
        norms += _require_train_launches(what8, cfg, got8, 5)
        log(f"{what8}: 5 steps, losses "
            + " ".join(f"{x:.4f}" for x in out8["losses"])
            + f"; wall {wall8:.1f} s; int8 moments on the card")
        del out8
        _remat_probe(cfg, dev)
        norms += _sharded_train(cfg, dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"row_norm": norms}


# the sharded step against one device's (the CPU tests' bounds,
# tests/test_torch_sharded_train.py), and the int8 gathers' loss against
# the bf16 gathers'
SHARDED_LOSS_TOL = 1e-4
SHARDED_NORM_TOL = 5e-3
SHARDED_DRIFT_TOL = 2e-4
INT8_GATHER_TOL = 1e-2
SHARDED_MESH = (2, 3)


def _timed_step(fn, *args) -> tuple:
    """fn(*args) with the launch counts set to 0 just before and read
    just after: (its result, the launches, wall seconds to the synchronize,
    the card's peak GiB in the step)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, dict(ops.launches), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _train_plan(cfg, shape, params, state):
    """(mesh, plan, param specs, opt specs) for a ("data", "model") mesh
    of `shape` on the card."""
    mesh = make_mesh(shape, ("data", "model"))
    plan = build_plan(cfg, mesh, params, batch=8)
    pspecs = train_cli.train_param_specs(plan, params)
    ospecs = train_cli.opt_state_specs(state, pspecs)
    return mesh, plan, pspecs, ospecs


def _sharded_train(cfg, dev, root: str) -> int:
    """The sharded step on the card (module docstring, phase 17).  Returns
    its row_norm launches."""
    from repro_torch.optim.optimizer import cosine_schedule, make_optimizer
    t_phase = time.perf_counter()
    n = cfg.n_layers
    params = init_params(cfg, seed=0, device=dev)
    opt_init, opt_update = make_optimizer("adamw",
                                          cosine_schedule(3e-3, 5, 30))
    state = opt_init(params)
    mesh, plan, pspecs, ospecs = _train_plan(cfg, SHARDED_MESH, params,
                                             state)
    model = make_model(cfg, device=dev)
    step = train_cli.jit_train_step(model, opt_update, plan, ospecs)
    one = train_cli.make_train_step(model, opt_update)
    # one device's own spread: the same steps through another bf16
    # program of the same function (two microbatches)
    one2 = train_cli.make_train_step(model, opt_update, n_micro=2)
    pipe = TokenPipeline(cfg.vocab_size, 8, 512, seed=0)
    batches = [pipe.next_batch() for _ in range(4)]
    what = (f"train sharded {cfg.name} x{n} on {SHARDED_MESH} "
            f"(data, model), {mesh.size} shards on {dev}")
    per_step = SHARDED_MESH[0] * (4 * n + 1)
    pp = train_cli.place(params, train_cli.plan_shardings(plan, pspecs))
    ps = train_cli.place(state, train_cli.plan_shardings(plan, ospecs))
    p1, s1, p2, s2 = params, state, params, state
    launched, rows, first_loss, gaps, ones = 0, [], None, [], []
    for i, b in enumerate(batches[:3]):
        (pp, ps, m), got, wall, peak = _timed_step(
            step, pp, ps, shard_batch(b, mesh, plan.data_spec))
        others = {k: v for k, v in got.items() if k != "row_norm" and v}
        require(got["row_norm"] == per_step and not others,
                f"{what}: step {i} launches {got}, want row_norm "
                f"{per_step} (each of {SHARDED_MESH[0]} replicas' forward "
                f"{2 * n + 1} and recompute {2 * n}) and nothing else")
        launched += got["row_norm"]
        dense = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        (p1, s1, m1), got1, wall1, peak1 = _timed_step(one, p1, s1, dense)
        p2, s2, m2 = one2(p2, s2, dense)
        loss, loss1 = float(m["loss"]), float(m1["loss"])
        gn, gn1 = float(m["grad_norm"]), float(m1["grad_norm"])
        first_loss = loss if first_loss is None else first_loss
        ones.append((loss1, gn1))
        gaps.append((abs(loss - loss1) / loss1, abs(gn - gn1) / gn1))
        rows.append(f"step {i}: loss {loss:.6f} / {loss1:.6f} (rel "
                    f"{gaps[-1][0]:.2e}; one device at n_micro 2 "
                    f"{abs(float(m2['loss']) - loss1) / loss1:.2e}), grad "
                    f"norm {gn:.5f} / {gn1:.5f} (rel {gaps[-1][1]:.2e}), "
                    f"{wall * 1e3:.1f} / {wall1 * 1e3:.1f} ms, peak "
                    f"{peak:.2f} / {peak1:.2f} GiB")
    diff = max(float((a.join().float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(pp), tree_leaves(p1)))
    log(f"{what}: 3 adamw steps at B=8 S=512, sharded / one device: "
        + "; ".join(rows) + f"; largest param difference {diff:.3g}; "
        f"row_norm {per_step} a step, no other kernel; {_card()}")
    fault = _planted_fault(step, params, state, mesh, plan, pspecs, ospecs,
                           batches[:3], ones)
    failed = sorted(_sharded_gaps_fail(fault))
    log(f"{what}: planted fault (data replica 1's gradients dropped), "
        "relative gaps (loss, grad norm) to one device's: " + "; ".join(
            f"step {i}: {a:.2e}, {b:.2e}" for i, (a, b) in enumerate(fault))
        + f"; gates failed: {failed}")
    require("grad norm" in failed, f"{what}: the planted fault's gaps "
            f"{fault} pass the grad norm's gate")
    require(not _sharded_gaps_fail(gaps), f"{what}: relative gaps (loss, "
            f"grad norm) to one device's {gaps} fail "
            f"{_sharded_gaps_fail(gaps)}")

    # the sharded state saved joined, restored onto (1, 3) and one device
    mgr = CheckpointManager(os.path.join(root, "sharded"), keep=2)
    t0 = time.perf_counter()
    mgr.save(3, {"params": pp, "opt": ps}, blocking=True)
    save_s = time.perf_counter() - t0
    want = {"params": pp, "opt": ps}
    joined = [x.join() for x in tree_leaves(want)]
    b = batches[3]
    (_, _, m), got, _, _ = _timed_step(step, pp, ps, shard_batch(
        b, mesh, plan.data_spec))
    launched += got["row_norm"]
    go_on = float(m["loss"])
    out = []
    for shape in ((1, 3), None):
        t0 = time.perf_counter()
        if shape is None:
            _, back = mgr.restore(3, device=dev)
            fn = one
            args = (back["params"], back["opt"],
                    {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
        else:
            m13, plan13, ps13, os13 = _train_plan(cfg, shape, params, state)
            sh = {"params": train_cli.plan_shardings(plan13, ps13),
                  "opt": train_cli.plan_shardings(plan13, os13)}
            _, back = mgr.restore(3, device=dev, shardings=sh)
            fn = train_cli.jit_train_step(model, opt_update, plan13, os13)
            args = (back["params"], back["opt"],
                    shard_batch(b, m13, plan13.data_spec))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got_leaves = [x.join() if hasattr(x, "join") else x
                      for x in tree_leaves(back)]
        require(len(got_leaves) == len(joined) and all(
            x.dtype == y.dtype and torch.equal(x.to(y.device), y)
            for x, y in zip(got_leaves, joined)),
            f"{what}: the state restored onto {shape or 'one device'} "
            "parts from the saved one")
        (_, _, m2), got, _, _ = _timed_step(fn, *args)
        launched += got["row_norm"]
        loss2 = float(m2["loss"])
        require(np.isfinite(loss2) and abs(loss2 - go_on)
                <= SHARDED_LOSS_TOL * abs(go_on),
                f"{what}: the step after the restore onto "
                f"{shape or 'one device'}: loss {loss2} vs {go_on}")
        out.append(f"{shape or 'one device'}: restored in {restore_s:.3f} "
                   f"s bit for bit, next loss {loss2:.6f}")
    log(f"{what}: state saved joined in {save_s:.3f} s; the (2, 3) plan's "
        f"next loss {go_on:.6f}; " + "; ".join(out))

    # one step gathering at int8 from the init
    pp0 = train_cli.place(params, train_cli.plan_shardings(plan, pspecs))
    ps0 = train_cli.place(state, train_cli.plan_shardings(plan, ospecs))
    with shard_hints.hints(mesh, int8_gather=True):
        (_, _, m8), got, wall8, peak8 = _timed_step(
            step, pp0, ps0, shard_batch(batches[0], mesh, plan.data_spec))
    launched += got["row_norm"]
    loss8 = float(m8["loss"])
    require(np.isfinite(loss8) and abs(loss8 - first_loss)
            <= INT8_GATHER_TOL * abs(first_loss),
            f"{what}: int8 gather step loss {loss8} vs bf16 {first_loss}")
    log(f"{what}: one step under hints(int8_gather=True): loss {loss8:.6f}"
        f" vs the bf16 gathers' {first_loss:.6f} (rel "
        f"{abs(loss8 - first_loss) / first_loss:.2e}), {wall8 * 1e3:.1f} ms"
        f", peak {peak8:.2f} GiB; sharded train "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def _sharded_gaps_fail(gaps) -> set:
    """The gates that a run's relative (loss, grad norm) gaps to one
    device's fail: the first loss (the same params) within the CPU tests'
    bound, the later ones within SHARDED_DRIFT_TOL (Adam's early updates
    are sign-like, so an ulp of a near-zero gradient moves a weight by 2
    lr), every grad norm within SHARDED_NORM_TOL."""
    bad = set()
    for i, (dl, dn) in enumerate(gaps):
        if not (np.isfinite(dl) and dl <= (
                SHARDED_DRIFT_TOL if i else SHARDED_LOSS_TOL)):
            bad.add("loss")
        if not (np.isfinite(dn) and dn <= SHARDED_NORM_TOL):
            bad.add("grad norm")
    return bad


def _planted_fault(step, params, state, mesh, plan, pspecs, ospecs,
                   batches, ones) -> list:
    """The sharded steps from the init with data replica 1's gradients
    dropped before the data-axis reduction (`train._data_reduce` wrapped
    for these steps alone): each step's relative (loss, grad norm) gaps to
    one device's `ones`."""
    real = train_cli._data_reduce

    def dropped(gs, leaf, mesh_, tp, dp):
        return real([torch.zeros_like(g) if mesh_.axis_index(f, dp) else g
                     for f, g in enumerate(gs)], leaf, mesh_, tp, dp)

    pp = train_cli.place(params, train_cli.plan_shardings(plan, pspecs))
    ps = train_cli.place(state, train_cli.plan_shardings(plan, ospecs))
    out = []
    train_cli._data_reduce = dropped
    try:
        for b, (loss1, gn1) in zip(batches, ones):
            pp, ps, m = step(pp, ps, shard_batch(b, mesh, plan.data_spec))
            out.append((abs(float(m["loss"]) - loss1) / loss1,
                        abs(float(m["grad_norm"]) - gn1) / gn1))
    finally:
        train_cli._data_reduce = real
    return out


def _remat_probe(cfg, dev) -> None:
    """One train step's gradients from the same params and batch, with
    and without remat: equal bit for bit; row_norm launches 4n + 1 and
    2n + 1."""
    params = init_params(cfg, seed=0, device=dev)
    b = TokenPipeline(cfg.vocab_size, 8, 512, seed=0).next_batch()
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    got = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = train_cli._grads(
            make_model(cfg, remat=remat, device=dev), params, batch)
        torch.cuda.synchronize()
        got[remat] = (loss, tree_leaves(grads), ops.launches["row_norm"],
                      time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 2 ** 30)
    same = torch.equal(got[False][0], got[True][0]) and all(
        torch.equal(a, b) for a, b in zip(got[False][1], got[True][1]))
    n = cfg.n_layers
    require(same, "train remat probe: remat's gradients part from no "
            "remat's")
    require((got[False][2], got[True][2]) == (2 * n + 1, 4 * n + 1),
            f"train remat probe: row_norm launches {got[False][2]} / "
            f"{got[True][2]}, want {2 * n + 1} / {4 * n + 1}")
    log(f"train remat probe {cfg.name} B=8 S=512: loss and all "
        f"{len(got[True][1])} gradients equal with and without remat, bit "
        f"for bit; row_norm launches {got[False][2]} / {got[True][2]}; "
        f"{got[False][3]:.3f} / {got[True][3]:.3f} s and card peak "
        f"{got[False][4]:.2f} / {got[True][4]:.2f} GiB for the step's "
        "gradients without / with remat")


def _mem_available_gib() -> float:
    """The host's MemAvailable (/proc/meminfo), GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")



def _first_difference(qp, qp_cpu, cfg, x) -> str:
    """The first layer and site where the card's encoder and the CPU's
    disagree, both run from the same int8 entry tensor."""
    card, cpu = {}, {}
    with torch.no_grad():
        ib.ibert_encode(qp, cfg, x, trace=card)
        ib.ibert_encode(qp_cpu, cfg, QTensor(x.values.cpu(), x.scale),
                        trace=cpu)
    for name, t in card.items():
        if not torch.equal(t.cpu(), cpu[name]):
            n = (t.cpu() != cpu[name]).sum().item()
            return f"{name} ({n} of {t.numel()} elements differ)"
    return "no site differs"


def encode_phase() -> dict:
    """The integer I-BERT encoder through the entry point's own code."""
    argv = ["--layers", "12"]  # batch 1, seed 0
    args = ibert_encoder.parse_args(argv)
    t0 = time.perf_counter()
    cfg, params, qp, toks = ibert_encoder.build(args)
    torch.cuda.synchronize()
    log(f"encode: ibert-base x{cfg.n_layers} built, calibrated at batch "
        f"{args.batch} seq {toks.shape[1]} and quantized in "
        f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    with torch.no_grad():
        out = ib.ibert_int_forward(qp, cfg, toks)
    torch.cuda.synchronize()
    counts = {k: ops.launches[k] for k in IBERT_LAUNCHES}
    log(f"encode: one forward at batch 1 seq 128 launched {counts}")
    require(counts == IBERT_LAUNCHES and ops.launches[
        "paged_flash_decode"] == 0, f"launches {dict(ops.launches)} != "
            f"{IBERT_LAUNCHES}")

    # card against the CPU plain path, from the card's int8 entry tensor
    qp_cpu = _to(qp, "cpu")
    with torch.no_grad():
        x = ib.ibert_embed(qp, toks)
        x_cpu = ib.ibert_embed(qp_cpu, toks.cpu())
        out_cpu = ib.ibert_encode(qp_cpu, cfg,
                                  QTensor(x.values.cpu(), x.scale))
    flips = (x.values.cpu() != x_cpu.values).sum().item()
    same = torch.equal(out.values.cpu(), out_cpu.values)
    log(f"encode: card vs CPU plain path from the same entry tensor: "
        f"bit-exact={same} ({out.values.numel()} int8 outputs); float "
        f"embedding entry tensor, card vs CPU: {flips} of "
        f"{x.values.numel()} int8 values differ (float LayerNorm "
        "summation order, outside the integer encoder)")
    if not same:
        require(False, "card and CPU integer encoders differ; first at "
                + _first_difference(qp, qp_cpu, cfg, x))

    # integer against float on one encoder at full width (layer 0 of these
    # weights: the paper's proof-of-concept unit), held to
    # tests/test_ibert_model.py's bounds
    e = ibert_encoder.int_vs_float(params, qp,
                                   dataclasses.replace(cfg, n_layers=1), toks)
    log(f"encode: integer vs float, 1 layer: max={e['max']:.4f} "
        f"mean={e['mean']:.4f} (float std {e['std']:.3f}; bounds 0.5 and "
        "0.1 std)")
    require(e["max"] < 0.5 * e["std"] and e["mean"] < 0.1 * e["std"],
            f"integer vs float out of bounds: {e}")
    ibert_profile(qp, cfg, toks)
    del params, qp, qp_cpu

    # the entry point itself: its 12-layer integer-vs-float error, held to
    # the reference's on the same weights (the CPU plain path, calibrated
    # on the CPU; tests/test_torch_ibert.py holds it bit-exact against
    # JAX's impl="ref"), then its time per seq length
    _, p_cpu, q_cpu, t_cpu = ibert_encoder.build(
        ibert_encoder.parse_args(argv + ["--device", "cpu"]))
    ref = ibert_encoder.int_vs_float(p_cpu, q_cpu, cfg, t_cpu)
    del p_cpu, q_cpu
    err = ibert_encoder.main(argv)["error"]
    log(f"encode: integer vs float, 12 layers: max={err['max']:.4f} "
        f"mean={err['mean']:.4f}; reference (CPU plain path) "
        f"max={ref['max']:.4f} mean={ref['mean']:.4f}, bounds "
        f"x{1 + REF_ERR_MARGIN['max']} and x{1 + REF_ERR_MARGIN['mean']}")
    require(all(err[k] <= ref[k] * (1 + m) for k, m in REF_ERR_MARGIN.items()),
            f"12-layer integer vs float {err} beyond the reference's {ref}")
    return counts


def ibert_profile(qp, cfg, toks) -> None:
    """Where one integer forward's time goes (batch 1, seq 128): device
    busy share of the window and device time by kernel."""
    with torch.no_grad():
        ib.ibert_int_forward(qp, cfg, toks)  # warm
        spans, wall_us = _device_spans(
            lambda: ib.ibert_int_forward(qp, cfg, toks))
    if not spans:
        log("encode profile: the profiler recorded no device time "
            "(not measured)")
        return
    by = {k: 0.0 for k in list(IBERT_LAUNCHES) + ["other"]}
    for s_, e_, name in spans:
        key = next((k for k in IBERT_LAUNCHES if k + "_kernel" in name),
                   "other")
        by[key] += e_ - s_
    log(f"encode profile seq=128: wall_ms={wall_us / 1e3:.3f} "
        f"device_busy_share={_busy_us(spans) / wall_us:.4f} "
        f"device_ops={len(spans)} device_ms={sum(by.values()) / 1e3:.4f} "
        + " ".join(f"{k}_ms={v / 1e3:.4f}" for k, v in by.items()))


def timed(name: str, fn):
    """fn(), then a log line of the phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn()
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def kernels_phase(dev) -> dict:
    """Every kernel against its plain version, timed.  Returns {kernel:
    metrics at its main shape}."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.int32, device=dev)
    main_shape = {"paged_flash_decode": kernel_phase(dev, flush, maxp=12)}
    kernel_phase(dev, flush, maxp=128)
    main_shape["paged_flash_decode_q"] = paged_q_phase(dev, flush, maxp=12)
    paged_q_phase(dev, flush, maxp=128)
    # kernels 1 and 2 at the speculative verify pass's folded lanes
    verify_kernel_phase(dev, flush, quantized=False)
    verify_kernel_phase(dev, flush, quantized=True)
    main_shape["flash_decode"] = flash_decode_phase(dev, flush, sk=192)
    flash_decode_phase(dev, flush, sk=192, window=48)
    flash_decode_phase(dev, flush, sk=2048)
    # kernels 1-3 at phi3-medium-14b's heads: the hd-128 instances
    kernel_phase(dev, flush, maxp=128, kvh=10, g=4, hd=128)
    paged_q_phase(dev, flush, maxp=128, kvh=10, g=4, hd=128)
    flash_decode_phase(dev, flush, sk=2048, kvh=10, g=4, hd=128)
    # kernel 1 at the MoE models' heads, hd 128, at the serve path's 12
    # pages: moonshot-v1-16b-a3b's 16 kv heads of one query head each,
    # llama4-maverick-400b-a17b's 8 of five
    kernel_phase(dev, flush, maxp=12, kvh=16, g=1, hd=128)
    kernel_phase(dev, flush, maxp=12, kvh=8, g=5, hd=128)
    # and at a shard's heads under the MoE serve plans: moonshot's 8 and 4
    # kv heads on (1, 2) and (1, 4), llama4-maverick's 1 on (1, 8)
    kernel_phase(dev, flush, maxp=12, kvh=8, g=1, hd=128)
    kernel_phase(dev, flush, maxp=12, kvh=4, g=1, hd=128)
    kernel_phase(dev, flush, maxp=12, kvh=1, g=5, hd=128)
    # flash_decode at recurrentgemma-2b's decode heads: hd 256, MQA at
    # G = 10 (two head chunks of 5, each reading the kv head's rows), its
    # window of 2048 over a serve lane's 192 slots, and a window of 512
    # over 2048 slots
    flash_decode_phase(dev, flush, sk=192, window=2048, kvh=1, g=10, hd=256)
    flash_decode_phase(dev, flush, sk=2048, window=512, kvh=1, g=10, hd=256)
    main_shape.update(ibert_kernel_phase(dev, flush))
    int8_decoder_phase(dev, flush)
    main_shape["row_norm"] = timed("kernels row_norm",
                                   lambda: row_norm_phase(dev, flush))
    main_shape["gemm"] = gemm_phase(dev, flush)
    expert_bmm_probe(dev)
    mlstm_head_probe(dev)
    bf, f32 = torch.bfloat16, torch.float32
    main_shape["flash_attention"] = flash_attention_phase(
        dev, flush, 2, 4096, 9, 3, 64, bf, True)  # smollm's forward_logits
    flash_attention_phase(dev, flush, 1, 4096, 40, 10, 128, bf, True)
    flash_attention_phase(dev, flush, 1, 1100, 9, 3, 64, f32, False)
    # how the cost moves with S at smollm's heads (cost ~ S^2)
    for s in (1100, 2048, 8192):
        flash_attention_phase(dev, flush, 2, s, 9, 3, 64, bf, True,
                              plain_timing=False)
    # the causal mask and the GQA walk at both configs' heads, held to
    # the f32 limit
    flash_attention_phase(dev, flush, 1, 4096, 9, 3, 64, f32, True,
                          timing=False)
    flash_attention_phase(dev, flush, 1, 4096, 40, 10, 128, f32, True,
                          timing=False)
    del flush
    torch.cuda.empty_cache()
    return main_shape


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    log(_card())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}; bounds use H100 SXM peaks: "
        f"{HBM_BYTES_S:.3g} B/s, {F32_FLOP_S:.3g} flop/s (f32), "
        f"{BF16_FLOP_S:.3g} flop/s (bf16), {INT8_OPS_S:.3g} int8 op/s")

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"build: {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f}"
        " s")
    for src, rep in reports.items():
        kernel, spills = "", []
        for line in rep.splitlines():
            if "Compiling entry function" in line:  # the mangled name
                kernel = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "smem" in line or "spill" in line:
                log(f"  {src} {kernel}: {line.strip()}")
            if "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split()
                        if w.isdigit()]  # stack frame, stores, loads
                spills.append(nums[1] + nums[2])
        log(f"  {src}: {len(spills)} instance(s), spill bytes {spills}")
        if src in SPILL_FREE:
            require(spills and not any(spills), f"{src}: ptxas reports "
                    f"spill bytes {spills}; want 0 at every instance")

    dev = torch.device("cuda")
    t_phases = time.perf_counter()
    main_shape = timed("kernels", lambda: kernels_phase(dev))

    fa_launches = timed("long forward", lambda: long_forward_phase(dev)
                        + phi3_forward_phase(dev))
    served = timed("serve", lambda: [
        serve_phase("poisson", 16), serve_phase("shared-prefix", 8),
        serve_phase("poisson", 16, engine="wave"),
        serve_phase("poisson", 16, paged=False),
        serve_phase("poisson", 16, kv_dtype="int8")])
    timed("profile", lambda: profile_phase(dev))
    timed("model", lambda: [model_phase("paged"), card_model_phase("dense"),
                            card_model_phase("int8")])
    fits = timed("fit", lambda: fit_phase(dev))
    gated = timed("gate", lambda: [gate_phase(*fits["target"], k)
                                   for k in ("paged", "dense", "int8")])
    gated.append(timed("spec", lambda: spec_phase(dev, fits)))
    worker = FitWorker()  # the reduced fits, beside phases 10-15
    try:
        main_rest(dev, main_shape, fa_launches, served, gated, worker,
                  t_phases)
    finally:
        worker.close()


def main_rest(dev, main_shape, fa_launches, served, gated,
              worker: FitWorker, t_phases: float) -> None:
    """Phases 10-18, the fit worker running until the fitted phase;
    t_phases: the clock at the kernels phase's start."""
    family = timed("families", lambda: families_phase(dev))
    gated.append(family)
    recurrent = timed("recurrent", lambda: recurrent_phase(dev))
    gated.append(recurrent)
    moe_launches = timed("moe", lambda: moe_phase(dev))
    gated.append(moe_launches)
    plans = timed("plans", lambda: plans_phase(dev))
    gated.append(plans)
    fleet = timed("fleet", lambda: fleet_phase(dev))
    gated.append(fleet)
    searched = timed("plansearch", lambda: plansearch_phase(dev))
    gated.append(searched)
    gated.append(timed("fitted", lambda: fitted_phase(dev, worker)))
    trained = timed("train", lambda: train_phase(dev))
    launches = {k: sum(s["launches"] for s in served if s["kernel"] == k)
                + sum(g.get(k, 0) for g in gated) for k in DECODE_KERNELS}
    launches["row_norm"] = (sum(s["row_norm"] for s in served)
                            + family["row_norm"] + recurrent["row_norm"]
                            + moe_launches["row_norm"] + plans["row_norm"]
                            + fleet["row_norm"] + searched["row_norm"]
                            + trained["row_norm"])
    launches["gemm"] = (sum(s["gemm"] for s in served) + plans["gemm"]
                        + fleet["gemm"] + searched["gemm"] + recurrent["gemm"]
                        + moe_launches["gemm"])
    launches.update(timed("encode", encode_phase))
    launches["int8_matmul"] += recurrent["int8_matmul"]
    launches["flash_attention"] = fa_launches

    # row_norm and gemm have no TPU kernel: they replace the reference's
    # plain jnp rmsnorm / layernorm and its jnp dot (models/layers.py)
    entries = [dict(name=kernel, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{kernel}.cu",
                    replaces=f"src/repro/{replaces}",
                    launches=launches[kernel], **main_shape[kernel])
               for kernel, replaces in (
                   ("paged_flash_decode", "kernels/flash_decode.py:250"),
                   ("paged_flash_decode_q", "kernels/flash_decode.py:193"),
                   ("flash_decode", "kernels/flash_decode.py:308"),
                   ("flash_attention", "kernels/flash_attention.py:77"),
                   ("int8_matmul", "kernels/int8_matmul.py:60"),
                   ("i_softmax", "kernels/i_softmax.py:49"),
                   ("i_layernorm", "kernels/i_layernorm.py:50"),
                   ("i_gelu", "kernels/i_gelu.py:41"),
                   ("row_norm", "models/layers.py:39"),
                   ("gemm", "models/layers.py:28"))]
    log(f"phases: {time.perf_counter() - t_phases:.1f} s from the kernels "
        "phase to this summary")
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fit-worker"]:
        fit_worker(sys.argv[2])
    else:
        main()

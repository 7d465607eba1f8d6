"""Device-side serving execution (port of `repro/serving/executor.py`:
the paged and the dense slot paths, greedy speculative decoding on the
paged one, and the Cluster Builder's serve plans).

The executor owns the params (quantized once for W8A8 serving when
asked, the draft's too) and the device decode state: bucketed
prefill, the fused n-step decode loop (`Model.decode_steps`), and the lane
admission/park updates.  PyTorch runs eagerly, so there is nothing to
compile; the state tensors are updated in place.  Each decode dispatch
returns one (n, B) token tensor that the engine fetches once — the loop
itself never syncs with the host.

Under a plan (`core/cluster_builder.build_plan`) the executor places the
params and caches itself, from the plan's specs (the reference's
`jax.device_put` under its shardings), and every program runs inside the
plan's `shard_hints.hints` context:
  * ``mode="serve"``: leaves whose spec names the `model` axis become
    `Shards`, one block per shard of the tensor-parallel group (the paged
    arena and dense slot rows by kv head, `wq`/`wk`/`wv`/`wi`/`wg` and
    the vocabulary by column, a MoE layer's `wi`/`wg` by expert and its
    shared experts' by column, and under ``exact=False`` the reduction
    projections by row, the experts' `wo` by expert); the rest stays
    whole on the controller (shard 0's device): the MoE router, and in
    an exact plan the experts' `wo` and `shared_wo`.  Kernels 1 and 2
    then launch once per shard at its kv heads.  When the kv heads do
    not divide the axis, attention runs unsharded over a replicated
    arena, and when the experts do not, they run whole on the controller
    (the reference's rules, logged).  The recurrent mixers' leaves follow
    the specs but where `cluster_builder.DEPARTURES` says otherwise (the
    RG-LRU's gates by column; the mLSTM's q/k/v weights and the two
    cells' states whole on the controller, where the cells run), since
    the reference's cuts there are partial sums that its partitioner
    reshards (`cluster_builder.tp_cut`, which the sharded training step
    places by too).  A W8A8 {"q",
    "s"} leaf becomes `Shards` of {"q", "s"} blocks (`_place_quantized`).
    The data axis replicates in serve plans (slot tables never shard the
    batch), so one tensor-parallel group runs.
  * ``mode="serve_pipeline"``: the scan-stacked leaves become `Shards`
    over the `stage` axis (stage s holds its contiguous block of layer
    periods, the paper's encoder-per-cluster placement; a paged arena's
    leaves too, so each stage holds only its own layers' pages), and the
    fused decode streams lane microbatches through the stages: drained
    per step on dense slot rows (exact, `_pipeline_decode`), or skewed
    over lane groups on the paged arena (``exact=False``,
    `_pipeline_skew_decode`).

Speculation under a serve plan keeps the draft's params and arena whole
on the controller (the reference replicates them) and runs the verify
pass inside the plan's context, per shard.  A plan whose axis is 1 wide
runs the plain programs on its mesh's device 0, with the params and
caches carried there (a fleet replica's device group).

Disaggregated prefill/decode pools (`set_disagg`): bucketed prefill, its
bucket cache and a batch-1 staging arena live on the prefill pool's
device with the prefill pool's param copy; the decode arena, the lane
state and every decode program on the decode pool's.  A cold
admission's pages cross with `ship_pages`: one batched gather over every
arena leaf, one copy to the decode device, one batched scatter.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import gmi
from repro_torch.core.cluster_builder import spec_axes, tp_cut
from repro_torch.core.packing import bucket_len
from repro_torch.core.pipeline import pipeline_steps, stage_devices
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import layers, shard_hints
from repro_torch.models.layers import COMPUTE_DTYPE, lm_head, norm
from repro_torch.models.quantized import (column_major, is_quantized,
                                          quantize_params_for_serving)
from repro_torch.models.shard_hints import Shards
from repro_torch.models.transformer import (Model, _index, block_apply,
                                            cache_map, forced_token_update,
                                            greedy_token_update, layer_plan,
                                            paged_cache_map)

PAD_TOKEN = 0  # fed for finished/free lanes; their logits are never read


def _batch_rows(caches, rows: slice):
    """Views of a dense cache tree's lanes `rows` (a plan's `Shards` part
    by part): the layers' in-place writes land in the whole cache."""
    n = rows.stop - rows.start

    def leaf(axis, t):
        if isinstance(t, Shards):
            return t.map(lambda p: p.narrow(axis, rows.start, n))
        return t.narrow(axis, rows.start, n)

    return cache_map(leaf, caches)


def _on(tree, dev):
    """A params or cache tree with every tensor on `dev`."""
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _all_on(tree, dev) -> bool:
    if isinstance(tree, dict):
        return all(_all_on(v, dev) for v in tree.values())
    return tree.device == dev


def _carry(tree, dev):
    """`tree` itself when every tensor already lies on `dev`, else a copy
    of it there."""
    return tree if _all_on(tree, dev) else _on(tree, dev)


def _bound(model: Model, dev) -> Model:
    """`model` bound to `dev` (its cache constructors allocate there)."""
    return model if model.device == dev else type(model)(model.cfg, dev)


class Executor:
    """Device programs + decode state for one serving engine."""

    def __init__(self, model: Model, params, max_batch: int = 8,
                 cache_len: int = 0, buckets=(), quant_weights: bool = False,
                 plan=None):
        self.model = model
        self.quant_weights = bool(quant_weights)
        if self.quant_weights:
            params = quantize_params_for_serving(params)
        self.plan = plan
        self.notes = []  # what the placement did, for the log
        self.pipeline_ticks = 0  # serve_pipeline: ticks of every step
        # serve_pipeline: the (B, V) f32 logits of each lane's last step in
        # the last dispatch
        self.logits = None
        # the plan's axis and its shard devices, when it cuts anything
        self._axis, self._group = None, []
        if plan is not None:
            mesh = plan.mesh
            self._axis = (plan.axes.stage if plan.mode == "serve_pipeline"
                          else plan.axes.tp)
            if mesh.shape[self._axis] > 1:
                self._group = mesh.groups(self._axis)[0]
            else:
                self._axis = None  # a 1-wide plan: the plain programs
        self.device = model.device
        if self._axis is not None:
            params = self._place(params, plan.specs_for_params(params))
            n, e = plan.mesh.shape[self._axis], model.cfg.n_experts
            if self._axis == "model" and e and e % n:
                self.notes.append(
                    f"plan: {e} experts do not divide '{self._axis}' ({n}):"
                    " the routed experts run whole on the controller")
            if (plan.mode == "serve" and plan.exact and plan.fsdp
                    and plan.axes.dp):
                self.notes.append(
                    "plan: over 8 GB of weights a shard keeps FSDP, so the"
                    f" reductions are cut over '{self._axis}' ({n}) even in"
                    " an exact plan: the streams are the psum form's, not"
                    " one device's bits")
        elif plan is not None:  # the plain programs, on the plan's device
            self.device = plan.mesh.device(0)
            self.model = _bound(model, self.device)
            params = _carry(params, self.device)
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len  # a paged engine re-rounds it to pages
        self.buckets = tuple(sorted(buckets))
        self._warm = []  # buckets prefilled at batch 1, first-use order
        # speculative decoding (set_draft): the draft model and its params
        self.draft_model = None
        self.draft_params = None
        # disaggregated pools (set_disagg): the prefill pool's model binding
        # and param copy (None: prefill runs with the decode programs)
        self.prefill_model = None
        self.prefill_params = None

    def set_draft(self, draft_model: Model, draft_params) -> None:
        """Install the speculative-decoding draft model; its weights take
        the target's W8A8 switch, as in the reference.  Under a plan that
        cuts they stay whole on the controller (shard 0's device): the
        reference replicates them, so the draft's steps need no
        collective and only the verify pass runs per shard."""
        if self.quant_weights:
            draft_params = quantize_params_for_serving(draft_params)
        self.draft_model = _bound(draft_model, self.device)
        self.draft_params = _carry(draft_params, self.device)

    def set_disagg(self, prefill_devs, decode_devs) -> None:
        """Split the executor across the two pools: prefill (its bucket
        cache and the staging arena) on ``prefill_devs``, the decode
        arena, lane state and decode programs on ``decode_devs``.  Each
        pool holds its own copy of the params, as the reference commits
        them to both pools; the reference replicates a pool's copy over
        its devices, so every device of a pool computes the same values
        and the pool's programs run on its first device.  The only
        traffic between the pools is `ship_pages`."""
        if self.plan is not None:
            raise ValueError("disagg needs plan=None (a plan already owns "
                             "placement)")
        pdev, ddev = torch.device(prefill_devs[0]), torch.device(
            decode_devs[0])
        self.prefill_model = _bound(self.model, pdev)
        self.prefill_params = _carry(self.params, pdev)
        # pages and bytes `ship_pages` has gathered, padding pages
        # included, the bytes counted off the gathered leaves
        self.gathered = {"pages": 0, "bytes": 0}
        self.device = ddev
        self.model = _bound(self.model, ddev)
        self.params = _carry(self.params, ddev)

    # -- plan placement --------------------------------------------------------

    def _place(self, tree, specs, path=()):
        """The plan's leaves as `Shards` over its axis (a leaf whose spec
        does not name the axis stays as it is); under tensor parallelism
        the dim comes from `_tp_dim`."""
        if is_quantized(tree):
            return self._place_quantized(tree, specs, path)
        if isinstance(tree, dict):
            return {k: self._place(v, specs[k], path + (k,))
                    for k, v in tree.items()}
        axis = self._axis
        spec_dim = next((d for d, e in enumerate(specs)
                         if axis in spec_axes(e)), None)
        dim = (self._tp_dim(path, tree.shape, spec_dim) if axis == "model"
               else spec_dim)
        if dim is None:
            return tree
        spec = tuple((specs[d] if d == spec_dim else axis) if d == dim
                     else None for d in range(tree.dim()))
        parts = self.plan.sharding(spec).split(tree)
        return Shards([parts[f] for f in self._group], axis, dim)

    def _place_quantized(self, w, specs, path):
        """A W8A8 {"q", "s"} leaf: whole where `q`'s spec does not name the
        axis, else `Shards` of {"q", "s"} blocks, `q` cut as its parent
        weight (by column for `wi`/`wg`, by row for `wo` under
        ``exact=False``) and each block stored column-major for the
        kernel; `s`, which the spec replicates, cut by the same columns
        (each block's columns' scales) or whole beside a row block."""
        q = self._place(w["q"], specs["q"], path + ("q",))
        if not isinstance(q, Shards):
            return w
        out, n = [], w["s"].shape[-1] // len(q) if q.dim == 1 else 0
        if n:
            self._note("plan: W8A8 s cut by its q's columns, not whole as "
                       "cluster_builder.py:260-263 places it: a column "
                       "block reads only its columns' scales")
        for i, qi in enumerate(q):
            s = w["s"][:, i * n:(i + 1) * n] if n else w["s"]
            out.append({"q": column_major(qi),
                        "s": s.to(qi.device).contiguous()})
        return Shards(out, q.axis, q.dim)

    def _note(self, note: str) -> None:
        if note not in self.notes:
            self.notes.append(note)

    def _tp_dim(self, path, shape, dim):
        """The dim a tensor-parallel plan cuts the leaf at `path` over
        (None: whole on the controller): the spec's `dim`, except that an
        attention block whose heads do not divide the axis stays whole
        (the reference's rule), and a recurrent leaf of DEPARTURES takes
        the port's dim (each departure noted)."""
        dim, note = tp_cut(self.model.cfg, self.plan.mesh.shape[self._axis],
                           self._axis, path, shape, dim,
                           whole=" over a replicated arena")
        if note:
            self._note(note)
        return dim

    def place_caches(self, caches, paged: bool, slot_table: bool = True):
        """A cache tree under the plan: the arena (or dense rows) by kv
        head, or its periods by stage; under tensor parallelism each
        attention cache's kpos held once per shard device (every shard's
        kernel reads it)."""
        if self._axis is None:
            return caches
        specs = self.plan.specs_for_caches(caches, batch=self.max_batch,
                                           slot_table=slot_table,
                                           paged=paged)
        placed = self._place(caches, specs)
        if self._axis == "model":
            self._kpos_per_device(placed)
        return placed

    def _kpos_per_device(self, tree) -> None:
        if not isinstance(tree, dict):
            return
        if isinstance(tree.get("k"), Shards) and "kpos" in tree:
            tree["kpos"] = Shards(shard_hints.broadcast_to(
                tree["kpos"], tree["k"]), tree["k"].axis, None)
            return
        for v in tree.values():
            self._kpos_per_device(v)

    def _ctx(self):
        """The serve plan's hints context (a no-op context otherwise)."""
        plan = self.plan
        if self._axis is None or plan.mode != "serve":
            return contextlib.nullcontext()
        return shard_hints.hints(plan.mesh, dp_axes=plan.axes.dp,
                                 tp_axis=plan.axes.tp,
                                 serve_exact=plan.exact,
                                 serve_psum=not plan.exact)

    def _tensor(self, a, dtype=torch.int32, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=device or self.device)

    # -- cache / state -------------------------------------------------------

    def init_caches(self, paged: bool, page_size: int = 0,
                    num_pages: int = 0, max_pages: int = 0,
                    kv_dtype: str = "bf16"):
        """The persistent serving cache: a paged arena, or dense slot rows
        (max_batch x cache_len)."""
        if paged:
            caches = self.model.init_paged_cache(
                self.max_batch, num_pages, page_size, max_pages,
                kv_dtype=kv_dtype)
        else:
            caches = self.model.init_cache(self.max_batch, self.cache_len)
        return self.place_caches(caches, paged)

    def init_draft_caches(self, page_size: int, num_pages: int,
                          max_pages: int, kv_dtype: str = "bf16"):
        """The draft model's paged arena (its own page pool), whole on the
        controller under a plan, like its params."""
        return self.draft_model.init_paged_cache(
            self.max_batch, num_pages, page_size, max_pages,
            kv_dtype=kv_dtype)

    def fresh_state(self, caches, paged: bool,
                    draft_caches=None) -> Dict[str, Any]:
        """Device decode state, mutated only by the methods below; the
        paged one carries the forced-token (suffix-ingest) queues, and a
        speculative one the draft's arena."""
        b, dev = self.max_batch, self.device

        def full(shape, val, dtype=torch.int32):
            return torch.full(shape, val, dtype=dtype, device=dev)

        st = {"caches": caches,
              "cur": full((b,), PAD_TOKEN),
              "active": full((b,), False, torch.bool),
              "eos": full((b,), -1),
              "budget": full((b,), 0)}
        if paged:
            st.update(forced=full((b, self.cache_len), 0),
                      flen=full((b,), 0), fptr=full((b,), 0))
        if draft_caches is not None:
            st["draft_caches"] = draft_caches
        return st

    # -- prefill -------------------------------------------------------------

    def _prefill(self, model: Model, params, prompts, batch: int,
                 cache_slots: Optional[int], placed: bool = True):
        """Bucketed left-aligned batched prefill on `model` into a dense
        cache of `cache_slots` rows (None: the bucket), placed under the
        plan when `placed` (the target's; the draft's stays whole);
        returns (logits (batch, V), caches, bucket).

        A wave's batch x bucket rows run in request blocks of at most
        EXACT_ROWS_MAX rows, so that its products stay on the K-ordered
        gemm (`layers.product`), whose rows get the same bits at any row
        count: the blocks change no stream, and a tensor-parallel plan's
        wave (whose products may not pass that bound) equals one
        device's bit for bit."""
        maxlen = max(len(p) for p in prompts)
        bucket = bucket_len(maxlen, self.buckets, lane=8)
        toks = np.zeros((batch, bucket), np.int32)
        # pad positions = 2^30 so the causal mask never attends to them
        pos = np.full((batch, bucket), 2 ** 30, np.int32)
        lengths = np.ones((batch,), np.int32)
        for i, p in enumerate(prompts):
            n = len(p)
            toks[i, :n] = p
            pos[i, :n] = np.arange(n)
            lengths[i] = n
        caches = model.init_cache(batch, cache_slots or bucket)
        if placed:
            caches = self.place_caches(caches, False, slot_table=False)
        per = max(1, layers.EXACT_ROWS_MAX // bucket)
        dev = model.device
        toks_t, pos_t = self._tensor(toks, device=dev), self._tensor(
            pos, device=dev)
        last = self._tensor(lengths - 1, torch.long, device=dev)
        logits = []
        with torch.no_grad(), self._ctx():
            for r0 in range(0, batch, per):
                rows = slice(r0, min(r0 + per, batch))
                sub = caches if per >= batch else _batch_rows(caches, rows)
                lg, sub = model.prefill(params, sub, toks_t[rows],
                                        positions=pos_t[rows],
                                        last_idx=last[rows])
                logits.append(lg)
                caches["pos"][rows] = sub["pos"]
        return torch.cat(logits), caches, bucket

    def prefill_prompts(self, prompts, batch: int,
                        bucket_cache: bool = False):
        """Bucketed left-aligned batched prefill; returns (logits (batch,
        V), caches).  bucket_cache=True writes a bucket-sized cache (an
        admission then scatters or inserts it); otherwise the cache spans
        cache_len and is decoded into directly (waves)."""
        # under disagg every prefill belongs to the prefill pool
        pooled = self.prefill_model is not None
        logits, caches, bucket = self._prefill(
            self.prefill_model if pooled else self.model,
            self.prefill_params if pooled else self.params, prompts, batch,
            None if bucket_cache else self.cache_len)
        if batch == 1 and bucket not in self._warm:
            self._warm.append(bucket)
        return logits, caches

    @property
    def warm_buckets(self):
        """Buckets already prefilled at batch 1 — the reference reports
        its compiled prefill programs here, and the admission order
        prefers them, so the port reports the same set."""
        return list(self._warm)

    # -- fused decode ----------------------------------------------------------

    def decode(self, st: Dict[str, Any], n: int, paged: bool) -> torch.Tensor:
        """One fused n-step dispatch; returns the (n, B) token tensor (on
        the device), st updated in place.  The paged loop threads the
        forced-token queues."""
        if self._axis == "stage":
            if paged == self.plan.exact:
                raise ValueError(
                    "an exact serve_pipeline plan streams the dense slot "
                    "path, the request-skewed one (exact=False) the paged "
                    "arena")
            return (self._pipeline_skew_decode(st, n) if paged
                    else self._pipeline_decode(st, n))
        kw = (dict(forced=st["forced"], forced_len=st["flen"],
                   forced_ptr=st["fptr"]) if paged else {})
        with torch.no_grad(), self._ctx():
            out = self.model.decode_steps(
                self.params, st["caches"], st["cur"], st["active"], n,
                eos_id=st["eos"], budget=st["budget"], pad_token=PAD_TOKEN,
                **kw)
        toks, cur, active, budget = out[:4]
        st.update(caches=out[-1], cur=cur, active=active, budget=budget)
        if paged:
            st["fptr"] = out[4]
        return toks

    # -- speculative decoding --------------------------------------------------

    def spec_decode(self, st: Dict[str, Any], k: int) -> torch.Tensor:
        """One speculative dispatch at draft depth k: the draft's k+1
        steps, one target verify pass (k+1 queries per lane through the
        paged verify branch) and the acceptance state machine, threading
        the forced-token queues.  Returns the (k+1, B) token tensor (on
        the device), st (both arenas included) updated in place."""
        with torch.no_grad(), self._ctx():
            toks, cur, active, budget, fptr, caches, dcaches, _ = \
                self.model.spec_decode_step(
                    self.params, st["caches"], st["cur"], st["active"], k,
                    self.draft_model, self.draft_params, st["draft_caches"],
                    eos_id=st["eos"], budget=st["budget"],
                    pad_token=PAD_TOKEN, forced=st["forced"],
                    forced_len=st["flen"], forced_ptr=st["fptr"])
        st.update(caches=caches, draft_caches=dcaches, cur=cur,
                  active=active, budget=budget, fptr=fptr)
        return toks

    def warm_spec(self, st: Dict[str, Any], ladder) -> None:
        """One dispatch per ladder depth on the empty (all-inactive) state,
        as the reference compiles its spec programs there: every lane is
        inactive, so no live row, counter or token changes."""
        for k in ladder:
            self.spec_decode(st, k)

    def draft_prefill_prompts(self, prompts, batch: int):
        """Bucketed prefill on the draft model (a draft lane's admission:
        a prefix-hit lane prefills prompt[:hit_len] — hit lengths are
        page-aligned, so the suffix ingests in lockstep through the spec
        dispatch's forced queue).  Returns (caches, bucket)."""
        _, caches, bucket = self._prefill(self.draft_model,
                                          self.draft_params, prompts, batch,
                                          None, placed=False)
        return caches, bucket

    def admit_cold_draft(self, st, slot: int, small, pt_row, pos0: int,
                         reset, write_pages: np.ndarray) -> None:
        """Scatter a draft bucket prefill into the lane's draft-arena
        pages (the draft's admit_cold)."""
        self.draft_model.admit_lane_cache(st["draft_caches"], slot, pt_row,
                                          pos0, reset, small=small,
                                          write_pages=write_pages)

    def draft_catchup(self, st, tokens: np.ndarray, lag: np.ndarray) -> None:
        """Bring draft lanes back to the target's position after plain
        dispatches: feed each lane the stream tokens the target consumed
        while the draft sat idle (tokens[b, :lag[b]]), one draft decode
        step per column; a column past a lane's lag leaves it inactive,
        so its rows and counter stop at exactly the target's position."""
        toks = self._tensor(tokens)
        lag_t = self._tensor(lag)
        with torch.no_grad():
            for j in range(tokens.shape[1]):
                self.draft_model.decode_step(
                    self.draft_params, st["draft_caches"], toks[:, j],
                    active=j < lag_t)

    # -- lane updates ----------------------------------------------------------

    def insert(self, big, small, slot: int):
        """Write a batch-1 prefill cache into a dense slot row."""
        return self.model.insert_prefill_cache(big, small, slot)

    def admit_lane(self, st, sl: int, tok: int, eos_id: int,
                   bud: int) -> None:
        """Lane decode state for a dense-slot admission."""
        st["cur"][sl] = tok
        st["active"][sl] = True
        st["eos"][sl] = eos_id
        st["budget"][sl] = bud

    # -- stage-pipelined decode (mode="serve_pipeline") ------------------------

    def _stages(self):
        """(stage devices, layer periods a stage, the period's block
        kinds) of the serve_pipeline plan."""
        cfg, n_stages = self.model.cfg, self.plan.mesh.shape[self._axis]
        n_rep, tail, kinds = layer_plan(cfg)
        if tail or n_rep % n_stages:
            raise ValueError(
                f"serve_pipeline needs the scan-stacked periods to divide "
                f"the stage axis: n_rep={n_rep}, tail={tail}, "
                f"stages={n_stages}")
        return (stage_devices(self.plan.mesh, self._axis),
                n_rep // n_stages, kinds)

    def _pipeline_decode(self, st: Dict[str, Any], n: int) -> torch.Tensor:
        """Fused n-step decode streamed through the `stage` mesh axis.

        Stage s holds its contiguous block of the scan-stacked layer
        periods on its own device, and each decode step runs the GPipe
        schedule of core/pipeline over lane microbatches: at tick t, stage
        s applies its layers to microbatch (t - s) and hands the hidden
        state to stage s + 1 (`gmi.cluster_send`).  A microbatch is its own
        B / n_micro lanes: their rows of x, of the positions and of each
        KV cache leaf (views, written in place).  Every operation on such
        rows (the K-ordered products, the row norm, the decode kernel)
        gives a row the same bits at any row count; the recurrent mixers
        and the MoE FFN, whose products are cuBLAS's, run at the B lanes
        with the microbatch's rows at their own lanes and write only its
        lanes' state (`block_apply`'s `lanes`).  So each lane's row is bit
        for bit `Model.decode_steps`'.  The last stage's rows go back to
        the controller, where the final norm, the head and
        `greedy_token_update` run as in `Model.decode_steps`.  Ticks per
        step: `pipeline_steps(n_micro, n_stages)`.  Leaves the last step's
        logits in `self.logits`.
        """
        model, cfg = self.model, self.model.cfg
        devs, per, kinds = self._stages()
        n_stages = len(devs)
        b = self.max_batch
        n_micro = n_stages if b % n_stages == 0 else 1
        mb = b // n_micro
        steps = pipeline_steps(n_micro, n_stages)
        ring = DeviceMesh((n_stages,), (self._axis,), devs)
        params, caches = self.params, st["caches"]
        rest_p = {k: v for k, v in params.items() if k != "scan"}
        cur, act, rem, eos = st["cur"], st["active"], st["budget"], st["eos"]
        toks = []
        with torch.no_grad():
            for _ in range(n):
                x = model.embed_inputs(rest_p, tokens=cur[:, None])
                pos = caches["pos"]
                buf = [torch.zeros_like(x[:mb], device=d) for d in devs]
                out = torch.zeros_like(x)
                for t in range(steps):
                    ys = []
                    for s, dev in enumerate(devs):
                        m = t - s  # the microbatch this stage works on
                        if not 0 <= m < n_micro:
                            ys.append(buf[s])
                            continue
                        lanes = slice(m * mb, (m + 1) * mb)
                        h = x[lanes].to(dev) if s == 0 else buf[s]
                        positions = pos[lanes, None].to(dev)
                        on = act[lanes].to(dev)
                        for i in range(s * per, (s + 1) * per):
                            pp = _index(params["scan"], i)
                            pc = _index(caches["scan"], i)
                            for j in range(len(kinds)):
                                h, _ = block_apply(cfg, j, pp[f"b{j}"], h,
                                                   positions, None,
                                                   pc[f"b{j}"], active=on,
                                                   lanes=(lanes, b))
                        ys.append(h)
                    m_out = t - (n_stages - 1)
                    if m_out >= 0:  # the last stage finished m_out
                        out[m_out * mb:(m_out + 1) * mb] = ys[-1].to(x.device)
                    buf = gmi.cluster_send(ys, ring, self._axis)
                self.pipeline_ticks += steps
                h = norm(out, rest_p["final_norm"], cfg)
                logits = self.logits = lm_head(h, rest_p["embed"])[:, 0]
                emit, cur, nxt_act, rem = greedy_token_update(
                    logits, cur, act, rem, eos, PAD_TOKEN)
                caches["pos"] = torch.where(act, pos + 1, pos)
                act = nxt_act
                toks.append(emit)
        st.update(cur=cur, active=act, budget=rem)
        return torch.stack(toks)

    def _pipeline_skew_decode(self, st: Dict[str, Any],
                              n: int) -> torch.Tensor:
        """Fused n-step paged decode on the request-skewed pipeline
        (``exact=False``; the reference's `_pipeline_skew_decode_fn`).

        The drained schedule (`_pipeline_decode`) costs n_micro + S - 1
        ticks a step.  Here the batch splits into G = S contiguous lane
        groups of mb = B / S lanes, and at tick t stage s runs group
        (t - s) mod G at decode step (t - s) // G; a tick off that
        schedule is skipped.  While stage s holds group g's step k, stage
        s - 1 is on group g + 1, so the only bubbles are the S - 1
        fill/drain ticks of the horizon: n*S + S - 1 ticks for n steps.

        Stage s decodes from its own block of the paged arena (its
        periods' pages, `place_caches`) through the page table, which
        stays whole on the controller with the lane state and the
        forced-token queues, and keeps its own position counters (it
        ingests group g's step-k token s ticks after stage 0).  The last
        stage's rows go to the controller, which finishes the group's
        step (the final norm, the head and `decode_steps`' forced-queue
        state machine, `forced_token_update`, on the group's rows) and
        commits it to the lane state.  Group g's step k commits at tick
        g + kG + S - 1 and its next read is at tick g + (k+1)G, so every
        stage reads the state the sequential loop would: the schedule
        changes when a lane decodes, never what it decodes.  Every
        operation on a group's rows gives a row the same bits at any row
        count, the MoE FFN's at the B lanes (`block_apply`'s `lanes`), so
        the tokens are `Model.decode_steps`' bit for bit.  Leaves each
        lane's last-step logits in `self.logits`.
        """
        model, cfg = self.model, self.model.cfg
        devs, per, kinds = self._stages()
        n_stages, b = len(devs), self.max_batch
        if b % n_stages:
            raise ValueError(
                f"request-skewed serve_pipeline needs max_batch divisible "
                f"by the stage count: batch={b}, stages={n_stages}")
        mb = b // n_stages
        total = n * n_stages + n_stages - 1
        ring = DeviceMesh((n_stages,), (self._axis,), devs)
        params, caches = self.params, st["caches"]
        rest_p = {k: v for k, v in params.items() if k != "scan"}
        cur, act = st["cur"].clone(), st["active"].clone()
        rem, fptr = st["budget"].clone(), st["fptr"].clone()
        pos = [caches["pos"].to(d, copy=True) for d in devs]
        pts = [caches["pt"].to(d) for d in devs]
        buf = [torch.zeros((mb, 1, cfg.d_model), dtype=COMPUTE_DTYPE,
                           device=d) for d in devs]
        out = torch.full((n, b), -1, dtype=torch.int32, device=self.device)
        self.logits = torch.zeros((b, cfg.vocab_size), dtype=torch.float32,
                                  device=self.device)
        with torch.no_grad():
            for t in range(total):
                ys = []
                for s, dev in enumerate(devs):
                    m = t - s  # the (group, step) this stage works on
                    if not 0 <= m < n * n_stages:
                        ys.append(buf[s])
                        continue
                    lanes = slice(m % n_stages * mb, (m % n_stages + 1) * mb)
                    on = act[lanes].to(dev)
                    h = (model.embed_inputs(rest_p, tokens=cur[lanes, None])
                         .to(dev) if s == 0 else buf[s])
                    qpos = pos[s][lanes]
                    for i in range(s * per, (s + 1) * per):
                        pp = _index(params["scan"], i)
                        pc = _index(caches["scan"], i)
                        for j in range(len(kinds)):
                            h, _ = block_apply(cfg, j, pp[f"b{j}"], h,
                                               qpos[:, None], None,
                                               pc[f"b{j}"],
                                               page_table=pts[s][lanes],
                                               active=on, lanes=(lanes, b))
                    pos[s][lanes] = torch.where(on, qpos + 1, qpos)
                    ys.append(h)
                    if s == n_stages - 1:  # the group's step is done
                        hn = norm(h.to(self.device), rest_p["final_norm"],
                                  cfg)
                        logits = lm_head(hn, rest_p["embed"])[:, 0]
                        self.logits[lanes] = logits
                        (out[m // n_stages, lanes], cur[lanes], act[lanes],
                         rem[lanes], fptr[lanes]) = forced_token_update(
                            logits, cur[lanes], act[lanes], rem[lanes],
                            st["eos"][lanes], PAD_TOKEN, st["forced"][lanes],
                            st["flen"][lanes], fptr[lanes])
                buf = gmi.cluster_send(ys, ring, self._axis)
        self.pipeline_ticks += total
        caches["pos"] = pos[0]
        st.update(cur=cur, active=act, budget=rem, fptr=fptr)
        return out

    def admit_hit(self, st, slot: int, pt_row, pos0: int, reset) -> None:
        """Point a lane at its (shared prefix + own) pages; the suffix
        arrives later through the decode loop's forced queue."""
        self.model.admit_lane_cache(st["caches"], slot, pt_row, pos0, reset)

    def admit_cold(self, st, slot: int, small, pt_row, pos0: int, reset,
                   write_pages: np.ndarray) -> None:
        """Scatter a bucket prefill cache into the lane's arena pages."""
        self.model.admit_lane_cache(st["caches"], slot, pt_row, pos0, reset,
                                    small=small, write_pages=write_pages)

    # -- disaggregated page shipping (set_disagg) ------------------------------

    def init_prefill_arena(self, page_size: int, num_pages: int,
                           max_pages: int, kv_dtype: str = "bf16"):
        """The prefill pool's staging arena: a batch-1 paged cache on the
        prefill device.  One admission stages at a time (lane 0), so
        ``num_pages = max_pages + 1`` (+ the trash page) always covers
        it."""
        return self.prefill_model.init_paged_cache(
            1, num_pages, page_size, max_pages, kv_dtype=kv_dtype)

    def prefill_admit(self, arena, small, pt_row, pos0: int, reset,
                      write_pages: np.ndarray):
        """Scatter a bucket prefill cache into the staging arena's pages
        (admit_cold's scatter at the staging arena's lane 0).  The page
        contents it writes are what admit_cold would write into the
        decode arena (an int8 arena quantizes here, before shipping), so
        disaggregated streams equal colocated serving's bit for bit."""
        return self.prefill_model.admit_lane_cache(
            arena, 0, pt_row, pos0, reset, small=small,
            write_pages=write_pages)

    def ship_pages(self, arena, st, src_pages, dst_pages) -> None:
        """Ship completed KV pages from the staging arena into the decode
        arena: one batched gather over every arena leaf (an int8 arena's
        `k_scale`/`v_scale` planes go with their pages), one copy to the
        decode device, one batched scatter into the decode caches.  Both
        index vectors pad to a power of two with the trash page 0: its
        kpos is the sentinel on both sides (inactive lanes' writes are
        sentinel-stamped), so a trash-to-trash copy makes no stale key
        reachable.  Adds the pages and bytes gathered to
        `self.gathered`, the bytes summed over the gathered leaves."""
        n = len(src_pages)
        if n != len(dst_pages) or n == 0:
            raise ValueError(f"ship_pages: {n} source pages, "
                             f"{len(dst_pages)} destination pages")
        n_pad = 1 << (n - 1).bit_length()
        src = np.zeros((n_pad,), np.int64)
        src[:n] = src_pages
        dst = np.zeros((n_pad,), np.int64)
        dst[:n] = dst_pages
        src_t = self._tensor(src, torch.long, device=self.prefill_model.device)
        dst_t = self._tensor(dst, torch.long)
        with torch.no_grad():
            blk = paged_cache_map(
                lambda ax, name, b: b.index_select(ax, src_t),
                {"scan": arena["scan"], "tail": arena["tail"]})
            blk = _carry(blk, self.device)  # the hop between the pools
            moved = []
            paged_cache_map(lambda ax, name, b: moved.append(
                b.numel() * b.element_size()), blk)
            self.gathered["pages"] += n_pad
            self.gathered["bytes"] += sum(moved)
            paged_cache_map(
                lambda ax, name, b, s: b.index_copy_(ax, dst_t, s),
                {"scan": st["caches"]["scan"],
                 "tail": st["caches"]["tail"]}, blk)

    def admit_lane_paged(self, st, sl: int, tok: int, eos_id: int, bud: int,
                         forced_rest, flen: int) -> None:
        """Lane decode state plus its forced-token (suffix-ingest) row."""
        frow = np.zeros((self.cache_len,), np.int32)
        frow[:len(forced_rest)] = forced_rest
        self.admit_lane(st, sl, tok, eos_id, bud)
        st["forced"][sl] = self._tensor(frow)
        st["flen"][sl] = flen
        st["fptr"][sl] = 0

    def park_lane(self, st, sl: int) -> None:
        """Deactivate a lane (preemption): its writes go to the trash page
        from the next step on."""
        st["cur"][sl] = PAD_TOKEN
        st["active"][sl] = False

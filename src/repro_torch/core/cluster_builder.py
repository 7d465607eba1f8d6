"""Cluster Builder (paper §6): model description -> deployable parallel
plan (port of `repro/core/cluster_builder.py`).

The paper's Cluster Builder takes a trained model + JSON cluster/layer
descriptions and emits per-kernel HLS artifacts wired into Galapagos
clusters.  This module emits, from a ModelConfig + mesh:

  1. a ClusterTopology — the paper's kernel graph (one cluster per layer,
     gateway kernel 0, per-head compute kernels, inserted GMI kernels).  For
     ibert-base this reproduces Fig. 14's encoder cluster exactly.  Part 1
     is the reference's code as it is.
  2. a ClusterPlan — a spec for every parameter / cache leaf.  A spec is a
     tuple with one entry per dimension: a mesh axis name, a tuple of axis
     names, or None (what a JAX ``PartitionSpec`` holds).  The port has no
     partitioner: `ClusterPlan.sharding(spec)` returns a `Sharding` that
     cuts a full tensor into its per-shard pieces, each on its shard's
     device, and joins them back (serving/executor.py places the served
     leaves with it).

Sharding rules are divisibility-driven: tensor-parallel dims go to `model`,
FSDP dims to ("pod","data") when divisible, with graceful fallback to
replication — so every assigned arch (9-head smollm, 151655-vocab internvl2,
...) gets a coherent plan on the same production mesh.  The `train` (FSDP)
rules place the sharded training step's master params, gradients and
optimizer state (`launch/train.py`), with the tensor-parallel cut of each
leaf taken from `tp_cut`, the rule the serving executor places by too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cluster import Cluster, ClusterTopology
from repro_torch.launch.mesh import DeviceMesh

Spec = Tuple[Any, ...]  # one entry per dim: axis name, tuple of names, None


def P(*parts) -> Spec:
    """A spec from its entries, as `PartitionSpec(*parts)` reads."""
    return tuple(parts)

# ---------------------------------------------------------------------------
# Part 1: kernel-graph topology (paper-faithful bookkeeping)
# ---------------------------------------------------------------------------



def _attn_layer_kernels(c: Cluster, cfg: ModelConfig,
                        with_dense_ffn: bool) -> None:
    """Mirror of Fig. 14: one encoder's kernels (per-head spatial split)."""
    for name in ("linear_q_quant", "linear_k_quant", "linear_v_quant"):
        c.add("compute", name)
    for h in range(cfg.n_heads):
        c.add("compute", "dotprod_softmax", head=h)
    for h in range(cfg.n_heads):
        c.add("compute", "softmax_matmul_quant", head=h)
    c.add("compute", "linear_o_quant")
    c.add("compute", "layernorm")
    if with_dense_ffn:
        c.add("compute", "linear_ff1_gelu")
        c.add("compute", "linear_ff2_quant")
        c.add("compute", "layernorm")
    c.add("gmi", "scatter")  # split Q/K/V head blocks across head kernels
    c.add("gmi", "scatter")
    c.add("gmi", "scatter")
    c.add("gmi", "gather")  # gather head outputs
    c.add("gmi", "broadcast")  # residual fan-out


def _moe_layer_kernels(c: Cluster, cfg: ModelConfig) -> None:
    c.add("compute", "router")
    c.add("gmi", "scatter")  # dispatch (the MoE all-to-all)
    for e in range(cfg.n_experts):
        c.add("compute", "expert_ffn", expert=e)
    for s in range(cfg.n_shared_experts):
        c.add("compute", "shared_expert_ffn", expert=s)
    c.add("gmi", "gather")  # combine
    c.add("compute", "layernorm")


def _recurrent_layer_kernels(c: Cluster, kind: str,
                             with_dense_ffn: bool = False) -> None:
    c.add("compute", f"{kind}_in_proj")
    c.add("compute", f"{kind}_cell")
    c.add("compute", f"{kind}_out_proj")
    c.add("compute", "layernorm")
    if with_dense_ffn:
        c.add("compute", "linear_ff1_gelu")
        c.add("compute", "linear_ff2_quant")
        c.add("compute", "layernorm")


def build_topology(cfg: ModelConfig) -> ClusterTopology:
    """One cluster per layer (the paper maps one encoder per cluster)."""
    topo = ClusterTopology()
    prev_gateway = None
    for layer in range(cfg.n_layers):
        c = topo.new_cluster()
        kind = cfg.block_kind(layer)
        is_moe = cfg.is_moe_layer(layer)
        if kind == "attn":
            _attn_layer_kernels(c, cfg, with_dense_ffn=not is_moe and
                                cfg.family != "ssm" and cfg.d_ff > 0)
        else:
            _recurrent_layer_kernels(
                c, kind, with_dense_ffn=cfg.family != "ssm" and cfg.d_ff > 0)
        if is_moe:
            _moe_layer_kernels(c, cfg)
        if prev_gateway is not None:
            topo.connect(prev_gateway, c.gateway)  # serial encoder chain
        prev_gateway = c.gateway
    topo.validate()
    return topo

# ---------------------------------------------------------------------------
# Part 2: sharding plan
# ---------------------------------------------------------------------------


@dataclass
class MeshAxes:
    dp: Tuple[str, ...]  # data-parallel axes, e.g. ("pod","data")
    tp: str = "model"
    stage: Optional[str] = None  # pipeline axis (mode="serve_pipeline")

    @property
    def all(self) -> Tuple[str, ...]:
        return self.dp + (self.tp,)


@dataclass
class ClusterPlan:
    cfg: ModelConfig
    axes: MeshAxes
    mesh: DeviceMesh
    topology: ClusterTopology
    param_specs: Any = None
    cache_specs: Any = None
    data_spec: Any = None
    mode: str = "train"
    fsdp: bool = True
    # exact=True (default): bit-identical serving — gather-form TP and the
    # drained pipeline schedule.  exact=False: throughput mode — psum-form
    # (Megatron) TP for the reduction projections and the request-skewed
    # pipeline schedule; streams are gated by a token-match band instead of
    # equality (docs/serving.md §exactness contract).
    exact: bool = True
    notes: List[str] = field(default_factory=list)

    def sharding(self, spec: Spec) -> "Sharding":
        """The function that cuts a full tensor into its per-shard pieces
        under `spec` (and joins them back), on this plan's mesh."""
        return Sharding(self.mesh, spec)

    # -- late-binding specs (the serving engine builds its slot-table cache
    #    after the plan exists, so specs must be derivable post-hoc) --------

    def specs_for_params(self, params_shape: Any) -> Any:
        if self.mode == "serve_pipeline":
            n = _axsize(self.mesh, self.axes.stage)
            return _tree_specs(
                params_shape,
                lambda p, s: _stage_spec(p, s, self.axes.stage, n))
        r = Rules(self.mesh, self.axes, fsdp=self.fsdp)
        return _tree_specs(
            params_shape, lambda p, s: _param_spec(p, s, r, self.cfg.family,
                                                   mode=self.mode,
                                                   exact=self.exact))

    def specs_for_caches(self, caches_shape: Any, batch: int = 0,
                         slot_table: bool = False,
                         paged: bool = False) -> Any:
        """slot_table=True: the continuous-batching engine's persistent
        cache, admitted into at traced slot indices — the slot (batch) dim
        must stay unsharded or every insert crosses data shards.

        paged=True: the cache tree is a *paged arena*
        (`Model.init_paged_cache`) — per-layer `k`/`v` arenas
        (P, ps, KVH, hd) and `k_scale`/`v_scale` planes (P, ps, KVH) shard
        the kv-head dim over `model` (decode reads and the per-step scatter
        writes stay shard-local: the scatter addresses pages/offsets, never
        the head dim), while `kpos`, the per-lane page tables `pt` and the
        position counters `pos` replicate — the page table is the *shared*
        routing metadata every model shard walks identically, the TPU
        analogue of the paper's gateway routing tables."""
        if self.mode == "serve_pipeline":
            n = _axsize(self.mesh, self.axes.stage)
            return _tree_specs(
                caches_shape,
                lambda p, s: _stage_spec(p, s, self.axes.stage, n))
        r = Rules(self.mesh, self.axes, fsdp=self.fsdp)
        if paged:
            return _tree_specs(
                caches_shape, lambda p, s: _paged_cache_spec(p, s, r))
        return _tree_specs(
            caches_shape,
            lambda p, s: _cache_spec(p, s, r, batch, mode=self.mode,
                                     slot_table=slot_table))


def _axsize(mesh: DeviceMesh, axes) -> int:
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Rules:
    """Divisibility-driven spec assignment for one tensor."""

    def __init__(self, mesh: DeviceMesh, axes: MeshAxes, fsdp: bool = True):
        self.mesh, self.axes = mesh, axes
        self.tp_n = _axsize(mesh, axes.tp)
        self.dp_opts: List[Tuple[str, ...]] = []
        if fsdp:
            for i in range(len(axes.dp)):
                self.dp_opts.append(tuple(axes.dp[i:]))  # ("pod","data"),..

    def spec(self, shape: Sequence[int], tp_dim: Optional[int],
             fsdp_dim: Optional[int], offset: int = 0) -> Spec:
        """tp_dim/fsdp_dim are indices into `shape` (post-offset) or None."""
        parts: List[Any] = [None] * (len(shape) + offset)
        if tp_dim is not None and shape[tp_dim] % self.tp_n == 0:
            parts[offset + tp_dim] = self.axes.tp
        else:
            tp_dim = None
        if fsdp_dim is not None and fsdp_dim != tp_dim:
            for cand in self.dp_opts:
                n = 1
                for a in cand:
                    n *= self.mesh.shape[a]
                if shape[fsdp_dim] % n == 0:
                    parts[offset + fsdp_dim] = cand if len(cand) > 1 else cand[0]
                    break
        return P(*parts)


def _param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                r: Rules, family: str = "dense", mode: str = "train",
                exact: bool = True) -> Spec:
    """Rule table keyed on parameter names (see models/).

    mode="serve": the *reduction* projections (attention `wo`, MLP/MoE
    down-projections) replicate instead of sharding their contraction dim.
    This is the paper's Fig. 14 mapping verbatim: per-head kernels compute
    in parallel, a GMI `gather` collects the head outputs, and `linear_o`
    runs on the gathered activation — so the only cross-device reductions
    left are exact (gathers, not partial-sum psums) and a plan-sharded
    engine's token streams stay BIT-IDENTICAL to single-device serving
    (tests/test_torch_sharded_serving.py).  Serving decode activations are tiny
    (one row per lane), so the gather costs what the psum would have.
    """
    name = path[-1]
    # int8-serving leaves: "q" shards like its parent weight, "s" replicates
    if name == "s" and len(path) > 1 and path[-2] in (
            "wq", "wk", "wv", "wo", "wi", "wg", "shared_wi", "shared_wg",
            "shared_wo"):
        return P(*([None] * len(shape)))
    if name == "q" and len(path) > 1:
        name = path[-2]
    in_scan = "scan" in path  # leading stacked layer dim -> never sharded
    off = 1 if in_scan else 0
    s = shape[off:]
    nd = len(s)

    def mk(tp, fsdp):
        return r.spec(s, tp, fsdp, offset=off)

    # serve mode, TP-only plans (fsdp off): reduction projections
    # replicate (gather-form TP — the Fig. 14 gather-then-linear_o
    # mapping; exactness note in docstring).  When the plan KEPT fsdp for
    # capacity (the 400B 50GB/chip case), replicating the largest weight
    # class would OOM exactly where fsdp was retained to prevent it, so
    # those plans fall through to the normal TP+FSDP rules — correctness
    # is unchanged, only the cross-device-count bit-identity contract is
    # scoped to TP-only serve plans (docs/serving.md).
    #
    # exact=False serve plans SKIP this rule: the reduction projections
    # fall through to their normal column-sharded specs (contraction dim
    # over `model` — Megatron psum-form TP).  The matching activation
    # constraint is `hint(x, "psum")` in attention/mlp, which keeps the
    # dot partial per shard and lets XLA insert one all-reduce — the
    # paper's cross-FPGA float accumulation, accepted in exchange for the
    # tok/s ceiling (docs/serving.md §exactness contract).
    if mode == "serve" and exact and not r.dp_opts and name in (
            "wo", "shared_wo", "glu_wo", "down", "w_out"):
        return P(*([None] * len(shape)))
    # embeddings / head
    if name in ("tok", "head"):
        if name == "tok" and s[0] % r.tp_n == 0:
            return mk(0, 1)  # vocab over model, d over fsdp
        return mk(1, 0)  # fall back: d over model
    if name == "pos":
        return mk(None, None)
    # sLSTM cell does not tensor-parallelize (per-step state math would
    # reshard every scan iteration — DESIGN.md §5): its gate projection and
    # recurrent matrices stay with the (batch-sharded) state
    if name == "w_in":
        return mk(None, 0)
    if name == "r" and nd == 4:
        return P(*([None] * len(shape)))
    if name == "w_if":  # mLSTM scalar gates: tiny, replicated
        return P(*([None] * len(shape)))
    # attention
    if name in ("wq", "wk", "wv") and nd == 2:
        return mk(1, 0)
    if name == "wo" and nd == 2:
        return mk(0, 1)
    if name in ("wq", "wk", "wv") and nd == 3:  # mlstm per-head (nh, ih, dk)
        return mk(1, None)
    # mlp / moe
    if name in ("wi", "wg"):
        return mk(0 if nd == 3 else 1, 1 if nd == 3 else 0)  # moe: E over model
    if name == "wo" and nd == 3:
        return mk(0, 1)
    if name in ("shared_wi", "shared_wg", "glu_wi", "up_z", "up_g",
                "w_gate_in", "w_x_in"):
        return mk(1, 0)
    if name in ("shared_wo", "glu_wo", "down", "w_out"):
        return mk(0, 1)
    if name in ("w_rgate", "w_igate"):
        # contraction dim on `model` to match the W-sharded conv output —
        # otherwise XLA all-gathers the (B,S,W) activation (§Perf A2)
        return mk(0, None)
    if name == "conv" and nd == 2:
        return mk(1, None)
    if name in ("lam",) and nd == 1:
        return mk(0, None)
    if name == "router":
        return mk(None, 0)  # small but scan-stacked: FSDP the d dim
    # norms, biases, gains
    return P(*([None] * len(shape)))


def _cache_spec(path: Tuple[str, ...], shape: Tuple[int, ...], r: Rules,
                batch: int, mode: str = "train",
                slot_table: bool = False) -> Spec:
    name = path[-1]
    in_scan = "scan" in path
    off = 1 if in_scan else 0
    s = shape[off:]
    dp = None
    if not slot_table:  # slot tables: inserts at traced slots stay local
        for cand in r.dp_opts:
            n = 1
            for a in cand:
                n *= r.mesh.shape[a]
            if s and s[0] % n == 0:
                dp = cand if len(cand) > 1 else cand[0]
                break
    parts: List[Any] = [None] * len(shape)
    if s:
        parts[off] = dp  # batch dim
    if name in ("k", "v") and len(s) == 4 and mode == "serve":
        # slot-table layout (continuous batching): the cache is persistent
        # for the whole serving session, so the one-off insert reshard at
        # admission amortizes over the slot's lifetime.  TP the kv-head dim
        # only — decode reads split across `model`, while per-slot inserts
        # and per-step KV writes (batch + seq addressed) stay shard-local.
        if s[2] % r.tp_n == 0:
            parts[off + 2] = r.axes.tp
    elif name in ("k", "v") and len(s) == 4:
        # prefer kv-head TP; else shard head_dim (decode writes at dynamic
        # seq slots stay shard-local; a seq-sharded cache makes SPMD
        # replicate the buffer around every cache write — §Perf 0.7).
        # Small (windowed / short) caches skip TP entirely: the write-side
        # reshard costs more than replication saves (§Perf A5).
        dp_n = 1
        for cand in r.dp_opts[:1]:
            for a in cand:
                dp_n *= r.mesh.shape[a]
        per_dev_dp_only = _prod(s) * 2 / max(dp_n, 1)
        if per_dev_dp_only > 5e8:
            if s[2] % r.tp_n == 0:
                parts[off + 2] = r.axes.tp
            elif s[3] % r.tp_n == 0:
                parts[off + 3] = r.axes.tp
            elif s[1] % r.tp_n == 0:
                parts[off + 1] = r.axes.tp
    elif name in ("h", "C") and len(s) >= 2:
        if s[-1] % r.tp_n == 0:
            parts[off + len(s) - 1] = r.axes.tp
    elif name in ("c", "n", "m") and len(s) >= 2 and s[-1] % r.tp_n == 0:
        parts[off + len(s) - 1] = r.axes.tp
    elif name == "conv" and len(s) == 3 and s[-1] % r.tp_n == 0:
        parts[off + 2] = r.axes.tp
    return P(*parts)


def _paged_cache_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                      r: Rules) -> Spec:
    """Leaf rules for a paged KV arena (serve mode).

    Arena leaves have a *page* axis where dense slot caches have batch:
    `k`/`v` (P, ps, KVH, hd) and the int8 path's `k_scale`/`v_scale`
    (P, ps, KVH) put the kv-head dim on `model` when divisible — the reads
    (paged_flash_decode under shard_map) and the decode scatter (addressed
    by page/offset) then never cross shards.  `kpos` (P, ps), the per-lane
    page tables `pt` (B, MAXP) and position counters `pos` (B,) replicate:
    they are the routing metadata every shard must walk identically.
    """
    name = path[-1]
    in_scan = "scan" in path
    off = 1 if in_scan else 0
    s = shape[off:]
    parts: List[Any] = [None] * len(shape)
    if name in ("k", "v") and len(s) == 4 and s[2] % r.tp_n == 0:
        parts[off + 2] = r.axes.tp
    elif name in ("k_scale", "v_scale") and len(s) == 3 \
            and s[2] % r.tp_n == 0:
        parts[off + 2] = r.axes.tp
    return P(*parts)


def _stage_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                stage: str, stage_n: int) -> Spec:
    """mode="serve_pipeline": scan-stacked leaves (leading dim = repeated
    periods) shard that dim over the `stage` axis — stage s holds its
    contiguous slice of the layer stack, the paper's one-encoder-per-
    cluster placement — and everything else (embeddings, norms, tail
    blocks, per-lane decode state) replicates so the token feedback loop
    runs identically on every stage."""
    if "scan" in path and len(shape) >= 1 and shape[0] % stage_n == 0:
        return P(*((stage,) + (None,) * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def _tree_specs(tree, fn) -> Any:
    """Map fn(path, shape) over a nested dict of leaves with a `.shape`
    (tensors, or the reference's ShapeDtypeStructs)."""

    def go(sub, path):
        if isinstance(sub, dict):
            return {k: go(v, path + (k,)) for k, v in sub.items()}
        return fn(path, tuple(sub.shape))

    return go(tree, ())


def build_plan(cfg: ModelConfig, mesh: DeviceMesh,
               params_shape: Any = None,
               caches_shape: Any = None,
               batch: int = 0,
               mode: str = "train",
               exact: bool = True) -> ClusterPlan:
    """The Cluster Builder entry point used by launch/ and tests.

    mode="serve": weights are sharded over `model` only (no FSDP) — there
    are no gradients, and FSDP'd contraction dims turn every projection
    into a cross-data all-reduce (§Perf iteration A1: -46%% collective
    bytes on recurrentgemma prefill).  FSDP is kept when TP-only weights
    would not fit HBM (the 400B arch: 50GB/chip TP-only).  Reduction
    projections replicate (gather-form TP, `_param_spec`), so a serve
    plan's outputs are bit-identical to single-device serving.

    mode="serve_pipeline": the mesh must carry a `stage` axis; the
    scan-stacked layer dim shards over it (stage s = its slice of the
    layer stack, the paper's encoder-per-cluster placement) and everything
    else replicates — the serving executor streams decode micro-steps
    through the stages with collective_permute (serving/executor.py).

    exact=False (serve modes only): throughput plans.  serve switches the
    reduction projections to psum-form TP; serve_pipeline switches the
    executor to the request-skewed schedule with stage-local paged
    arenas.  Token streams then satisfy a match-rate band, not equality.
    """
    if mode == "serve_pipeline":
        if "stage" not in mesh.shape:
            raise ValueError(
                "mode='serve_pipeline' needs a mesh with a 'stage' axis "
                "(e.g. make_mesh((n,), ('stage',)))")
        axes = MeshAxes(dp=(), tp="model" if "model" in mesh.shape
                        else "stage", stage="stage")
        plan = ClusterPlan(cfg=cfg, axes=axes, mesh=mesh,
                           topology=build_topology(cfg), mode=mode,
                           fsdp=False, exact=exact)
        if params_shape is not None:
            plan.param_specs = plan.specs_for_params(params_shape)
        if caches_shape is not None:
            plan.cache_specs = plan.specs_for_caches(caches_shape, batch)
        plan.data_spec = lambda ndim, b: P(*((None,) * ndim))
        return plan
    axes = MeshAxes(
        dp=tuple(a for a in ("pod", "data") if a in mesh.shape), tp="model"
    )
    fsdp = True
    if mode == "serve":
        per_chip = cfg.param_count() * 2 / _axsize(mesh, axes.tp)
        fsdp = per_chip > 8e9  # keep FSDP only when capacity demands it
    plan = ClusterPlan(cfg=cfg, axes=axes, mesh=mesh,
                       topology=build_topology(cfg), mode=mode, fsdp=fsdp,
                       exact=exact)
    if params_shape is not None:
        plan.param_specs = plan.specs_for_params(params_shape)
    if caches_shape is not None:
        plan.cache_specs = plan.specs_for_caches(caches_shape, batch)
    # batch specs
    dp = axes.dp if len(axes.dp) > 1 else axes.dp[0]

    def tok_spec(b):
        ok = batch and b % _axsize(mesh, axes.dp) == 0
        return dp if ok else None

    plan.data_spec = lambda ndim, b: P(*((tok_spec(b),) + (None,) * (ndim - 1)))
    return plan


def _prod(s) -> int:
    n = 1
    for x in s:
        n *= int(x)
    return n


# ---------------------------------------------------------------------------
# Part 3: the port's tensor-parallel cut of a leaf
# ---------------------------------------------------------------------------


def block_kind(cfg: ModelConfig, path) -> Optional[str]:
    """The block kind of a params or cache leaf from its path: ("scan",
    "b{j}", ...) is the period's block j, ("tail", "{t}", ...) the tail's
    t; None elsewhere (embeddings, the final norm, "pos")."""
    if len(path) > 2 and path[0] in ("scan", "tail"):
        return cfg.block_kind(int(path[1].lstrip("b")))
    return None


# Where the port's tensor-parallel placement departs from the specs
# (Part 2, equal to the reference's; the lines are its): the reference's
# partitioner reshards between ops, the port's per-shard blocks
# (models/recurrent.py) must give one device's bits alone.  (block kind,
# leaf) -> (the dim past the layer axis that the port cuts, None for
# whole on the controller; how; the spec's line; why).  Under
# exact=False and in training the placement is the same: only the
# reductions (`w_out`, `down`, `glu_wo`, the MLP's `wo`) take row blocks
# there.
DEPARTURES = {
    **{("rglru", w): (1, "by column", ":311-314",
                      "a row block of the gate is a partial sum; each shard "
                      "takes its columns of the gathered conv output's "
                      "product") for w in ("w_rgate", "w_igate")},
    **{("mlstm", w): (None, "whole on the controller", ":299-300",
                      "an ih block is a partial sum of z . w; the cell runs "
                      "whole on the controller on the gathered z, as the "
                      "sLSTM's does") for w in ("wq", "wk", "wv")},
    **{("mlstm", s): (None, "whole on the controller", ":371-376",
                      "the cell runs whole on the controller, its state "
                      "with it (a block of heads run alone parts from the "
                      "nh-head call on an H100: chip_smoke.py's mlstm "
                      "probe)") for s in ("C", "n", "m")},
    **{("slstm", s): (None, "whole on the controller", ":371-377",
                      "the cell runs whole on the controller (:285-291), "
                      "its state with it") for s in ("h", "c", "n", "m")},
}


def tp_cut(cfg: ModelConfig, n: int, axis: str, path, shape,
           dim: Optional[int], whole: str = ""
           ) -> Tuple[Optional[int], Optional[str]]:
    """(the dim the port cuts the leaf at `path` over the tensor-parallel
    `axis` of `n` shards, None for whole on the controller; a note when
    that departs from the spec): the spec's `dim`, except that an
    attention block whose heads do not divide the axis stays whole (the
    reference's rule; `whole` ends its note), and a recurrent leaf of
    DEPARTURES takes the port's dim.  The serving executor and the
    sharded training step both place by it."""
    kind = block_kind(cfg, path)
    if kind == "attn" and "mix" in path and dim is not None and (
            cfg.n_kv_heads % n or cfg.n_heads % n):
        return None, (f"plan: {cfg.n_heads} heads / {cfg.n_kv_heads} kv "
                      f"heads do not divide '{axis}' ({n}): attention runs "
                      f"unsharded{whole}")
    rule = DEPARTURES.get((kind, path[-1]))
    if rule is None:
        return dim, None
    want, how, line, why = rule
    if isinstance(want, int):
        want += 1 if path[0] == "scan" else 0
        if shape[want] % n:
            return None, None
    if want == dim:
        return want, None
    return want, (f"plan: {kind} {path[-1]} {how}, not as "
                  f"cluster_builder.py{line} cuts it: {why}")


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (a name, a tuple, or None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharding:
    """`spec` on a mesh with devices: `split` cuts a full tensor into its
    per-shard pieces (shard f's piece on ``mesh.devices[f]``), `join`
    puts them back together.

    A dim whose entry names axes is cut into equal contiguous blocks,
    block i going to the shards whose index along those axes (row-major
    over a tuple) is i; every other dim stays whole.  Shards that hold
    the same block on the same device share one tensor, so a leaf
    replicated over shards of one card is held once."""

    def __init__(self, mesh: DeviceMesh, spec: Spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def block(self, flat: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """Shard `flat`'s block of a tensor of `shape`, as slices."""
        out = []
        for dim, size in enumerate(shape):
            axes = spec_axes(self.spec[dim] if dim < len(self.spec)
                               else None)
            if not axes:
                out.append(slice(0, size))
                continue
            n = self.mesh.axis_size(axes)
            if size % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {axes} ({n})")
            i, w = self.mesh.axis_index(flat, axes), size // n
            out.append(slice(i * w, (i + 1) * w))
        return tuple(out)

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        held: Dict[tuple, torch.Tensor] = {}
        parts = []
        for f in range(self.mesh.size):
            blk = self.block(f, t.shape)
            dev = self.mesh.device(f)
            key = (tuple((s.start, s.stop) for s in blk), str(dev))
            if key not in held:
                held[key] = t[blk].to(dev).contiguous()
            parts.append(held[key])
        return parts

    def place(self, t: torch.Tensor) -> "Sharded":
        """`t` cut into its per-shard pieces, held with this sharding."""
        return Sharded(self.split(t), self)

    def full_shape(self, part_shape: Sequence[int]) -> List[int]:
        """The full tensor's shape from one piece's."""
        out = list(part_shape)
        for dim in range(len(out)):
            axes = spec_axes(self.spec[dim] if dim < len(self.spec)
                               else None)
            if axes:
                out[dim] *= self.mesh.axis_size(axes)
        return out

    def join(self, parts: Sequence[torch.Tensor],
             device=None) -> torch.Tensor:
        """The full tensor from per-shard pieces, on `device` (default:
        shard 0's)."""
        full_shape = self.full_shape(parts[0].shape)
        dev = parts[0].device if device is None else torch.device(device)
        out = torch.empty(full_shape, dtype=parts[0].dtype, device=dev)
        for f, p in enumerate(parts):
            out[self.block(f, full_shape)] = p.to(dev)
        return out


class Sharded(list):
    """One leaf of a train plan: its pieces, one per flat shard of the
    mesh in row-major order (shards that hold one block on one device
    share a tensor), with the `Sharding` that cut them."""

    def __init__(self, parts, sharding: Sharding):
        super().__init__(parts)
        self.sharding = sharding

    @property
    def spec(self) -> Spec:
        return self.sharding.spec

    @property
    def shape(self) -> List[int]:
        return self.sharding.full_shape(self[0].shape)

    def join(self, device=None) -> torch.Tensor:
        return self.sharding.join(self, device)

    def owners(self) -> Dict[tuple, List[int]]:
        """{(block, device): the flat shards holding that block there},
        in shard order: each distinct piece once."""
        out: Dict[tuple, List[int]] = {}
        shape = self.shape
        for f, p in enumerate(self):
            blk = tuple((s.start, s.stop)
                        for s in self.sharding.block(f, shape))
            out.setdefault((blk, str(p.device)), []).append(f)
        return out

    def blocks(self) -> List[int]:
        """One flat shard for each distinct block, whatever its device."""
        seen, out = set(), []
        for (blk, _), fs in self.owners().items():
            if blk not in seen:
                seen.add(blk)
                out.append(fs[0])
        return out

"""Fleet front door: prefix-affinity dispatch over N engine replicas (port
of `repro/serving/router.py`; host-side only, no device work).

`FleetRouter` owns N `Replica`s (serving/replica.py: independent
`ContinuousBatchingEngine`s, each with its own serve plan, paged arena
and radix prefix tree) and places every incoming request on exactly one
of them.  Streams are bit-identical to single-replica serving by
construction: a replica *is* the single-process engine, greedy decode is
deterministic, and the router only ever chooses *where* a request runs.

Placement policies (`FleetConfig.route`):

  affinity     the router-side radix index maps the request's longest
               previously-routed prefix to the replica whose tree should
               hold it; cold prompts fall back to least-loaded.  The
               index is *advisory*: it records where a prefix was sent,
               not whether the replica still caches it (LRU eviction is
               replica-local), so a stale entry costs one cold prefill,
               never an error.
  least-loaded argmin over `Scheduler.projected_occupancy()` — queued
               work in token-steps, not request count, so one 2k-token
               prompt outweighs ten chat turns.
  round-robin  the control arm: rotate, ignore both signals.

Deadline-aware balancing: an affinity hit is overridden when the target
replica's backlog exceeds the least-loaded replica's by more than
`rebalance_margin` token-steps — past that, the skipped prefill can't
pay back the added queue wait against the engine's admission deadline.

Load shedding: when **every** replica's admission queue is at least
`shed_depth x shed_budget` requests deep, the request is rejected with a
reason string instead of being queued (`RouteDecision.kind == "shed"`).
Shedding at the door keeps the per-replica deadline machinery meaningful:
an unbounded router queue would just convert overload into timeouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.replica import Replica
from repro_torch.serving.scheduler import Request

ROUTE_POLICIES = ("affinity", "round-robin", "least-loaded")


@dataclass(frozen=True)
class FleetConfig:
    route: str = "affinity"
    # shedding: reject when every replica queues >= shed_depth*shed_budget
    # requests; 0 disables (the bench's closed streams never shed)
    shed_depth: int = 0
    shed_budget: float = 1.0
    # affinity override threshold, in projected-occupancy token-steps
    rebalance_margin: int = 256
    # affinity-index granularity (tokens per trie edge); match the
    # replicas' page_size so index hits line up with tree hits
    index_block: int = 16

    def __post_init__(self):
        if self.route not in ROUTE_POLICIES:
            raise ValueError(f"route {self.route!r} not in {ROUTE_POLICIES}")
        if self.index_block < 1:
            raise ValueError("index_block must be >= 1")

    @property
    def shed_limit(self) -> int:
        return (math.ceil(self.shed_depth * self.shed_budget)
                if self.shed_depth > 0 else 0)


@dataclass
class RouteDecision:
    rid: int
    replica: Optional[int]        # None iff shed
    kind: str                     # affinity|least-loaded|round-robin|
                                  # rebalanced|shed
    expected_hit_tokens: int = 0  # index-side match (advisory, see docs)
    reason: str = ""              # shed reason; empty otherwise


class _Node:
    __slots__ = ("children", "replica")

    def __init__(self):
        self.children: Dict[bytes, _Node] = {}
        self.replica: int = -1


class AffinityIndex:
    """Router-side radix index over `block`-token prompt chunks.

    Distinct from the replicas' `RadixPrefixCache`: no pages, no
    refcounts, no eviction — each trie edge is one block of tokens and
    each node remembers the replica most recently *sent* a prompt
    through it (last-writer-wins keeps the index pointing at the replica
    with the freshest copy).  Lookups cap the match at len-1 tokens,
    mirroring the tree's always-re-ingest-the-last-token rule, so
    `expected_hit_tokens` is comparable to engine `prefix_hit_tokens`.
    """

    def __init__(self, block: int):
        self.block = block
        self.root = _Node()
        self.nodes = 0

    def _key(self, tokens: np.ndarray, j: int) -> bytes:
        b = self.block
        return np.ascontiguousarray(
            tokens[j * b:(j + 1) * b], dtype=np.int32).tobytes()

    def lookup(self, tokens: np.ndarray) -> Tuple[int, int]:
        """(replica, matched_tokens) for the longest indexed block-aligned
        prefix; (-1, 0) when no full block matches."""
        max_blocks = max(len(tokens) - 1, 0) // self.block
        node, depth = self.root, 0
        for j in range(max_blocks):
            child = node.children.get(self._key(tokens, j))
            if child is None:
                break
            node, depth = child, j + 1
        if node is self.root:
            return -1, 0
        return node.replica, depth * self.block

    def insert(self, tokens: np.ndarray, replica: int) -> None:
        node = self.root
        for j in range(len(tokens) // self.block):
            key = self._key(tokens, j)
            child = node.children.get(key)
            if child is None:
                child = _Node()
                node.children[key] = child
                self.nodes += 1
            child.replica = replica
            node = child


class FleetRouter:
    """N replicas behind one `submit()`/`run()` pair (the plain engine's
    own surface, so callers swap a fleet in without code changes).

    `run()` drains the replicas **sequentially** — in-process replicas
    share the host, so the fleet measures placement quality (hit rates,
    skipped prefills, shed counts), not wall-clock parallelism; a
    multi-process fleet would run the same routing with concurrent
    drains.
    """

    def __init__(self,
                 replicas: Sequence[Union[Replica,
                                          ContinuousBatchingEngine]],
                 config: Optional[FleetConfig] = None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.replicas: List[Replica] = [
            r if isinstance(r, Replica) else Replica(i, r)
            for i, r in enumerate(replicas)]
        self.config = config or FleetConfig()
        self.index = AffinityIndex(self.config.index_block)
        self.decisions: List[RouteDecision] = []
        self.shed: List[Tuple[Request, str]] = []
        self._rr_next = 0

    # -- placement -----------------------------------------------------------

    def _least_loaded(self) -> int:
        occ = [rep.projected_occupancy() for rep in self.replicas]
        return min(range(len(occ)), key=lambda i: (occ[i], i))

    def _shed_reason(self) -> Optional[str]:
        limit = self.config.shed_limit
        if limit and all(rep.queue_depth() >= limit
                         for rep in self.replicas):
            return (f"all {len(self.replicas)} replicas saturated: "
                    f"admission queues >= {limit} "
                    f"(depth {self.config.shed_depth} x budget "
                    f"{self.config.shed_budget:g})")
        return None

    def route(self, req: Request) -> RouteDecision:
        """Pick a replica (or shed) without submitting — the policy in
        isolation, for tests and dry inspection."""
        reason = self._shed_reason()
        if reason is not None:
            return RouteDecision(rid=req.rid, replica=None, kind="shed",
                                 reason=reason)
        mode = self.config.route
        if mode == "round-robin":
            t = self._rr_next % len(self.replicas)
            return RouteDecision(rid=req.rid, replica=t, kind="round-robin")
        if mode == "least-loaded":
            return RouteDecision(rid=req.rid, replica=self._least_loaded(),
                                 kind="least-loaded")
        target, hit = self.index.lookup(req.prompt)
        if target < 0:
            return RouteDecision(rid=req.rid, replica=self._least_loaded(),
                                 kind="least-loaded")
        least = self._least_loaded()
        lag = (self.replicas[target].projected_occupancy()
               - self.replicas[least].projected_occupancy())
        if least != target and lag > self.config.rebalance_margin:
            return RouteDecision(rid=req.rid, replica=least,
                                 kind="rebalanced", expected_hit_tokens=0)
        return RouteDecision(rid=req.rid, replica=target, kind="affinity",
                             expected_hit_tokens=hit)

    def submit(self, req: Request) -> RouteDecision:
        dec = self.route(req)
        self.decisions.append(dec)
        if dec.kind == "shed":
            self.shed.append((req, dec.reason))
            return dec
        if dec.kind == "round-robin":
            self._rr_next += 1
        if self.config.route == "affinity":
            self.index.insert(req.prompt, dec.replica)
        self.replicas[dec.replica].submit(req)
        return dec

    # -- serving -------------------------------------------------------------

    def run(self) -> List[Request]:
        """Drain every replica; completed requests sorted by rid (the
        engine's own contract).  Shed requests are *not* in the result —
        read `router.shed` for them."""
        done: List[Request] = []
        for rep in self.replicas:
            done.extend(rep.run())
        return sorted(done, key=lambda r: r.rid)

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict:
        by_kind: Dict[str, int] = {}
        exp_hit = 0
        for d in self.decisions:
            by_kind[d.kind] = by_kind.get(d.kind, 0) + 1
            exp_hit += d.expected_hit_tokens
        per = [rep.stats() for rep in self.replicas]
        return {
            "route": self.config.route,
            "submitted": len(self.decisions),
            "shed": len(self.shed),
            "by_kind": by_kind,
            "expected_hit_tokens": exp_hit,
            "index_nodes": self.index.nodes,
            "prefix_hits": sum(p.get("prefix_hits", 0) for p in per),
            "prefix_hit_tokens": sum(p.get("prefix_hit_tokens", 0)
                                     for p in per),
            "replicas": per,
        }


def build_fleet(model, params, n: int, *,
                plans: Optional[Sequence] = None,
                config: Optional[FleetConfig] = None,
                **engine_kw) -> FleetRouter:
    """N fresh engines (shared read-only model/params, per-replica plan)
    behind one router.  `plans[i]` places replica i on its device group
    (serving/replica.py `replica_device_groups` + `make_group_mesh`);
    None serves every replica from the model's device."""
    plans = list(plans) if plans is not None else [None] * n
    if len(plans) != n:
        raise ValueError(f"fleet: {n} replicas but {len(plans)} plans")
    engines = [ContinuousBatchingEngine(model, params, plan=plans[i],
                                        **engine_kw)
               for i in range(n)]
    return FleetRouter([Replica(i, e) for i, e in enumerate(engines)],
                       config)

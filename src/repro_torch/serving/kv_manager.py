"""KV memory management for the serving engine (host-side, no device code).

Owns everything about *where cache bytes live*: the paged arena's
free-list allocator (`core/packing.PagePool`), the radix prefix cache that
lets requests share prompt KV copy-free, the per-lane page lists, and the
page-table / reset rows an admission hands to the executor.  The split
mirrors the paper's memory story: on-chip URAM is the scarce resource the
Cluster Builder budgets per kernel; here KV HBM is budgeted per page, and
the KV manager is the single owner of that budget.

The executor (serving/executor.py) consumes the numpy rows built here as
device operands; the scheduler (serving/scheduler.py) consumes the
free-page / eviction signals as admission gates.  Neither touches the
pool directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.packing import PagePool, RadixPrefixCache


def kv_page_bytes(cfg, page_size: int, kv_dtype: str,
                  shards: int = 1) -> int:
    """HBM bytes one KV arena page costs *per device* — the unit for
    equal-HBM pool sizing (docs/perf.md §int8 pages).

    bf16: 2 (k+v) * KVH * hd elements at 2 B per cache row; int8: the same
    elements at 1 B plus 2 * KVH f32 scales per row, i.e. (hd+4)/(2*hd) of
    the bf16 bytes — a fixed budget holds ~2x the pages at hd=64.

    shards > 1: the arena is stage-sharded (exact=False serve_pipeline —
    each stage holds only its own layers' slice of every page), so a page
    costs 1/shards of the full stack per device and a per-device budget
    buys shards× the pages.  The division only applies when the layer
    stack actually divides; otherwise the arena replicates and a page
    costs its full span everywhere — sizing with the divided figure there
    is exactly the over-subscription bug the per-shard residency ledger
    (`KVManager(shards=)`) guards against.
    """
    per_row = 2 * cfg.n_kv_heads * cfg.head_dim  # k+v elements
    if kv_dtype == "int8":
        row_bytes = per_row + 2 * cfg.n_kv_heads * 4  # values + f32 scales
    else:
        row_bytes = per_row * 2
    n_layers = cfg.n_layers
    if shards > 1 and n_layers % shards == 0:
        n_layers //= shards
    return n_layers * page_size * row_bytes


def num_pages_for_hbm(cfg, page_size: int, kv_dtype: str,
                      hbm_bytes: int, shards: int = 1) -> int:
    """Pool size (usable pages) a *per-device* byte budget buys at this
    dtype; with a stage-sharded arena (shards=stage depth) the same
    budget holds shards× the pages."""
    return int(hbm_bytes // kv_page_bytes(cfg, page_size, kv_dtype,
                                          shards=shards))


def spec_pool_split(cfg, draft_cfg, page_size: int, kv_dtype: str,
                    hbm_bytes: int) -> int:
    """Pages *per arena* one HBM byte budget buys when a target and a
    draft arena share it position-for-position (speculative decoding):
    every lane position costs one target row plus one draft row, so the
    two pools hold the same page count and the budget divides by the
    summed per-page cost.  docs/serving.md §speculative decoding."""
    both = (kv_page_bytes(cfg, page_size, kv_dtype)
            + kv_page_bytes(draft_cfg, page_size, kv_dtype))
    return int(hbm_bytes // both)


def paged_eligible(cfg, plan=None) -> bool:
    """Can this (config, plan) pair serve from the paged arena?  The one
    predicate the engine's ``paged="auto"`` and the serve CLI's guards
    share: all-attention, unwindowed, causal (recurrent state and ring
    buffers have no paged analogue), under no plan, a ``mode="serve"``
    plan, or a throughput (exact=False) ``serve_pipeline`` plan — the
    request-skewed schedule decodes straight from stage-local arenas,
    while the *exact* pipeline streams the dense slot path."""
    from repro_torch.models.transformer import layer_plan  # lazy: pulls torch
    _, _, kinds = layer_plan(cfg)
    return (all(k == "attn" for k in kinds) and not cfg.local_window
            and bool(cfg.causal)
            and (plan is None or plan.mode == "serve"
                 or (plan.mode == "serve_pipeline"
                     and not getattr(plan, "exact", True))))


@dataclass
class AdmissionGrant:
    """Everything one paged admission needs: the lane's full page list,
    the covered prefix length (0 = cold), and the executor-ready rows —
    `pt_row` (the lane's page table, trash-padded) and `reset` (pages
    whose kpos must re-sentinel before use, trash-padded)."""
    pages: List[int]
    hit_pages: List[int]
    hit_len: int
    pt_row: np.ndarray
    reset: np.ndarray
    # speculative decoding only: the lane's draft-arena pages (always
    # exclusively owned — the draft arena has no radix tree, its content
    # is disposable lookahead state) and their executor-ready rows
    draft_pages: Optional[List[int]] = None
    draft_pt_row: Optional[np.ndarray] = None
    draft_reset: Optional[np.ndarray] = None


class KVManager:
    """Page-pool + radix-tree owner for one engine.

    Reference-count discipline: a page is held by the lane that owns it
    (`_lane_pages`), by the radix tree once registered, and by any lane
    that hit on it; `release()` drops the lane references and the tree
    keeps registered prefix pages alive for future hits.

    shards > 1: the arena is sharded (stage-local arenas under a
    throughput serve_pipeline plan, kv-head TP under serve), so one
    logical page is physically a slab on *every* shard.  The manager then
    keeps a per-shard residency ledger updated from the pages each
    alloc/release/eviction ACTUALLY freed (`PagePool.decref` /
    `RadixPrefixCache.evict` return counts) — not from the requested
    full-span count, which over-frees per-shard bytes whenever a decref
    lands on a still-shared page.  `assert_drained` cross-checks every
    shard's ledger against the pool, so a cross-stage page leak (one
    stage's slab freed, another's stranded) fails loudly at drain.
    """

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages: int, draft_num_pages: int = 0,
                 shards: int = 1):
        self.pool = PagePool(num_pages, page_size)
        self.prefix_cache = RadixPrefixCache(self.pool)
        self.page_size = page_size
        self.max_pages = max_pages  # page-table row width (per-lane cap)
        self._lane_pages: List[Optional[List[int]]] = [None] * max_batch
        self.shards = max(1, int(shards))
        # per-shard resident page slabs (one logical page = one slab on
        # each shard); kept explicitly so drift from mis-accounted frees
        # is detectable rather than silently oversubscribing HBM
        self._shard_pages = np.zeros(self.shards, np.int64)
        # speculative decoding's second arena: same page granularity, no
        # radix tree (draft KV is disposable lookahead — never shared, and
        # rejection rollback is a device-side position rewind, so the page
        # accounting is purely lane-owned alloc/release).  Both pools draw
        # on one HBM budget via spec_pool_split.
        self.draft_pool: Optional[PagePool] = (
            PagePool(draft_num_pages, page_size) if draft_num_pages else None)
        self._draft_lane_pages: List[Optional[List[int]]] = \
            [None] * max_batch

    # -- per-shard residency ---------------------------------------------------

    def _resident(self, n: int) -> None:
        self._shard_pages += n

    def _freed(self, n: int) -> None:
        self._shard_pages -= n
        assert (self._shard_pages >= 0).all(), self._shard_pages

    def shard_pages_in_use(self, shard: int = 0) -> int:
        return int(self._shard_pages[shard])

    def evict_cached(self, n_pages: int) -> int:
        """Evict up to `n_pages` LRU cached prefix pages through the
        per-shard ledger (the only correct external eviction path — a
        bare `prefix_cache.evict()` would desync `_shard_pages`).
        Returns the count actually freed (shared pages stay resident)."""
        freed = self.prefix_cache.evict(n_pages)
        self._freed(freed)
        return freed

    def stage_view(self, shard: int) -> "StageArenaView":
        """Read-only accounting view of one shard's slice of the arena —
        what a pipeline stage 'owns' (its layers' slabs of every resident
        page) without handing it the allocator."""
        return StageArenaView(self, shard)

    # -- capacity ------------------------------------------------------------

    def pages_for(self, n_positions: int) -> int:
        return self.pool.pages_for(n_positions)

    @property
    def num_pages(self) -> int:
        return self.pool.num_pages

    @property
    def free_pages(self) -> int:
        return self.pool.free_pages

    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    # -- admission -----------------------------------------------------------

    def admit(self, prompt: np.ndarray, rem_budget: int,
              max_hit_suffix: int,
              spec_margin: int = 0) -> Optional[AdmissionGrant]:
        """Reserve pages for `prompt` + `rem_budget` decode positions.

        Radix lookup first: a hit reuses the shared prefix pages (already
        incref'd by lookup) and only the un-hit remainder is allocated; a
        hit whose suffix exceeds `max_hit_suffix` is declined (one dense
        prefill is cheaper than re-ingesting that many tokens through the
        decode loop).  Under pool pressure cached prefixes are LRU-evicted
        before giving up.  Returns None (nothing held) when the pool can't
        cover the request — the scheduler may then preempt-to-free.

        spec_margin (speculative decoding): extra positions both arenas
        must be able to scatter — a speculative block writes up to
        `spec_k` rows past the lane's committed position before acceptance
        is known, and a clipped page-table gather would otherwise alias
        the lane's last page.  When a draft pool exists the lane also
        needs the same positions in the draft arena (no radix there: the
        full span is always exclusively owned); if the draft pool can't
        cover it the target-side reservation is rolled back and the
        admission declines as a unit.
        """
        pool = self.pool
        need_positions = len(prompt) + rem_budget + spec_margin
        need_pages = pool.pages_for(need_positions)
        hit_pages, hit_len = self.prefix_cache.lookup(prompt)
        if hit_len and len(prompt) - hit_len > max_hit_suffix:
            # suffix too long: prefill is cheaper
            self._freed(len(pool.decref(hit_pages)))
            hit_pages, hit_len = [], 0
        own_need = need_pages - len(hit_pages)
        if own_need > pool.free_pages:
            # eviction frees per-shard slabs: the ledger moves by the
            # pages the tree ACTUALLY freed on every shard, not by the
            # requested full-span count (shared pages stay resident)
            self._freed(self.prefix_cache.evict(own_need - pool.free_pages))
        if own_need > pool.free_pages:
            self._freed(len(pool.decref(hit_pages)))
            return None
        draft_pages = draft_pt = draft_reset = None
        if self.draft_pool is not None:
            draft_need = self.draft_pool.pages_for(need_positions)
            if draft_need > self.draft_pool.free_pages:
                self._freed(len(pool.decref(hit_pages)))
                return None
            draft_pages = self.draft_pool.alloc(draft_need)
            draft_pt = np.zeros((self.max_pages,), np.int32)
            draft_pt[:len(draft_pages)] = draft_pages
            draft_reset = np.zeros((self.max_pages,), np.int32)
            draft_reset[:len(draft_pages)] = draft_pages
        own = pool.alloc(own_need)
        self._resident(len(own))
        pages = hit_pages + own
        pt_row = np.zeros((self.max_pages,), np.int32)
        pt_row[:len(pages)] = pages
        reset = np.zeros((self.max_pages,), np.int32)  # trash-page padded
        reset[:len(own)] = own
        return AdmissionGrant(pages=pages, hit_pages=hit_pages,
                              hit_len=hit_len, pt_row=pt_row, reset=reset,
                              draft_pages=draft_pages, draft_pt_row=draft_pt,
                              draft_reset=draft_reset)

    def peek_hit(self, prompt: np.ndarray) -> int:
        """Advisory prefix-hit length (positions) for `prompt` — no
        references taken, no LRU/stat mutation.  The disaggregated
        scheduler classifies queued requests with this (hit => the
        decode-ingest queue, no prefill-pool work); `admit` re-checks at
        admission time, so a stale answer only mis-sorts the queue."""
        return self.prefix_cache.peek(prompt)

    # -- page shipping (disaggregated prefill pool side) ----------------------

    def stage_export(self, n_pages: int) -> AdmissionGrant:
        """Reserve `n_pages` staging pages in THIS manager's arena (the
        prefill pool's) for one admission's prefill KV, to be shipped to
        a decode-pool arena and then released via `finish_export`.

        Returns an AdmissionGrant whose pt_row/reset rows drive the
        executor's `prefill_admit` scatter at staging slot 0 — the exact
        rows a colocated cold admission would build, so the staged page
        contents are bitwise what `admit_cold` writes.  Exports are
        transient (one in flight per admission), so a pool sized
        `max_pages + 1` can never decline."""
        own = self.pool.alloc(n_pages)
        self._resident(len(own))
        pt_row = np.zeros((self.max_pages,), np.int32)
        pt_row[:len(own)] = own
        reset = np.zeros((self.max_pages,), np.int32)
        reset[:len(own)] = own
        return AdmissionGrant(pages=own, hit_pages=[], hit_len=0,
                              pt_row=pt_row, reset=reset)

    def finish_export(self, pages: List[int]) -> None:
        """Release a `stage_export` reservation after its pages were
        shipped.  Ledger moves by the pages ACTUALLY freed (the same
        discipline as `release`), so a future prefill-side prefix cache
        sharing staged pages stays correctly accounted."""
        self._freed(len(self.pool.decref(pages)))

    def commit(self, slot: int, grant: AdmissionGrant) -> None:
        self._lane_pages[slot] = grant.pages
        if grant.draft_pages is not None:
            self._draft_lane_pages[slot] = grant.draft_pages

    def register_prefix(self, prompt: np.ndarray, pages: List[int]) -> int:
        """Register a cold prompt's full pages for future prefix hits —
        hit-path suffix pages are never registered (their KV fills in over
        later decode dispatches; a preemption could strand them
        half-written)."""
        return self.prefix_cache.insert(prompt, pages)

    def release(self, slot: int) -> None:
        """Return lane `slot`'s page references (tree references keep
        registered prefix pages alive for future hits)."""
        if self._lane_pages[slot] is not None:
            self._freed(len(self.pool.decref(self._lane_pages[slot])))
            self._lane_pages[slot] = None
        if self._draft_lane_pages[slot] is not None:
            # draft pages are never shared (no tree refs), so this frees
            # them unconditionally — retirement, preemption, and
            # rejection-rollback all reduce to the same lane release
            self.draft_pool.decref(self._draft_lane_pages[slot])
            self._draft_lane_pages[slot] = None

    # -- invariants ----------------------------------------------------------

    def assert_drained(self) -> None:
        """When the engine drains, the only live page references are the
        radix tree's — anything else is a leak.  With a sharded arena the
        per-shard ledgers must all agree with the pool: a shard whose
        slab count drifted means some path freed (or kept) pages on one
        stage's slice without the others — a cross-stage page leak."""
        assert all(p is None for p in self._lane_pages), self._lane_pages
        assert self.pool.pages_in_use == self.prefix_cache.cached_pages, (
            self.pool.pages_in_use, self.prefix_cache.cached_pages)
        assert (self._shard_pages == self.pool.pages_in_use).all(), (
            self._shard_pages, self.pool.pages_in_use)
        if self.draft_pool is not None:
            assert all(p is None for p in self._draft_lane_pages), \
                self._draft_lane_pages
            assert self.draft_pool.pages_in_use == 0, \
                self.draft_pool.pages_in_use


class StageArenaView:
    """One shard's (pipeline stage's) accounting window on the arena.

    Stage s physically holds its own layers' slice of every page; this
    view reports residency/capacity in that stage's terms — pages are
    global (the page table is shared routing metadata), bytes are local.
    Read-only: all allocation goes through the owning KVManager, which is
    what keeps the shards' ledgers moving in lockstep.
    """

    def __init__(self, mgr: KVManager, shard: int):
        assert 0 <= shard < mgr.shards, (shard, mgr.shards)
        self._mgr, self.shard = mgr, shard

    @property
    def pages_in_use(self) -> int:
        return self._mgr.shard_pages_in_use(self.shard)

    @property
    def free_pages(self) -> int:
        return self._mgr.pool.free_pages

    def resident_bytes(self, cfg, kv_dtype: str = "bf16") -> int:
        """This stage's HBM actually held by resident pages."""
        return self.pages_in_use * kv_page_bytes(
            cfg, self._mgr.page_size, kv_dtype, shards=self._mgr.shards)

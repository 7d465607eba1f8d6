"""No-padding adaptation (paper §7.1): buckets + sequence packing.

The paper's PEs iterate only over real tokens, padding just to
NUM_PE * ceil(M / NUM_PE).  Under XLA's static shapes the equivalents are:

  * `bucket_len`: round a length up to the hardware tile (128 = MXU lanes,
    standing in for NUM_PE) and pick the smallest pre-compiled bucket —
    minimum padding, one compiled program per bucket.
  * `pack_sequences`: first-fit-decreasing packing of many short sequences
    into fixed (B, S) rows with segment_ids + per-token positions; attention
    masks cross-segment pairs (models/attention.py), so no FLOPs are spent
    attending across packed neighbors and utilization ~= sum(len)/B*S.
  * `AdmissionPolicy`: per-slot bucket admission ordering for the
    continuous-batching serving engine (docs/serving.md) — deadline-overdue
    FIFO first, then warm (already-compiled) buckets.
  * `PagePool` / `RadixPrefixCache`: the paged-KV analogues — a
    reference-counted free-list allocator over the global KV page arena and
    a page-granular radix tree that lets requests sharing a prompt prefix
    reuse its KV pages copy-free (docs/serving.md §paged KV).

Both are exercised by the Table-3/Table-4 benchmarks (padding vs no-padding).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

LANE = 128  # MXU lane width == the paper's NUM_PE rounding granularity


def bucket_len(length: int, buckets: Sequence[int] = (), lane: int = LANE
               ) -> int:
    """Minimum padded length: smallest bucket >= length, else lane-rounded."""
    for b in sorted(buckets):
        if length <= b:
            return b
    return ((length + lane - 1) // lane) * lane


@dataclass
class Packed:
    tokens: np.ndarray  # (B, S) int32, 0-padded
    segment_ids: np.ndarray  # (B, S) int32, -1 on padding
    positions: np.ndarray  # (B, S) int32, position within own segment
    n_segments: int

    @property
    def utilization(self) -> float:
        return float((self.segment_ids >= 0).mean())


def pack_sequences(seqs: List[np.ndarray], row_len: int) -> Packed:
    """First-fit-decreasing packing into rows of row_len."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    rows: List[List[int]] = []  # seq indices per row
    space: List[int] = []
    for i in order:
        n = len(seqs[i])
        if n > row_len:
            raise ValueError(f"sequence {i} (len {n}) exceeds row {row_len}")
        placed = False
        for rix in range(len(rows)):
            if space[rix] >= n:
                rows[rix].append(i)
                space[rix] -= n
                placed = True
                break
        if not placed:
            rows.append([i])
            space.append(row_len - n)

    b = len(rows)
    tokens = np.zeros((b, row_len), np.int32)
    seg = np.full((b, row_len), -1, np.int32)
    pos = np.zeros((b, row_len), np.int32)
    sid = 0
    for rix, members in enumerate(rows):
        cur = 0
        for i in members:
            n = len(seqs[i])
            tokens[rix, cur:cur + n] = seqs[i]
            seg[rix, cur:cur + n] = sid
            pos[rix, cur:cur + n] = np.arange(n)
            cur += n
            sid += 1
    return Packed(tokens, seg, pos, n_segments=sid)


@dataclass
class AdmissionPolicy:
    """Per-slot bucket admission for the continuous-batching engine.

    Admission is work-conserving: whenever a slot is free and a request has
    arrived, something is admitted (no holding slots back to fill a bucket —
    the paper's pipeline never waits for a wave, §8.2).  The policy only
    decides *order*:

      * requests whose queue wait exceeds the deadline go first, FIFO
        (runtime/stragglers.AdmissionDeadline — the deadline that used to
        launch partial waves now bounds admission reordering);
      * otherwise requests whose bucket is already compiled ("warm") are
        preferred, so steady-state admission never stalls the decode loop
        on a prefill compile;
      * ties break FIFO.

    `deadline` is any object with ``overdue(wait_s) -> bool``.
    """

    buckets: Sequence[int]
    lane: int = 8
    deadline: object = None

    def bucket_of(self, prompt_len: int) -> int:
        return bucket_len(prompt_len, self.buckets, lane=self.lane)

    def select(self, waiting: Sequence, n_free: int, warm=(),
               now: float = 0.0) -> List[int]:
        """Indices into `waiting` (arrival order) to admit, at most n_free.

        Each element of `waiting` needs `.prompt` and `.t_arrival` (seconds,
        relative to the same clock as `now`).
        """
        warm = set(warm)

        def key(ix: int):
            r = waiting[ix]
            wait = now - r.t_arrival
            if self.deadline and self.deadline.overdue(wait):
                return (0, 0, ix)  # overdue: strict FIFO, warmth ignored
            cold = self.bucket_of(len(r.prompt)) not in warm
            return (1, 1 if cold else 0, ix)

        return sorted(range(len(waiting)), key=key)[:n_free]


class PagePool:
    """Free-list allocator over a global paged KV arena.

    The serving engine's HBM analogue of the paper's scarce on-chip URAM:
    KV capacity is a pool of fixed-size pages handed to requests on
    admission and returned on completion/preemption, so memory scales with
    *actual* sequence lengths instead of one worst-case slot row per lane.

    Pages are reference-counted: a page may be held by the lane that wrote
    it, by the radix prefix cache, and by any number of prefix-hit lanes
    simultaneously; it returns to the free list when the last reference
    drops.  Page 0 is reserved as the *trash page* and never allocated —
    inactive decode lanes scatter their masked writes there and unused
    page-table entries point at it, and since its `kpos` stay at the
    never-written sentinel it is unreachable by attention.
    """

    TRASH_PAGE = 0

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently-freed (cache-warm) pages are reused first
        self._free: List[int] = list(range(1, num_pages))
        self._ref = np.zeros(num_pages, np.int32)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def pages_for(self, n_positions: int) -> int:
        """Pages needed to hold n_positions KV slots."""
        return -(-n_positions // self.page_size)

    def alloc(self, n: int) -> List[int]:
        """Take n pages (refcount 1 each); raises if the pool can't cover
        it — callers gate admission on `free_pages` / evict first."""
        if n > len(self._free):
            raise MemoryError(f"PagePool: want {n}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._ref[pages] += 1
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert 0 < p < self.num_pages and self._ref[p] > 0, p
            self._ref[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that freed."""
        freed = []
        for p in pages:
            assert 0 < p < self.num_pages and self._ref[p] > 0, p
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def refcount(self, page: int) -> int:
        return int(self._ref[page])


class _RadixNode:
    __slots__ = ("children", "parent", "key", "page", "last_used")

    def __init__(self, parent=None, key=None, page: int = -1):
        self.children = {}  # page-of-tokens tuple -> _RadixNode
        self.parent = parent
        self.key = key
        self.page = page
        self.last_used = 0


class RadixPrefixCache:
    """Page-granular radix tree mapping prompt prefixes to arena pages.

    Each edge is one *full page* of prompt tokens (`page_size` of them) and
    each node owns one tree reference on the arena page holding that KV.
    Requests whose prompts share a system/common prefix therefore reuse the
    prefix KV copy-free: a lookup hands back the shared pages (incref'd for
    the caller) and the engine skips prefill for the covered positions.

    Copy-on-write is free by page alignment: a hit always covers a
    page-aligned prefix strictly shorter than the prompt, so every position
    a sharing lane will ever *write* (suffix ingest + decode) lands in
    pages the lane owns exclusively — shared pages are only ever read.

    Eviction is LRU over evictable leaves (no children, no live lane
    references) and only runs under pool pressure, so a cached prefix
    survives as long as capacity allows.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _RadixNode()
        self._clock = 0
        self._nodes = 0
        self.hits = 0
        self.lookups = 0

    def _page_key(self, tokens: np.ndarray, j: int):
        ps = self.pool.page_size
        return tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def lookup(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """Longest cached page-aligned prefix of `tokens`, capped at
        len(tokens) - 1 positions so at least the final prompt token is
        always re-ingested (its forward pass produces the first logits).

        Returns (pages, hit_len).  The caller owns one new reference on
        each returned page (released via `pool.decref` when the lane
        finishes)."""
        ps = self.pool.page_size
        max_pages = max(len(tokens) - 1, 0) // ps
        self._clock += 1
        self.lookups += 1
        node, pages = self.root, []
        for j in range(max_pages):
            child = node.children.get(self._page_key(tokens, j))
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.pool.incref(pages)
            self.hits += 1
        return pages, len(pages) * ps

    def peek(self, tokens: np.ndarray) -> int:
        """Length (in positions) of the cached page-aligned prefix a
        `lookup` of `tokens` would return, WITHOUT taking references,
        bumping the LRU clock, or counting a hit/lookup.  Advisory only —
        the answer can change before an admission actually calls
        `lookup` — used by the disaggregated scheduler to classify queued
        requests into the prefill vs decode-ingest queue."""
        ps = self.pool.page_size
        max_pages = max(len(tokens) - 1, 0) // ps
        node, n = self.root, 0
        for j in range(max_pages):
            child = node.children.get(self._page_key(tokens, j))
            if child is None:
                break
            n += 1
            node = child
        return n * ps

    def insert(self, tokens: np.ndarray, pages: Sequence[int]) -> int:
        """Register a prompt's fully-covered pages; ``pages[j]`` must back
        positions [j*ps, (j+1)*ps).  Pages already on the walk are left as
        the canonical copy (the caller's duplicate stays lane-private);
        newly registered pages gain one tree reference.  Returns the number
        of newly registered pages."""
        ps = self.pool.page_size
        n_full = len(tokens) // ps  # only pages the prompt fills completely
        self._clock += 1
        node, added = self.root, 0
        for j in range(min(n_full, len(pages))):
            key = self._page_key(tokens, j)
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(parent=node, key=key, page=pages[j])
                node.children[key] = child
                self.pool.incref([pages[j]])
                self._nodes += 1
                added += 1
            child.last_used = self._clock
            node = child
        return added

    def _evictable_leaves(self) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.pool.refcount(n.page) == 1:  # tree-only reference
                out.append(n)
        return out

    def evict(self, n_pages: int) -> int:
        """Free at least n_pages by LRU leaf eviction; returns pages
        actually freed (may be fewer if everything left is shared)."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda nd: nd.last_used)
            for nd in leaves:
                nd.parent.children.pop(nd.key)
                self._nodes -= 1
                freed += len(self.pool.decref([nd.page]))
                if freed >= n_pages:
                    break
        return freed

    @property
    def cached_pages(self) -> int:
        return self._nodes


def padded_batch(seqs: List[np.ndarray], row_len: int) -> Packed:
    """The baseline the paper compares against: one sequence per row,
    padded to the maximum length."""
    b = len(seqs)
    tokens = np.zeros((b, row_len), np.int32)
    seg = np.full((b, row_len), -1, np.int32)
    pos = np.zeros((b, row_len), np.int32)
    for i, s in enumerate(seqs):
        n = len(s)
        tokens[i, :n] = s
        seg[i, :n] = i
        pos[i, :n] = np.arange(n)
    return Packed(tokens, seg, pos, n_segments=b)

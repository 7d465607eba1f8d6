"""Device-side serving execution for one device (port of
`repro/serving/executor.py`: the paged and the dense slot paths, and
greedy speculative decoding on the paged one).

The executor owns the params (quantized once for W8A8 serving when
asked, the draft's too) and the device decode state: bucketed
prefill, the fused n-step decode loop (`Model.decode_steps`), and the lane
admission/park updates.  PyTorch runs eagerly, so there is nothing to
compile; the state tensors are updated in place.  Each decode dispatch
returns one (n, B) token tensor that the engine fetches once — the loop
itself never syncs with the host.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.packing import bucket_len
from repro_torch.models.quantized import quantize_params_for_serving
from repro_torch.models.transformer import Model

PAD_TOKEN = 0  # fed for finished/free lanes; their logits are never read


class Executor:
    """Device programs + decode state for one serving engine."""

    def __init__(self, model: Model, params, max_batch: int = 8,
                 cache_len: int = 0, buckets=(), quant_weights: bool = False):
        self.model = model
        self.quant_weights = bool(quant_weights)
        if self.quant_weights:
            params = quantize_params_for_serving(params)
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.cache_len = cache_len  # a paged engine re-rounds it to pages
        self.buckets = tuple(sorted(buckets))
        self._warm = []  # buckets prefilled at batch 1, first-use order
        # speculative decoding (set_draft): the draft model and its params
        self.draft_model = None
        self.draft_params = None

    def set_draft(self, draft_model: Model, draft_params) -> None:
        """Install the speculative-decoding draft model; its weights take
        the target's W8A8 switch, as in the reference."""
        if self.quant_weights:
            draft_params = quantize_params_for_serving(draft_params)
        self.draft_model = draft_model
        self.draft_params = draft_params

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- cache / state -------------------------------------------------------

    def init_caches(self, paged: bool, page_size: int = 0,
                    num_pages: int = 0, max_pages: int = 0,
                    kv_dtype: str = "bf16"):
        """The persistent serving cache: a paged arena, or dense slot rows
        (max_batch x cache_len)."""
        if paged:
            return self.model.init_paged_cache(self.max_batch, num_pages,
                                               page_size, max_pages,
                                               kv_dtype=kv_dtype)
        return self.model.init_cache(self.max_batch, self.cache_len)

    def init_draft_caches(self, page_size: int, num_pages: int,
                          max_pages: int, kv_dtype: str = "bf16"):
        """The draft model's paged arena (its own page pool)."""
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
                 cache_slots: Optional[int]):
        """Bucketed left-aligned batched prefill on `model` into a dense
        cache of `cache_slots` rows (None: the bucket); returns (logits
        (batch, V), caches, bucket)."""
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
        with torch.no_grad():
            logits, caches = model.prefill(
                params, caches, self._tensor(toks),
                positions=self._tensor(pos),
                last_idx=self._tensor(lengths - 1, torch.long))
        return logits, caches, bucket

    def prefill_prompts(self, prompts, batch: int,
                        bucket_cache: bool = False):
        """Bucketed left-aligned batched prefill; returns (logits (batch,
        V), caches).  bucket_cache=True writes a bucket-sized cache (an
        admission then scatters or inserts it); otherwise the cache spans
        cache_len and is decoded into directly (waves)."""
        logits, caches, bucket = self._prefill(
            self.model, self.params, prompts, batch,
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
        kw = (dict(forced=st["forced"], forced_len=st["flen"],
                   forced_ptr=st["fptr"]) if paged else {})
        with torch.no_grad():
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
        with torch.no_grad():
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
                                          None)
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

    def admit_hit(self, st, slot: int, pt_row, pos0: int, reset) -> None:
        """Point a lane at its (shared prefix + own) pages; the suffix
        arrives later through the decode loop's forced queue."""
        self.model.admit_lane_cache(st["caches"], slot, pt_row, pos0, reset)

    def admit_cold(self, st, slot: int, small, pt_row, pos0: int, reset,
                   write_pages: np.ndarray) -> None:
        """Scatter a bucket prefill cache into the lane's arena pages."""
        self.model.admit_lane_cache(st["caches"], slot, pt_row, pos0, reset,
                                    small=small, write_pages=write_pages)

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

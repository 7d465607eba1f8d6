"""Deterministic synthetic token pipeline (port of
`repro/data/pipeline.py`; numpy only).

A seeded first-order Markov chain over the vocabulary (low-entropy rows),
so training loss measurably falls within a few hundred steps: the
substrate for the train CLI without external data.  Documents have
Zipf-ish lengths, so the packed (no-padding, paper §7.1) path has
something real to pack (`core/packing.pack_sequences`).  The draws are
the reference's, call for call: the same seed gives the same batches,
plain and packed.

Batches are host numpy; the train loop moves them to its device, and
`shard_batch` places one on a train plan's mesh (each data replica's
rows on its shards' devices), as the reference's `device_put` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
import torch

from repro_torch.core.cluster_builder import Sharded, Sharding
from repro_torch.core.packing import Packed, pack_sequences


@dataclass
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    branching: int = 4  # candidate successors per token (entropy knob)
    pack: bool = False
    mean_doc_len: int = 0  # 0 -> full-row documents

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # chain lives on a vocab prefix
        self._v = v
        self._succ = rng.integers(0, v, size=(v, self.branching))
        self._rng = np.random.default_rng(self.seed + 1)

    def _gen_doc(self, length: int) -> np.ndarray:
        rng = self._rng
        out = np.empty(length + 1, np.int64)
        t = int(rng.integers(0, self._v))
        for i in range(length + 1):
            out[i] = t
            t = int(self._succ[t, rng.integers(0, self.branching)])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        b, s = self.batch, self.seq_len
        if not self.pack:
            docs = [self._gen_doc(s) for _ in range(b)]
            arr = np.stack(docs)  # (B, S+1)
            return {
                "tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32),
            }
        # packed mode: variable-length docs, first-fit into B rows
        mean = self.mean_doc_len or max(s // 4, 8)
        seqs: List[np.ndarray] = []
        budget = b * s
        used = 0
        while used < budget * 0.98:
            n = int(np.clip(self._rng.zipf(1.6) * mean // 4, 8, s))
            n = min(n, budget - used)
            if n < 8:
                break
            seqs.append(self._gen_doc(n))
            used += n
        packed = pack_sequences([d[:-1] for d in seqs], s)
        rows = packed.tokens.shape[0]
        if rows > b:
            packed = Packed(packed.tokens[:b], packed.segment_ids[:b],
                            packed.positions[:b], packed.n_segments)
        elif rows < b:
            padf = lambda a, fill: np.concatenate(  # noqa: E731
                [a, np.full((b - rows, s), fill, a.dtype)], 0)
            packed = Packed(padf(packed.tokens, 0),
                            padf(packed.segment_ids, -1),
                            padf(packed.positions, 0), packed.n_segments)
        labels = np.where(
            (packed.segment_ids >= 0)
            & (np.roll(packed.segment_ids, -1, 1) == packed.segment_ids),
            np.roll(packed.tokens, -1, 1), -1).astype(np.int32)
        return {
            "tokens": packed.tokens.astype(np.int32),
            "labels": labels,
            "segment_ids": packed.segment_ids.astype(np.int32),
            "positions": packed.positions.astype(np.int32),
        }


def shard_batch(batch: Dict[str, np.ndarray], mesh,
                data_spec_fn) -> Dict[str, Sharded]:
    """Place a host batch on the mesh with the plan's data sharding
    (`plan.data_spec`): each leaf cut by ``data_spec_fn(ndim, rows)``,
    its rows in equal contiguous blocks over the data axes where they
    divide (else whole on every shard), each shard's block on its
    device."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = Sharding(mesh, data_spec_fn(t.dim(), t.shape[0])).place(t)
    return out

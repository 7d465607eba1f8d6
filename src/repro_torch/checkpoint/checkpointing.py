"""Async, atomic checkpointing with integrity checks (port of
`repro/checkpoint/checkpointing.py`), in the reference's on-disk layout,
so a checkpoint written by either package restores in the other:

  * `step_%08d/`, one `.npy` per leaf (named by its dict path joined with
    `__`) and a `manifest.json` of each leaf's file, shape, dtype and the
    sha256 of its file's bytes, checked on restore;
  * bf16 leaves are stored as their `uint16` bits, with "bfloat16" in the
    manifest (the reference writes them as 2-byte voids; either restores
    from the manifest's dtype), so numpy needs no bf16 type;
  * atomic: written into `step_%08d.tmp/`, every file fsynced, then
    renamed, so a crash mid-save never leaves a half checkpoint that
    `latest_step` would pick;
  * async: the device-to-host copy happens in `save` (so the caller may
    go on changing its tensors), the file writes on a background thread;
    at most one save is in flight, `wait` joins it;
  * the last `keep` checkpoints are kept, older ones pruned;
  * a train plan's placed leaf (`cluster_builder.Sharded`) is saved
    joined, in the layout above, and `restore(shardings=...)` cuts each
    leaf straight onto a mesh, which may be another than the one that
    saved it (the elastic restart, `runtime/elastic.py`).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cluster_builder import Sharded

BF16 = "bfloat16"


def _flatten(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    return [(prefix, tree)]


def _unflatten(items: Dict[Tuple[str, ...], Any]):
    root: Dict = {}
    for path, v in items.items():
        cur = root
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return root


def _to_host(t) -> Tuple[np.ndarray, str]:
    """(the array to write, the dtype the manifest names); a placed leaf
    joined first."""
    t = t.join("cpu") if isinstance(t, Sharded) else t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()  # keeps 0-d
    if dtype == BF16:
        bits = arr.view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if str(arr.dtype) != dtype:
        arr = arr.view(np.dtype(dtype))
    return torch.from_numpy(arr).to(device)


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Copy `tree`'s tensors to the host now, and write them on the
        background thread."""
        host = {p: _to_host(v) for p, v in _flatten(tree)}
        self.wait()  # at most one outstanding async save
        self._pending = self._pool.submit(self._write, step, host)
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the save in flight; a failed write raises here."""
        if self._pending is not None:
            fut, self._pending = self._pending, None
            fut.result()

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for path, (arr, dtype) in host.items():
            name = "__".join(path) + ".npy"
            buf = io.BytesIO()
            np.save(buf, arr)
            data = buf.getvalue()
            _write_file(os.path.join(tmp, name), data)
            manifest["leaves"]["/".join(path)] = {
                "file": name, "shape": list(arr.shape), "dtype": dtype,
                "sha256": hashlib.sha256(data).hexdigest(),
            }
        _write_file(os.path.join(tmp, "manifest.json"),
                    json.dumps(manifest).encode())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device="cuda",
                template: Any = None,
                shardings: Any = None) -> Tuple[int, Any]:
        """(step, tree) of checkpoint `step` (default: the latest), every
        leaf a tensor on `device`, each file's checksum checked first (a
        mismatch raises IOError).  `template`: a structure to restore into
        (keeps empty sub-dicts, which have no leaves and so no files).
        `shardings`: a tree of `cluster_builder.Sharding` at some of the
        leaves' paths; each of those leaves is placed straight onto its
        mesh (`Sharded`: each shard's block on its device), as the
        reference's `device_put` under NamedShardings."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        placed = dict(_flatten(shardings)) if shardings is not None else {}
        items = {}
        for key, meta in manifest["leaves"].items():
            with open(os.path.join(d, meta["file"]), "rb") as f:
                raw = f.read()
            if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
                raise IOError(f"checksum mismatch for {key} in step {step}")
            arr = np.load(io.BytesIO(raw))
            path = tuple(key.split("/"))
            sh = placed.get(path)
            items[path] = (_to_tensor(arr, meta["dtype"], device)
                           if sh is None else
                           sh.place(_to_tensor(arr, meta["dtype"], "cpu")))
        if template is not None:
            def fill(sub, prefix=()):
                if isinstance(sub, dict):
                    return {k: fill(v, prefix + (str(k),))
                            for k, v in sub.items()}
                return items[prefix]

            return step, fill(template)
        return step, _unflatten(items)

"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in `csrc/` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The target is
Hopper's `sm_90a`.  Libraries go to `_build/` beside this file, named by
a hash of the source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one loads at once.  Nothing is built
when the module is imported: `load(name)` builds at first use,
`build_all()` starts one nvcc per source together and waits for them all.

    PYTHONPATH=src python -c "from repro_torch.kernels import build; build.build_all()"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
# one library per csrc/<name>.cu
SOURCES = ("paged_flash_decode", "paged_flash_decode_q", "flash_decode",
           "flash_attention", "int8_matmul", "i_softmax", "i_layernorm",
           "i_gelu", "row_norm", "gemm")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the integer I-BERT kernels repeat the reference's float32 scale
# arithmetic operation by operation, and row_norm the plain version's f32
# order: no multiply-add contraction
NO_FMAD = ("int8_matmul", "i_softmax", "i_layernorm", "i_gelu", "row_norm")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + (("-fmad=false",) if name in NO_FMAD else ())

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels build only on a machine with the "
                       "CUDA toolkit)")


def lib_path(name: str) -> str:
    """The library's path, named by a hash of its source, the shared
    headers in csrc/ and its flags."""
    digest = hashlib.sha256(" ".join(flags(name)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *flags(name), "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc; returns its compiler report (ptxas -v lines),
    kept beside the library so that a library built earlier still has
    it."""
    if started is None:
        report = lib_path(name) + ".log"
        if not os.path.exists(report):
            return ""
        with open(report) as f:
            return f.read()
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every (or the named) kernel library, one nvcc per source, all
    started together.  Returns {name: compiler report} (the report of the
    build that made the library, also where it was built earlier)."""
    names = list(names or SOURCES)
    with _LOCK:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name) or ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
    return lib

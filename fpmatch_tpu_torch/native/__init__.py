"""Host-native runtime: the batched LAPJV solver and the fixed-box NMS of
`csrc/lapjv.cpp` (the port's own copy of the JAX package's C++ source),
compiled with `g++` at first use and loaded with `ctypes`.

The library goes into the git-ignored `build/fpmatch_tpu_torch/` directory at
the repository root (as the CUDA kernels of `kernels/_build.py` do), keyed by
a hash of the source, of the flags and of what `-march=native` means on the
machine that builds it, so a library built on one CPU is never loaded on
another. Unlike the JAX package's `native`, a build or load that fails
raises: nothing falls back to scipy or numpy. Those plain versions
(`scipy.optimize.linear_sum_assignment`, `poredet.inference.nms_boxes`) are
what the tests hold this library against.

The batch loop of `lapjv_batch` is OpenMP-parallel. The torch wheel ships
its own `libgomp.so.1`; the library links the same soname, so one OpenMP
runtime serves both in a process (the tests run a batched solve after torch's
threaded ops).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels._build import build_dir

SOURCE = Path(__file__).resolve().parent / "csrc" / "lapjv.cpp"
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
             "-std=c++17"]
# the cost of a padding cell: rectangles are padded to squares with it
PAD_COST = 1e6

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _native_target(cxx: str) -> str:
    """The flags `-march=native` expands to on this CPU (from the
    compiler's `-v` output): part of the library's key."""
    try:
        r = subprocess.run([cxx, "-march=native", "-E", "-v", "-x", "c++",
                            os.devnull, "-o", os.devnull],
                           capture_output=True, text=True, timeout=60)
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the native "
                           f"library cannot be built") from e
    lines = [ln for ln in r.stderr.splitlines() if "-march=" in ln]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"{cxx} -march=native failed: {r.stderr[-2000:]}")
    return " ".join(t for t in lines[0].split() if t.startswith(("-m",
                                                                 "--param")))


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_native_target(CXX).encode())
    return build_dir() / f"libfpm_lapjv_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is there already. Raises on failure."""
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.lapjv_batch.argtypes = [
                ctypes.c_int32, ctypes.c_int32,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.lapjv_batch.restype = None
            lib.nms_fixed_boxes.argtypes = [
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int32, ctypes.c_float,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.nms_fixed_boxes.restype = ctypes.c_int32
            _lib = lib
    return _lib


def available() -> bool:
    """True once the library builds and loads. A failed build raises
    everywhere else; here it is False (the reason stays in the log of the
    call that raised: `get_lib()`)."""
    try:
        get_lib()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return False
    return True


# ------------------------------------------------------------------ wrappers

def lap_maximize_batch(scores: np.ndarray, n1: np.ndarray, n2: np.ndarray
                       ) -> np.ndarray:
    """Batched maximum-score assignment over the valid (n1[b], n2[b]) blocks.
    scores: (B, S1, S2) float32 -> 0/1 assignment of the same shape (float32).
    Each block is negated into a cost matrix, padded to max(S1, S2) squared
    with PAD_COST and solved exactly; cells matched into the padding are
    dropped."""
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.ndim != 3:
        raise ValueError(f"scores must be (B, S1, S2), got {scores.shape}")
    B, s1, s2 = scores.shape
    n1 = np.asarray(n1).reshape(-1)
    n2 = np.asarray(n2).reshape(-1)
    if len(n1) != B or len(n2) != B or (n1 < 0).any() or (n2 < 0).any() \
            or (n1 > s1).any() or (n2 > s2).any():
        raise ValueError(f"n1 {n1} / n2 {n2} do not fit scores {scores.shape}")
    lib = get_lib()
    out = np.zeros_like(scores)
    n = int(max(s1, s2))
    costs = np.full((B, n, n), PAD_COST, np.float32)
    for b in range(B):
        a, c = int(n1[b]), int(n2[b])
        costs[b, :a, :c] = -scores[b, :a, :c]
    rowsol = np.zeros((B, n), np.int32)
    lib.lapjv_batch(B, n, costs, rowsol)
    for b in range(B):
        a, c = int(n1[b]), int(n2[b])
        for i in range(a):
            j = rowsol[b, i]
            if j < c:
                out[b, i, j] = 1.0
    return out


def nms_fixed_boxes(coords: np.ndarray, scores: np.ndarray, box_size: int,
                    iou_threshold: float) -> np.ndarray:
    """Greedy NMS over equal square boxes anchored at `coords` (m, 2) (y, x);
    returns the kept indices, score-descending."""
    m = len(coords)
    if m == 0:
        return np.zeros((0,), np.int64)
    scores = np.asarray(scores)
    c32 = np.ascontiguousarray(coords, np.int32)
    s32 = np.ascontiguousarray(scores, np.float32)
    if c32.shape != (m, 2) or s32.shape != (m,):
        raise ValueError(f"coords {c32.shape} / scores {s32.shape}: "
                         f"expected ({m}, 2) / ({m},)")
    keep = np.zeros((m,), np.int32)
    get_lib().nms_fixed_boxes(m, c32, s32, int(box_size),
                              float(iou_threshold), keep)
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-scores[idx], kind="stable")]

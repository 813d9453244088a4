"""Build and load the hand-written CUDA kernels.

Every `*.cu` under `kernels/csrc/` has a plain C interface and becomes one
shared library, compiled with `nvcc` for sm_90a at first use and loaded with
`ctypes` (no PyTorch headers: the build takes seconds). Every source includes
the shared header `csrc/common.cuh`. Libraries go into a git-ignored `build/`
directory at the repository root, keyed by a hash of the source, of every
`csrc/*.cuh` header and of the flags, so an unchanged tree is compiled once per
checkout and an edited header never leaves a stale library behind. A build or
a load that fails raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "fpmatch_tpu_torch"


def find_nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            cand.append(os.path.join(home, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources() -> List[str]:
    """Names (without suffix) of all kernel sources."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None, verbose: bool = False
          ) -> Dict[str, Path]:
    """Compile the named sources (default: all), one `nvcc` per source, all
    started together. Returns {name: library path}. Raises on failure."""
    names = list(names) if names is not None else sources()
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if todo:
        nvcc = find_nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = []
        for n in todo:
            tmp = out[n].with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for n, tmp, cmd, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{log}")
                continue
            if verbose and log:
                print(log, flush=True)
            os.replace(tmp, out[n])
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.fpm_cuda_error_string.restype = ctypes.c_char_p
        lib.fpm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fpm_inoculate.restype = ctypes.c_int
        lib.fpm_inoculate.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.fpm_cuda_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code}: "
                           f"{msg.decode() if msg else '?'}")

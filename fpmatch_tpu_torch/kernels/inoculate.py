"""First-launch warm-up of every kernel library: CUDA kernel.

Counterpart of the JAX package's `kernels/assoc_pallas.py::inoculate`, which
compiles and runs one trivial Pallas kernel (`x + 1` on an (8, 128) f32
tile, result discarded) so that a process's first kernel compile comes before
anything else. No code of the JAX package calls it.

On the card the compile is nvcc's, ahead of time, but each library under
`csrc/` links its own CUDA runtime statically, so each one still initialises
its runtime and loads its module on its first launch. `inoculate()` builds and
loads every source, then launches `fpm_inoculate` (`y = x + 1`, from
`csrc/common.cuh`) once in each library, checks every result against
`inoculate_plain` bit for bit and returns the seconds each first launch took.
A library that fails to build, load or launch raises; none is skipped. On a
CPU device it runs the plain version only.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from . import _build

# the TPU kernel this one replaces (file:line of the Pallas function)
REPLACES = "fpmatch_tpu/kernels/assoc_pallas.py:51"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/common.cuh"

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES: Dict[str, int] = {"inoculate": 0}

SHAPE = (8, 128)


def inoculate_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: x + 1."""
    return x + 1.0


def launch(lib, x: torch.Tensor) -> torch.Tensor:
    """One launch of `fpm_inoculate` from the loaded library `lib` on the f32
    CUDA tensor `x`; returns y = x + 1 (not synchronised)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError("inoculate launches on a float32 CUDA tensor")
    x = x.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fpm_inoculate(x.data_ptr(), y.data_ptr(), x.numel(),
                                 stream)
    _build.check(lib, code, "inoculate launch")
    LAUNCHES["inoculate"] += 1
    return y


def inoculate(device="cuda") -> Dict[str, float]:
    """Build and load every kernel library and launch `x + 1` once in each.

    :return: {library name: seconds of its launch, synchronised}; on a CPU
        device {"plain": seconds of the plain version}
    """
    device = torch.device(device)
    x = torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.float32
                     ).reshape(SHAPE) / 7.0
    if device.type == "cpu":
        t = time.perf_counter()
        y = inoculate_plain(x)
        secs = {"plain": time.perf_counter() - t}
        if not torch.equal(y, x + 1.0):
            raise RuntimeError("inoculate: plain version is not x + 1")
        return secs
    if device.type != "cuda":
        raise RuntimeError(f"inoculate: unsupported device {device}")
    x = x.to(device)
    want = inoculate_plain(x)
    names = _build.sources()
    _build.build(names)                 # one nvcc per source, in parallel
    secs = {}
    for name in names:
        lib = _build.load(name)
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        y = launch(lib, x)
        torch.cuda.synchronize(device)
        secs[name] = time.perf_counter() - t
        if not torch.equal(y, want):
            raise RuntimeError(f"inoculate: library {name} returned a value "
                               f"other than x + 1")
    return secs

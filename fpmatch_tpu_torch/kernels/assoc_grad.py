"""The edge / diagonal gradient of the association matvec ("K6"): CUDA
kernel.

For the forward of `kernels.assoc_bucket` / `ops.assoc.assoc_matvec`,

    Y[b,a,j,c] = Kp[b,a,j] X[b,a,j,c]
               + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
                     Ke[b,e1,e2] X[b, in1(e1), in2(e2), c]

with (out, in) = (src, dst), or (dst, src) for `transpose=True`, this
module computes, for an upstream gradient dY,

    dKe[b,e1,e2] = sum_c dY[b, out1(e1), out2(e2), c] X[b, in1(e1), in2(e2), c]
    dKp[b,i,j]   = sum_c dY[b,i,j,c] X[b,i,j,c]

(`dX` is the forward kernel again with `transpose` flipped). No Pallas
kernel stands behind it: on the training path the JAX package leaves the
matvec to XLA (`fpmatch_tpu/ops/assoc.py:46`) and JAX AD derives this from
it; `REPLACES` names that function.

bf16 X (the `--bf16` training path): dY stays f32 on the way in, and the
rounding is JAX AD's of the bf16 forward terms bf16(bf16(Ke) X):

    dKe[b,e1,e2] = bf16( sum_c bf16( bf16(dY[...]) X[...] ) )   (stored f32)
    dKp[b,i,j]   = sum_c dY[b,i,j,c] f32(X[b,i,j,c])

JAX sums dKe's products in bf16; here the sum is f32 and is rounded once,
so the two differ by JAX's bf16 accumulation order only (within a bf16 ulp
or so of the result).

Padded slots: with `e1_mask` / `e2_mask` (True = real edge) a masked-out slot
gets dKe = 0. Without masks a padded slot aliases node 0 and gets the value
of an edge (0, 0), as JAX AD gives it; either way the model's `* emask` on
Ke (`InnerProductAffinity`) stops it.

`assoc_edge_grad` launches the CUDA kernel (`csrc/assoc_grad.cu`: a block per
(sample, graph-1 edge) stages the two rows it needs in shared memory, a
thread per graph-2 edge; dKp a thread per cell) for CUDA tensors — or raises
— and uses the plain PyTorch version `assoc_edge_grad_plain` only for
tensors that lie on the CPU. X is float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

REPLACES = "fpmatch_tpu/ops/assoc.py:46"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_grad.cu"

# launches of the CUDA kernel, counted where the wrapper launches it (one
# launch computes dKe and dKp)
LAUNCHES: Dict[str, int] = {"assoc_grad": 0}

# shared memory a block may stage (two N2 x chunk f32 rows); above 48 KB the
# launcher raises the kernel's dynamic shared-memory limit
STAGE_BYTES = 96 * 1024
CHUNK_E1 = 256             # graph-1 edges per step of the plain version


def _roles(src1, dst1, src2, dst2, transpose: bool):
    """(out1, in1, out2, in2): Y[out] += Ke X[in]."""
    if transpose:
        return dst1, src1, dst2, src2
    return src1, dst1, src2, dst2


def _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask):
    if X.dim() != 4 or tuple(dY.shape) != tuple(X.shape):
        raise ValueError(f"dY and X must be one (B, N1, N2, C) shape, got "
                         f"{tuple(dY.shape)} and {tuple(X.shape)}")
    if dY.dtype != torch.float32 or X.dtype not in (torch.float32,
                                                    torch.bfloat16):
        raise TypeError(f"assoc_edge_grad takes float32 dY and float32 or "
                        f"bfloat16 X, got {dY.dtype} and {X.dtype}")
    B = X.shape[0]
    for name, t in (("src1", src1), ("dst1", dst1), ("src2", src2),
                    ("dst2", dst2), ("e1_mask", e1_mask),
                    ("e2_mask", e2_mask)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name} must be (B, E), got {tuple(t.shape)}")
        if t.device != X.device or dY.device != X.device:
            raise ValueError("all tensors must lie on one device")
        if not name.endswith("mask") and (t.dtype.is_floating_point
                                          or t.dtype == torch.bool):
            raise TypeError(f"{name} must be an integer tensor")
    if src1.shape != dst1.shape or src2.shape != dst2.shape:
        raise ValueError("src / dst of a graph must have one shape")
    for m, s in ((e1_mask, src1), (e2_mask, src2)):
        if m is not None and m.shape != s.shape:
            raise ValueError("an edge mask must have its edge list's shape")


def assoc_edge_grad_plain(dY, X, src1, dst1, src2, dst2,
                          transpose: bool = False, e1_mask=None, e2_mask=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: gather the dY rows out1 / X rows in1, then
    the columns out2 / in2, multiply and sum over C (graph-1 edges
    CHUNK_E1 at a time, so the live (B, chunk, E2, C) products stay
    bounded); with bf16 X the roundings of the module docstring. Returns
    (dKe (B, E1, E2), dKp (B, N1, N2)), float32."""
    _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask)
    out1, in1, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    B, _, _, C = X.shape
    bf16 = X.dtype == torch.bfloat16
    Xf = X.float()
    dYr = dY.bfloat16().float() if bf16 else dY
    bi = torch.arange(B, device=X.device)[:, None, None]
    o2 = out2.long()[:, None, :]
    i2 = in2.long()[:, None, :]
    parts = []
    for lo in range(0, out1.shape[1], CHUNK_E1):
        o1 = out1[:, lo:lo + CHUNK_E1].long()[:, :, None]
        i1 = in1[:, lo:lo + CHUNK_E1].long()[:, :, None]
        prod = dYr[bi, o1, o2] * Xf[bi, i1, i2]
        if bf16:
            prod = prod.bfloat16().float()
        parts.append(prod.sum(-1))
    dKe = torch.cat(parts, dim=1) if parts else torch.zeros(
        (B, 0, out2.shape[1]), device=X.device)
    if bf16:
        dKe = dKe.bfloat16().float()
    if e1_mask is not None:
        dKe = torch.where(e1_mask.bool()[:, :, None], dKe, 0.0)
    if e2_mask is not None:
        dKe = torch.where(e2_mask.bool()[:, None, :], dKe, 0.0)
    return dKe, (dY * Xf).sum(-1)


def _launch(dY, X, out1, in1, out2, in2, e1_mask, e2_mask):
    B, N1, N2, C = X.shape
    E1, E2 = out1.shape[1], out2.shape[1]
    dY, X = dY.contiguous(), X.contiguous()
    idx = [t.int().contiguous() for t in (out1, in1, out2, in2)]
    masks = [None if m is None else m.to(torch.uint8).contiguous()
             for m in (e1_mask, e2_mask)]
    cc = max(1, min(C, STAGE_BYTES // max(8 * N2, 1)))
    smem = 8 * N2 * cc
    dKe = torch.empty((B, E1, E2), dtype=torch.float32, device=X.device)
    dKp = torch.empty((B, N1, N2), dtype=torch.float32, device=X.device)
    lib = _build.load("assoc_grad")
    fn = (lib.fpm_assoc_grad_bf16 if X.dtype == torch.bfloat16
          else lib.fpm_assoc_grad_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(dY.data_ptr(), X.data_ptr(),
                  *(t.data_ptr() for t in idx),
                  *(None if m is None else m.data_ptr() for m in masks),
                  dKe.data_ptr(), dKp.data_ptr(), B, N1, N2, C, E1, E2, cc,
                  smem, stream)
    _build.check(lib, code, "assoc_grad launch")
    LAUNCHES["assoc_grad"] += 1
    return dKe, dKp


def assoc_edge_grad(dY: torch.Tensor, X: torch.Tensor, src1, dst1, src2,
                    dst2, transpose: bool = False,
                    e1_mask: Optional[torch.Tensor] = None,
                    e2_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dKe, dKp) of the association matvec for the upstream gradient `dY`.

    :param dY: (B, N1, N2, C) float32
    :param X: the forward's input, same shape, float32 or bfloat16
    :param src1, dst1: (B, E1) integer edge endpoints; src2, dst2: (B, E2)
    :param transpose: the forward's orientation
    :param e1_mask, e2_mask: optional (B, E) validity; masked slots get 0
    :return: dKe (B, E1, E2) and dKp (B, N1, N2), float32

    CUDA tensors go through the CUDA kernel (a failed build or launch
    raises); CPU tensors through the plain version.
    """
    _check(dY, X, src1, dst1, src2, dst2, e1_mask, e2_mask)
    if X.device.type == "cuda":
        return _launch(dY, X, *_roles(src1, dst1, src2, dst2, transpose),
                       e1_mask, e2_mask)
    if X.device.type == "cpu":
        return assoc_edge_grad_plain(dY, X, src1, dst1, src2, dst2,
                                     transpose, e1_mask, e2_mask)
    raise RuntimeError(f"assoc_edge_grad: unsupported device {X.device}")

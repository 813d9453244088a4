"""UNIV-scale association matvec: padded-degree (ELL) form, CUDA kernel.

Counterpart of the JAX package's `kernels/assoc_univ_v3.py` (the Pallas
`_kernel` reached through `assoc_matvec_univ_v3_raw`): the same function and
contract, re-thought for a GPU.

    Y[i1,i2,c] = Kp[i1,i2] X[i1,i2,c]
               + sum_{a<S1} sum_{b<S2} Ke[e1(i1,a), e2(i2,b)]
                                       X[in1(i1,a), in2(i2,b), c]

Each node's incident edges are padded to fixed slot counts (S1 / S2 = the
maximum degree of graph 1 / graph 2), so both segment sums of the
gather/segment-sum form become dense reductions over static slot axes. The
orientation (K or K^T) is fixed by the plan. Because the card has indexed
loads, the plan needs no spatial sort, no degree sort and no spill lists —
every edge has a slot — and X stays in the model's (N1, N2, C) layout, so the
TPU pipeline's prep / unprep steps have no counterpart. Ke is read through
the slot tables inside the kernel (no materialised KeP).

Per pair:

    plan = plan_univ_v3(n1, n2, src1, dst1, src2, dst2, transpose=True)
    Y = assoc_matvec_univ_v3(X, Kp, Ke, plan)            # once per GNN layer

`assoc_matvec_univ_v3` launches the CUDA kernel (csrc/assoc_univ_v3.cu) for
CUDA tensors — or raises — and uses `assoc_matvec_univ_v3_plain`, the plain
PyTorch version of the same function over the same plan, only for tensors
that lie on the CPU. The kernel is memory-bound (X + Kp + Ke + Y read or
written once is the least traffic); see the note at the top of the source.
Inference only: like the TPU kernel it has no backward.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build

# the TPU kernel this one replaces (file:line of the Pallas kernel body)
REPLACES = "fpmatch_tpu/kernels/assoc_univ_v3.py:320"
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_univ_v3.cu"

# launches of the CUDA kernel, counted where the wrapper launches it
LAUNCHES: Dict[str, int] = {"assoc_univ_v3": 0}

class UnivPlanV3(NamedTuple):
    """Host-built slot tables (numpy) of one pair; `.to(device)` makes the
    tensors the kernel and the plain version read."""
    n1: int
    n2: int
    s1: int                # graph-1 slots per output row (max degree, >= 1)
    s2: int                # graph-2 slots per output column
    transpose: bool
    in1_slot: np.ndarray   # (n1, s1) int32 gathered row per slot (pad: 0)
    e1_slot: np.ndarray    # (n1, s1) int32 graph-1 edge id (pad: -1)
    in2_slot: np.ndarray   # (n2, s2) int32 gathered column per slot (pad: 0)
    e2_slot: np.ndarray    # (n2, s2) int32 graph-2 edge id (pad: -1)

    def to(self, device) -> "UnivPlanDev":
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return UnivPlanDev(self.n1, self.n2, self.s1, self.s2, self.transpose,
                           t(self.in1_slot), t(self.e1_slot),
                           t(self.in2_slot), t(self.e2_slot))


class UnivPlanDev(NamedTuple):
    """A plan whose slot tables are int32 tensors on one device."""
    n1: int
    n2: int
    s1: int
    s2: int
    transpose: bool
    in1_slot: torch.Tensor
    e1_slot: torch.Tensor
    in2_slot: torch.Tensor
    e2_slot: torch.Tensor

    def to(self, device) -> "UnivPlanDev":
        return UnivPlanDev(*self[:5], *(t.to(device) for t in self[5:]))


def _slots(out_nodes: np.ndarray, in_nodes: np.ndarray, n: int):
    """Pad each node's incident edges (those whose `out` endpoint it is) to
    max-degree slots: (in_slot, e_slot), both (n, s)."""
    deg = np.bincount(out_nodes, minlength=n)
    s = max(int(deg.max()) if len(deg) else 0, 1)   # >= 1: zero-edge side
    in_slot = np.zeros((n, s), np.int32)
    e_slot = np.full((n, s), -1, np.int32)
    order = np.argsort(out_nodes, kind="stable")
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=starts[1:])
    # position of each (sorted) edge within its node's run
    pos = np.arange(len(order)) - starts[out_nodes[order]]
    in_slot[out_nodes[order], pos] = in_nodes[order]
    e_slot[out_nodes[order], pos] = order
    return in_slot, e_slot


def plan_univ_v3(n1: int, n2: int, src1, dst1, src2, dst2,
                 transpose: bool = True) -> UnivPlanV3:
    """Build the padded-degree plan of one pair (numpy, host).

    :param n1, n2: node counts of the (padded) bucket; the edge lists hold
        the REAL edges only (no padded slots)
    :param transpose: plan K^T x (the model's orientation): output rows are
        dst and gathered rows src, per `ops.assoc.assoc_matvec`'s role swap
    """
    src1 = np.asarray(src1, np.int64)
    dst1 = np.asarray(dst1, np.int64)
    src2 = np.asarray(src2, np.int64)
    dst2 = np.asarray(dst2, np.int64)
    if transpose:
        out1, in1, out2, in2 = dst1, src1, dst2, src2
    else:
        out1, in1, out2, in2 = src1, dst1, src2, dst2
    in1_slot, e1_slot = _slots(out1, in1, n1)
    in2_slot, e2_slot = _slots(out2, in2, n2)
    return UnivPlanV3(n1=n1, n2=n2, s1=in1_slot.shape[1],
                      s2=in2_slot.shape[1], transpose=transpose,
                      in1_slot=in1_slot, e1_slot=e1_slot,
                      in2_slot=in2_slot, e2_slot=e2_slot)


def _check(X, Kp, Ke, plan):
    if X.dim() != 3 or tuple(X.shape[:2]) != (plan.n1, plan.n2):
        raise ValueError(f"X must be ({plan.n1}, {plan.n2}, C), got "
                         f"{tuple(X.shape)}")
    if tuple(Kp.shape) != (plan.n1, plan.n2) or Ke.dim() != 2:
        raise ValueError("Kp must be (n1, n2) and Ke (E1, E2)")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if Kp.dtype != torch.float32 or Ke.dtype != torch.float32:
        raise TypeError("Kp and Ke must be float32")
    if not isinstance(plan, UnivPlanDev):
        raise TypeError("plan must be a UnivPlanDev (UnivPlanV3.to(device))")
    for t in (Kp, Ke, *plan[5:]):
        if t.device != X.device:
            raise ValueError("X, Kp, Ke and the plan must lie on one device")


def assoc_matvec_univ_v3_plain(X: torch.Tensor, Kp: torch.Tensor,
                               Ke: torch.Tensor, plan: UnivPlanDev
                               ) -> torch.Tensor:
    """The plain PyTorch version: the same slot tables, `index_select` +
    broadcast multiply + sums over the slot axes, f32 accumulation. Used by
    the CPU tests and as the yardstick the kernel is held against."""
    _check(X, Kp, Ke, plan)
    n1, n2, C = X.shape
    E1, E2 = Ke.shape
    Kz = torch.nn.functional.pad(Ke, (0, 1, 0, 1))           # zero row/col
    e1 = torch.where(plan.e1_slot < 0, E1, plan.e1_slot).long()   # (n1, S1)
    e2 = torch.where(plan.e2_slot < 0, E2, plan.e2_slot).long()   # (n2, S2)
    in2 = plan.in2_slot.long().reshape(-1)
    Xf = X.float()
    Y = Kp[..., None] * Xf
    for a in range(plan.s1):
        rows = Xf.index_select(0, plan.in1_slot[:, a].long())    # (n1, n2, C)
        g = rows.index_select(1, in2).reshape(n1, n2, plan.s2, C)
        ke = Kz.index_select(0, e1[:, a]).index_select(1, e2.reshape(-1))
        Y = Y + (g * ke.reshape(n1, n2, plan.s2, 1)).sum(dim=2)
    return Y


def _launch(X, Kp, Ke, plan) -> torch.Tensor:
    lib = _build.load("assoc_univ_v3")
    fn = (lib.fpm_assoc_univ_v3_bf16 if X.dtype == torch.bfloat16
          else lib.fpm_assoc_univ_v3_f32)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_longlong, ctypes.c_void_p]
    X, Kp = X.contiguous(), Kp.contiguous()
    if Ke.stride(1) != 1 and Ke.numel():
        Ke = Ke.contiguous()
    tabs = [t.contiguous() for t in plan[5:]]
    if any(t.dtype != torch.int32 for t in tabs):
        raise TypeError("plan slot tables must be int32")
    n1, n2, C = X.shape
    Y = torch.empty((n1, n2, C), dtype=torch.float32, device=X.device)
    ke_stride = Ke.stride(0) if Ke.numel() else 0
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), Kp.data_ptr(), Ke.data_ptr(),
                  tabs[0].data_ptr(), tabs[1].data_ptr(), tabs[2].data_ptr(),
                  tabs[3].data_ptr(), Y.data_ptr(), n1, n2, C, plan.s1,
                  plan.s2, ke_stride, stream)
    _build.check(lib, code, "assoc_univ_v3 launch")
    LAUNCHES["assoc_univ_v3"] += 1
    return Y


def assoc_matvec_univ_v3(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                         plan: UnivPlanDev) -> torch.Tensor:
    """K vec(X) (orientation fixed by the plan) for one pair.

    :param X: (n1, n2, C) float32 or bfloat16 (bf16: gathered and multiplied
        from the bf16 values; Ke, the accumulator and the result stay f32)
    :param Kp: (n1, n2) f32; Ke: (E1, E2) f32 — E1 / E2 may be padded wider
        than the plan's real edge lists; only the plan's rows / columns are
        read
    :return: (n1, n2, C) float32

    CUDA tensors go through the CUDA kernel (a failed build or launch
    raises); CPU tensors through the plain version.
    """
    _check(X, Kp, Ke, plan)
    if X.device.type == "cuda":
        return _launch(X, Kp, Ke, plan)
    if X.device.type == "cpu":
        return assoc_matvec_univ_v3_plain(X, Kp, Ke, plan)
    raise RuntimeError(f"assoc_matvec_univ_v3: unsupported device {X.device}")

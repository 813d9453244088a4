"""Batched association matvec at bucket scale and at any size: CUDA kernels.

Counterpart of the JAX package's `kernels/assoc_pallas.py` — the Pallas
`_kernel` reached through `assoc_matvec_pallas` (everything resident, `Kp*X`
fused) and `_kernel_large` reached through `assoc_matvec_pallas_large`
(blocked, `Kp*X` added after the edge sum). The same function and contract as
`ops.assoc.assoc_matvec`, batch-native:

    Y[b,a,j,c] = Kp[b,a,j] X[b,a,j,c]
               + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
                     Ke[b,e1,e2] X[b, in1(e1), in2(e2), c]

with (out, in) = (src, dst), or (dst, src) for `transpose=True` (K^T, the
model's orientation). Edge lists are (B, E) integers; padded edge slots alias
node 0 and MUST carry Ke == 0. X is float32 or bfloat16. With bf16 X each
term rounds as the JAX op's bf16 multiply (`W * Ke.astype(W.dtype)`): Ke is
rounded to bf16 and so is the product, bf16(bf16(Ke) X); the sums, `Kp X`
and the result are f32, as with f32 X.

Re-thought for a GPU: each graph's edges are grouped once by their scatter
endpoint (`plan_bucket`: a stable sort + counts + cumsum on the device, CSR
per sample; index bookkeeping, remembered for the last set of edge lists so
the three GNN layers of one forward share it), and every output cell gathers
and reduces its own terms — no one-hot matmuls, no transposed layout, no
atomics, so the order of the sum is fixed and two runs give the same bits.
Duplicate edges and self-loops are ordinary members of a run.

Padded slots: with `e1_mask` / `e2_mask` (True = real edge; what the model
passes) the masked-out slots are in no run and are never read. Without masks
they sit in node 0's run and are multiplied by their Ke == 0 like any other
edge. The two differ only when X[b, 0, 0] is not finite: 0 * inf = nan then
reaches Y[b, 0, 0] without masks (as in `ops.assoc.assoc_matvec`) and does
not with them; Y[b, 0, 0] = Kp X[b, 0, 0] + ... is not finite either way.

`assoc_matvec_bucket` / `assoc_matvec_large` launch the CUDA kernels
(csrc/assoc_bucket.cu) for CUDA tensors — or raise — and use the plain
PyTorch versions (`..._plain`: the same grouping, padded to slots, dense sums
over the slot axes) only for tensors that lie on the CPU. Both kernels are
memory-bound; see the note at the top of the source. Inference only: like
the TPU kernels they have no backward of their own.

The bucket kernel (K2) gives a warp a tile of one output row and gathers X
from L2; two lanes share a cell's channels (`_cells.bucket_tiling`), and
with bf16 X it multiplies two channels at a time with one packed bf16
multiply. The any-size kernel (K3) gives a block one output row and a slice
of up to 32 channels: it streams each of the row's (Ke row, X row) pairs
through shared memory (cp.async, two buffers), a thread per column holds
the slice's channels in registers and reads each index and Ke value once
per term, and the block adds `Kp * X` and writes the row contiguously — one
launch after the (remembered) plan, no torch op after it. Where a row does
not fit (`large_geometry`, the one place of that rule) the same kernel reads
Ke and X from global memory instead. What is left between K3 and its bound:
at C = 1 each block's serial walk over its graph-1 edges, a Ke row from
DRAM per step; at C > 1 the X gathers from shared memory at unrelated banks
and each X row crossing L2 once per graph-1 edge.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import torch

from ..utils.profiling import span
from . import _build
from ._cells import bucket_tiling

# the TPU kernels these replace (file:line of the Pallas kernel bodies)
REPLACES = {"assoc_bucket": "fpmatch_tpu/kernels/assoc_pallas.py:79",
            "assoc_large": "fpmatch_tpu/kernels/assoc_pallas.py:177"}
SOURCE = "fpmatch_tpu_torch/kernels/csrc/assoc_bucket.cu"

# launches of each CUDA kernel, counted where its wrapper launches it
LAUNCHES: Dict[str, int] = {"assoc_bucket": 0, "assoc_large": 0}

DEFAULT_BLOCK_C = 32       # channels per grid slice of the any-size kernel

# the any-size kernel's shape rule (`large_geometry`): a thread holds at most
# MAX_SLICE channels in registers, a block has at most LARGE_TILE threads,
# and the two staged (Ke row, X row) buffers (or the epilogue's row) may take
# LARGE_STAGE_BYTES of shared memory, so that two blocks share an SM
MAX_SLICE = 32
LARGE_TILE = 640
LARGE_STAGE_BYTES = 112 * 1024


class BucketPlan(NamedTuple):
    """Both graphs' edges grouped by scatter endpoint, per sample (int32
    tensors on the device of the edge lists)."""
    n1: int
    n2: int
    order1: torch.Tensor   # (B, E1) graph-1 edge ids sorted by out1
    ins1: torch.Tensor     # (B, E1) in1 of those edges
    offs1: torch.Tensor    # (B, n1 + 1) run offsets: node a owns
    #                        order1[b, offs1[b, a]:offs1[b, a + 1]]
    order2: torch.Tensor
    ins2: torch.Tensor
    offs2: torch.Tensor


def _csr(out, inn, n: int, mask):
    B = out.shape[0]
    key = out.long()
    if mask is not None:
        key = torch.where(mask.bool(), key, n)     # masked-out: past the end
    order = torch.sort(key, dim=1, stable=True).indices
    counts = torch.zeros((B, n + 1), dtype=torch.int64, device=out.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offs = torch.zeros((B, n + 1), dtype=torch.int32, device=out.device)
    offs[:, 1:] = torch.cumsum(counts[:, :n], dim=1)
    return (order.int().contiguous(),
            inn.long().gather(1, order).int().contiguous(), offs)


# the plans of the last two keys: key -> (the tensors it was made from,
# plan); the GNN layers of one forward share one, and a backward uses both
# orientations of the same edge lists (dX flips `transpose`, K6 reads the
# forward's), so each is made once per step
_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
_MEMO_SIZE = 2


def _version(t: torch.Tensor) -> int:
    # tensors made under torch.inference_mode() keep no version counter: an
    # in-place write to one of those between two calls is not seen
    return 0 if t.is_inference() else t._version


def plan_bucket(src1, dst1, src2, dst2, n1: int, n2: int,
                transpose: bool = False, e1_mask=None, e2_mask=None
                ) -> BucketPlan:
    """Group both edge lists by scatter endpoint (device ops, no host sync).

    The plans of the last two keys are kept together with the tensors they
    were made from (so their memory cannot be reused while they are kept),
    and one is returned again when the same tensors — same storage, shape,
    strides and version counter — and orientation come back: the GNN layers
    of one forward share one plan, and their backward (dX in the other
    orientation, K6 in the forward's) one more."""
    with span("op.assoc_plan"):
        given = (src1, dst1, src2, dst2, e1_mask, e2_mask)
        key = (n1, n2, transpose) + tuple(
            None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(),
                                    _version(t), t.dtype, t.device)
            for t in given)
        if key in _memo:
            _memo.move_to_end(key)
            return _memo[key][1]
        out1, in1, out2, in2 = ((dst1, src1, dst2, src2) if transpose
                                else (src1, dst1, src2, dst2))
        plan = BucketPlan(n1, n2, *_csr(out1, in1, n1, e1_mask),
                          *_csr(out2, in2, n2, e2_mask))
        _memo[key] = (given, plan)
        if len(_memo) > _MEMO_SIZE:
            _memo.popitem(last=False)
        return plan


def _check(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask):
    if X.dim() != 4:
        raise ValueError(f"X must be (B, N1, N2, C), got {tuple(X.shape)}")
    B, n1, n2, _ = X.shape
    if tuple(Kp.shape) != (B, n1, n2):
        raise ValueError(f"Kp must be {(B, n1, n2)}, got {tuple(Kp.shape)}")
    if Ke.dim() != 3 or Ke.shape[0] != B:
        raise ValueError(f"Ke must be (B, E1, E2), got {tuple(Ke.shape)}")
    e1, e2 = Ke.shape[1], Ke.shape[2]
    for name, t, e in (("src1", src1, e1), ("dst1", dst1, e1),
                       ("src2", src2, e2), ("dst2", dst2, e2),
                       ("e1_mask", e1_mask, e1), ("e2_mask", e2_mask, e2)):
        if t is None:
            continue
        if tuple(t.shape) != (B, e):
            raise ValueError(f"{name} must be {(B, e)}, got {tuple(t.shape)}")
        if t.device != X.device:
            raise ValueError("all tensors must lie on one device")
        if not name.endswith("mask") and (t.dtype.is_floating_point
                                          or t.dtype == torch.bool):
            raise TypeError(f"{name} must be an integer tensor")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if Kp.dtype != torch.float32 or Ke.dtype != torch.float32:
        raise TypeError("Kp and Ke must be float32")
    if Kp.device != X.device or Ke.device != X.device:
        raise ValueError("all tensors must lie on one device")


class LargeGeom(NamedTuple):
    """Launch geometry of the any-size kernel, passed to it as ints in this
    order (`LargeGeom` in csrc/assoc_bucket.cu)."""
    B: int
    N1: int
    N2: int
    C: int
    E1: int
    E2: int
    cb: int          # channels per grid slice
    chunks: int      # grid slices, ceil(C / cb)
    nc: int          # channels a thread holds: the kernel's instantiation
    threads: int     # per block: columns per tile
    staged: int      # 1: (Ke row, X row) pairs through shared memory
    xs: int          # elements per staged node
    nw: int          # 32-bit words per staged node when padded (0: as it is)
    ts: int          # floats per node of the epilogue's row
    ke_bytes: int    # one staged Ke row, 16-byte padded
    x_bytes: int     # one staged X row, 16-byte padded
    smem: int        # dynamic shared memory of a block

    @property
    def path(self) -> str:
        return "staged" if self.staged else "global"


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def large_geometry(B: int, N1: int, N2: int, C: int, E1: int, E2: int,
                   itemsize: int, block_c: int = DEFAULT_BLOCK_C,
                   x_aligned: bool = True) -> LargeGeom:
    """The any-size kernel's shape rule, in one place.

    A grid slice holds min(block_c, 32, C) channels (a thread keeps them in
    registers). A block of up to LARGE_TILE threads owns one output row.
    `staged`: the row fits one tile and two (Ke row, X row) buffers — the
    whole X row, every channel — as well as the epilogue's row fit in
    LARGE_STAGE_BYTES; the block then streams them through shared memory.
    Otherwise (`global`) the threads read Ke and X from global memory / L2,
    tile the columns and write from registers: every size runs. A staged
    node whose values are an even number of 32-bit words (and X 4-byte
    aligned) gets one word of padding, so a warp's gathers spread over the
    banks."""
    if block_c < 1:
        raise ValueError("block_c must be >= 1")
    cb = min(block_c, MAX_SLICE, max(C, 1))
    chunks = -(-C // cb)
    nc = 1 if cb == 1 else -(-cb // 4) * 4
    threads = min(-(-N2 // 32) * 32, LARGE_TILE) if N2 > 0 else 32
    node = C * itemsize
    nw = node // 4 if node % 8 == 0 and x_aligned else 0
    xs = (node + 4) // itemsize if nw else C
    ts = cb + 1 if cb % 2 == 0 else cb
    ke_bytes = _pad16(4 * E2)
    x_bytes = _pad16(N2 * xs * itemsize)
    smem = max(2 * (ke_bytes + x_bytes), 4 * N2 * ts)
    staged = N2 <= LARGE_TILE and smem <= LARGE_STAGE_BYTES
    if not staged:
        ke_bytes = x_bytes = smem = nw = 0
        xs = C
    return LargeGeom(B, N1, N2, C, E1, E2, cb, chunks, nc, threads,
                     int(staged), xs, nw, ts, ke_bytes, x_bytes, smem)


# ------------------------------------------------------------ plain versions
def _slots(order, ins, offs, n_edges: int):
    """A CSR grouping padded to max-degree slots: (in_slot, e_slot), both
    (B, n, S) int64; pad slots gather node 0 and edge id `n_edges`, the zero
    row / column appended to Ke."""
    B, n = offs.shape[0], offs.shape[1] - 1
    deg = (offs[:, 1:] - offs[:, :-1]).long()
    S = max(int(deg.max()) if deg.numel() else 0, 1)
    ar = torch.arange(S, device=offs.device)
    valid = ar < deg[..., None]                              # (B, n, S)
    if n_edges == 0:
        z = torch.zeros((B, n, S), dtype=torch.int64, device=offs.device)
        return z, z
    pos = torch.where(valid, offs[:, :-1, None].long() + ar, 0).reshape(B, -1)
    in_slot = ins.long().gather(1, pos).reshape(B, n, S)
    e_slot = order.long().gather(1, pos).reshape(B, n, S)
    return (torch.where(valid, in_slot, 0),
            torch.where(valid, e_slot, n_edges))


def _edge_terms_plain(X, Ke, plan: BucketPlan) -> torch.Tensor:
    B, n1, n2, C = X.shape
    E1, E2 = Ke.shape[1], Ke.shape[2]
    in1_slot, e1_slot = _slots(plan.order1, plan.ins1, plan.offs1, E1)
    in2_slot, e2_slot = _slots(plan.order2, plan.ins2, plan.offs2, E2)
    S1, S2 = in1_slot.shape[2], in2_slot.shape[2]
    Kz = torch.nn.functional.pad(Ke, (0, 1, 0, 1))       # zero row / column
    Xf = X.float()
    rounded = X.dtype == torch.bfloat16
    bi = torch.arange(B, device=X.device)
    cols = in2_slot.reshape(B, 1, n2 * S2, 1).expand(B, n1, n2 * S2, C)
    e2 = e2_slot.reshape(B, 1, n2 * S2)
    Y = torch.zeros((B, n1, n2, C), dtype=torch.float32, device=X.device)
    for s in range(S1):
        rows = Xf[bi[:, None], in1_slot[:, :, s]]            # (B, n1, n2, C)
        g = rows.gather(2, cols).reshape(B, n1, n2, S2, C)
        ke = Kz[bi[:, None, None], e1_slot[:, :, s, None], e2]
        ke = ke.reshape(B, n1, n2, S2, 1)
        if rounded:     # bf16(bf16(Ke) X), as the JAX op's bf16 multiply
            term = (g * ke.bfloat16().float()).bfloat16().float()
        else:
            term = g * ke
        # pad slots are in no run: the kernel never reads them, so they add
        # an exact zero here even where the value they gather is not finite
        real = (e1_slot[:, :, s, None] < E1) & (e2 < E2)
        term = torch.where(real.reshape(B, n1, n2, S2, 1), term, 0.0)
        Y = Y + term.sum(dim=3)
    return Y


def assoc_matvec_bucket_plain(X, Kp, Ke, src1, dst1, src2, dst2,
                              transpose: bool = False, e1_mask=None,
                              e2_mask=None) -> torch.Tensor:
    """The plain PyTorch version of `assoc_matvec_bucket`: the same grouping
    by scatter endpoint, padded to max-degree slots, `index` / `gather` +
    broadcast multiply + dense sums over the slot axes, f32 accumulation.
    Used by the CPU tests and as the yardstick the kernel is held against."""
    _check(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
    plan = plan_bucket(src1, dst1, src2, dst2, X.shape[1], X.shape[2],
                       transpose, e1_mask, e2_mask)
    return Kp[..., None] * X.float() + _edge_terms_plain(X, Ke, plan)


def assoc_matvec_large_plain(X, Kp, Ke, src1, dst1, src2, dst2,
                             transpose: bool = False, e1_mask=None,
                             e2_mask=None, block_c: int = DEFAULT_BLOCK_C
                             ) -> torch.Tensor:
    """The plain PyTorch version of `assoc_matvec_large`: the edge terms one
    channel slice of `block_c` at a time (the result does not depend on it),
    the Kp term added after them in f32."""
    _check(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
    if block_c < 1:
        raise ValueError("block_c must be >= 1")
    plan = plan_bucket(src1, dst1, src2, dst2, X.shape[1], X.shape[2],
                       transpose, e1_mask, e2_mask)
    Y = torch.cat([_edge_terms_plain(X[..., c:c + block_c], Ke, plan)
                   for c in range(0, X.shape[3], block_c)], dim=-1)
    return Y + Kp[..., None] * X.float()


# ------------------------------------------------------------------ launches
def _fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + \
        [ctypes.c_void_p]
    return fn


def _launch_bucket(X, Kp, Ke, plan: BucketPlan) -> torch.Tensor:
    B, n1, n2, C = X.shape
    X, Kp, Ke = X.contiguous(), Kp.contiguous(), Ke.contiguous()
    nc, vec = bucket_tiling(X)
    lib = _build.load("assoc_bucket")
    fn = _fn(lib, "fpm_assoc_bucket_bf16" if X.dtype == torch.bfloat16
             else "fpm_assoc_bucket_f32", 10, 8)
    Y = torch.empty((B, n1, n2, C), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), Kp.data_ptr(), Ke.data_ptr(),
                  *(t.data_ptr() for t in plan[2:]), Y.data_ptr(), B, n1, n2,
                  C, Ke.shape[1], Ke.shape[2], nc, int(vec), stream)
    _build.check(lib, code, "assoc_bucket launch")
    LAUNCHES["assoc_bucket"] += 1
    return Y


def _launch_large(X, Kp, Ke, plan: BucketPlan, block_c: int
                  ) -> torch.Tensor:
    B, n1, n2, C = X.shape
    X, Kp, Ke = X.contiguous(), Kp.contiguous(), Ke.contiguous()
    g = large_geometry(B, n1, n2, C, Ke.shape[1], Ke.shape[2],
                       X.element_size(), block_c, X.data_ptr() % 4 == 0)
    lib = _build.load("assoc_bucket")
    fn = _fn(lib, "fpm_assoc_large_bf16" if X.dtype == torch.bfloat16
             else "fpm_assoc_large_f32", 11, 1)      # the 11th: the geometry
    geom = (ctypes.c_int * len(g))(*g)
    Y = torch.empty((B, n1, n2, C), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(X.data_ptr(), Kp.data_ptr(), Ke.data_ptr(),
                  *(t.data_ptr() for t in plan[2:]), Y.data_ptr(),
                  ctypes.addressof(geom), len(g), stream)
    _build.check(lib, code, "assoc_large launch")
    LAUNCHES["assoc_large"] += 1
    return Y


def assoc_matvec_bucket(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                        src1, dst1, src2, dst2, transpose: bool = False,
                        e1_mask: Optional[torch.Tensor] = None,
                        e2_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K vec(X) (or K^T vec(X)) for a batch of bucket-scale pairs, `Kp * X`
    fused.

    :param X: (B, N1, N2, C) float32 or bfloat16
    :param Kp: (B, N1, N2) f32; Ke: (B, E1, E2) f32, zero on padded slots
    :param src1, dst1: (B, E1) integer edge endpoints; src2, dst2: (B, E2)
    :param e1_mask, e2_mask: optional (B, E) validity of the edge slots;
        masked-out slots are skipped (see the module docstring)
    :return: (B, N1, N2, C) float32

    CUDA tensors go through the CUDA kernel (a failed build or launch
    raises); CPU tensors through the plain version.
    """
    _check(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
    if X.device.type == "cuda":
        plan = plan_bucket(src1, dst1, src2, dst2, X.shape[1], X.shape[2],
                           transpose, e1_mask, e2_mask)
        return _launch_bucket(X, Kp, Ke, plan)
    if X.device.type == "cpu":
        return assoc_matvec_bucket_plain(X, Kp, Ke, src1, dst1, src2, dst2,
                                         transpose, e1_mask, e2_mask)
    raise RuntimeError(f"assoc_matvec_bucket: unsupported device {X.device}")


def assoc_matvec_large(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                       src1, dst1, src2, dst2, transpose: bool = False,
                       e1_mask: Optional[torch.Tensor] = None,
                       e2_mask: Optional[torch.Tensor] = None,
                       block_c: int = DEFAULT_BLOCK_C) -> torch.Tensor:
    """The same product for pairs of any size: nothing has to fit in shared
    memory (`large_geometry` picks the kernel's path), a grid slice holds
    min(`block_c`, 32) channels (C need not be a multiple), and `Kp * X` is
    added inside the kernel, after the edge sum. Arguments and result as
    `assoc_matvec_bucket`."""
    _check(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask)
    if block_c < 1:
        raise ValueError("block_c must be >= 1")
    if X.device.type == "cuda":
        plan = plan_bucket(src1, dst1, src2, dst2, X.shape[1], X.shape[2],
                           transpose, e1_mask, e2_mask)
        return _launch_large(X, Kp, Ke, plan, block_c)
    if X.device.type == "cpu":
        return assoc_matvec_large_plain(X, Kp, Ke, src1, dst1, src2, dst2,
                                        transpose, e1_mask, e2_mask, block_c)
    raise RuntimeError(f"assoc_matvec_large: unsupported device {X.device}")

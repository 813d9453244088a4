"""Factorized association-graph sparse ops in plain PyTorch, batch-native.

The FGM factorization of the association affinity matrix is

    K = diag(vec(Kp)) + (G2 (x) G1) diag(vec(Ke)) (H2 (x) H1)^T

and K never needs to be materialized. For X in R^{n1 x n2 x C},

    (K vec X)[i1,i2] = Kp[i1,i2] X[i1,i2]
                     + sum_{e1,e2} 1[src1(e1)=i1] 1[src2(e2)=i2] Ke[e1,e2]
                       X[dst1(e1), dst2(e2)]

i.e. gather X by (dst1, dst2), scale by Ke, then two separable segment sums
(over e2 into src2, over e1 into src1): `index_select` + `index_add_`. The
transposed product K^T vec X (what the model uses) swaps the src/dst roles.

Every function takes a leading batch axis B and flattens it into the gather
and scatter indices; padded edge slots alias node 0 and MUST carry Ke == 0.

`assoc_matvec_auto` is where the device decides: CPU tensors take the plain
ops of this module, CUDA tensors the hand-written kernels of
`kernels.assoc_bucket` (or raise; they never give way to the plain ops). It
is differentiable: its backward runs the same dispatch with the roles swapped
(dX) and `kernels.assoc_grad` (dKe, dKp), on the same device.
"""
from __future__ import annotations

import torch

from ..kernels.assoc_bucket import assoc_matvec_bucket, assoc_matvec_large
from ..kernels.assoc_grad import assoc_edge_grad
from ..utils.profiling import span


def _batch_offsets(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, E) per-sample indices -> (B*E,) indices into a (B*n, ...) array."""
    B = idx.shape[0]
    off = torch.arange(B, device=idx.device)[:, None] * n
    return (idx.long() + off).reshape(-1)


def _matvec_edges(X, Ke, out1, in1, out2, in2):
    """sum over the given edge lists, without the Kp term: (B, N1, N2, C)
    float32. X (B, N1, N2, C); Ke (B, E1, E2); out*/in* (B, E*)."""
    B, n1, n2, C = X.shape
    e1, e2 = Ke.shape[1], Ke.shape[2]
    # gather rows then columns: W[b, e1, e2, c] = X[b, in1[e1], in2[e2], c]
    rows = X.reshape(B * n1, n2, C).index_select(0, _batch_offsets(in1, n1))
    rows = rows.reshape(B, e1, n2, C).transpose(1, 2).reshape(B * n2, e1, C)
    W = rows.index_select(0, _batch_offsets(in2, n2))      # (B*E2, E1, C)
    W = W * Ke.transpose(1, 2).reshape(B * e2, e1, 1).to(W.dtype)
    # scatter-add, separable: over e2 into out2, then over e1 into out1
    T = torch.zeros((B * n2, e1, C), dtype=torch.float32, device=X.device)
    T.index_add_(0, _batch_offsets(out2, n2), W.float())
    T = T.reshape(B, n2, e1, C).transpose(1, 2).reshape(B * e1, n2, C)
    Y = torch.zeros((B * n1, n2, C), dtype=torch.float32, device=X.device)
    Y.index_add_(0, _batch_offsets(out1, n1), T)
    return Y.reshape(B, n1, n2, C)


def _roles(src1, dst1, src2, dst2, transpose):
    """(out1, in1, out2, in2): Y[out] += Ke X[in]."""
    if transpose:
        return dst1, src1, dst2, src2
    return src1, dst1, src2, dst2


def assoc_matvec(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                 src1, dst1, src2, dst2,
                 transpose: bool = False) -> torch.Tensor:
    """K vec(X) (or K^T vec(X)) without materializing K.

    :param X:  (B, N1, N2, C) association node features (f32 or bf16: the
               gathers and the Ke multiply run in X's dtype, both segment
               sums accumulate f32)
    :param Kp: (B, N1, N2) node affinities; zero-padded
    :param Ke: (B, E1, E2) edge affinities; zero on padded edge slots
    :param src1, dst1: (B, E1) graph-1 edge endpoints; src2, dst2: (B, E2)
    :return: (B, N1, N2, C) float32
    """
    out1, in1, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    Y = _matvec_edges(X, Ke, out1, in1, out2, in2)
    return Y + Kp[..., None] * X.float()


def assoc_matvec_chunked(X, Kp, Ke, src1, dst1, src2, dst2,
                         transpose: bool = False,
                         chunk: int = 256) -> torch.Tensor:
    """The same product with the E1 axis processed in fixed-size chunks, so
    the live intermediate is (chunk, E2, C) per sample instead of the whole
    (E1, E2, C) tensor."""
    out1, in1, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    Y = Kp[..., None] * X.float()
    for lo in range(0, Ke.shape[1], chunk):
        hi = lo + chunk
        Y = Y + _matvec_edges(X, Ke[:, lo:hi], out1[:, lo:hi], in1[:, lo:hi],
                              out2, in2)
    return Y


def assoc_matvec_fused(X: torch.Tensor, Kp: torch.Tensor, Ke: torch.Tensor,
                       src1, dst1, src2, dst2,
                       transpose: bool = False) -> torch.Tensor:
    """The same product as one contraction over the graph-2 edges with
    one-hot gather / scatter matrices (the JAX package's
    `assoc_matvec_fused`, its large-problem path on the TPU), then the
    segment sum over graph 1 (`index_add_`). Plain torch at any size: K3
    (`kernels.assoc_bucket.assoc_matvec_large`) computes the same function
    by hand on the card. X's dtype throughout, as the JAX op."""
    B, n1, n2, C = X.shape
    out1, in1, out2, in2 = _roles(src1, dst1, src2, dst2, transpose)
    e1 = Ke.shape[1]
    rows = X.reshape(B * n1, n2, C).index_select(
        0, _batch_offsets(in1, n1)).reshape(B, e1, n2, C)
    G2 = torch.nn.functional.one_hot(in2.long(), n2).to(X.dtype)
    S2 = torch.nn.functional.one_hot(out2.long(), n2).to(X.dtype)
    t = torch.einsum("benc,bfn,bef,bfm->bemc", rows, G2, Ke.to(X.dtype), S2)
    Y = torch.zeros((B * n1, n2, C), dtype=X.dtype, device=X.device)
    Y.index_add_(0, _batch_offsets(out1, n1), t.reshape(B * e1, n2, C))
    return Y.reshape(B, n1, n2, C) + Kp[..., None] * X


# association-edge count (per sample) from which the chunked form is used
CHUNKED_NNZ_THRESHOLD = 1_000_000
CHUNK_E1 = 256


def _matvec_dispatch(X, Kp, Ke, src1, dst1, src2, dst2, transpose,
                     e1_mask, e2_mask):
    """The forward of `assoc_matvec_auto` on the tensors as they are (no
    autograd): the CUDA kernels for CUDA tensors, the plain ops for CPU
    ones. Returns (Y, the kernel's name or None)."""
    with span("op.assoc"):
        large = Ke.shape[1] * Ke.shape[2] >= CHUNKED_NNZ_THRESHOLD
        if X.device.type == "cuda":
            kernel = assoc_matvec_large if large else assoc_matvec_bucket
            return kernel(X, Kp, Ke, src1, dst1, src2, dst2,
                          transpose=transpose, e1_mask=e1_mask,
                          e2_mask=e2_mask), \
                ("assoc_large" if large else "assoc_bucket")
        if large:
            return assoc_matvec_chunked(X, Kp, Ke, src1, dst1, src2, dst2,
                                        transpose=transpose,
                                        chunk=CHUNK_E1), None
        return assoc_matvec(X, Kp, Ke, src1, dst1, src2, dst2,
                            transpose=transpose), None


# launches of the forward kernels made by `_AssocMatvec.backward` (dX), per
# kernel; the wrappers count every launch of theirs, these are the part of
# those counts that the backward made
BACKWARD_LAUNCHES = {"assoc_bucket": 0, "assoc_large": 0}


class _AssocMatvec(torch.autograd.Function):
    """Y = K(^T) vec X with its gradient. Forward: `_matvec_dispatch`.
    Backward, for dY:

      dX  = K(^T)^T vec dY: the same dispatch with `transpose` flipped (on a
            CUDA tensor the same K2 / K3 kernel, `Kp * dY` fused);
      dKe, dKp: `kernels.assoc_grad.assoc_edge_grad` (K6 on a CUDA tensor,
            its plain version on a CPU one); dKe is 0 on masked slots.

    With bf16 X, JAX AD of the bf16 forward (`fpmatch_tpu/ops/assoc.py:46`)
    casts dY to bf16, multiplies each gathered bf16(dY) by bf16(Ke) with a
    bf16 rounding, scatter-adds the terms into X's shape in bf16 and adds
    bf16(Kp dY). Here the dispatch with `transpose` flipped runs on
    X' = bf16(dY) with Kp = 0, which forms each term exactly so (it is the
    forward's own rounding), sums the terms in f32; `Kp * dY` is added in f32
    and the sum is rounded to bf16 once. So dX differs from JAX's by JAX's
    bf16 accumulation only, and is the closer of the two to the exact sum.
    dKe and dKp follow `assoc_edge_grad`'s bf16 rules. The edge lists and
    masks get no gradient."""

    @staticmethod
    def forward(ctx, X, Kp, Ke, src1, dst1, src2, dst2, transpose, e1_mask,
                e2_mask):
        ctx.transpose = transpose
        ctx.save_for_backward(X, Kp, Ke, src1, dst1, src2, dst2, e1_mask,
                              e2_mask)
        return _matvec_dispatch(X, Kp, Ke, src1, dst1, src2, dst2, transpose,
                                e1_mask, e2_mask)[0]

    @staticmethod
    def backward(ctx, dY):
        X, Kp, Ke, src1, dst1, src2, dst2, e1_mask, e2_mask = \
            ctx.saved_tensors
        dY = dY.contiguous().float()
        dX = dKp = dKe = None
        if ctx.needs_input_grad[0]:
            bf16 = X.dtype == torch.bfloat16
            dX, kernel = _matvec_dispatch(
                dY.bfloat16() if bf16 else dY,
                torch.zeros_like(Kp) if bf16 else Kp, Ke, src1, dst1, src2,
                dst2, not ctx.transpose, e1_mask, e2_mask)
            if bf16:
                dX = (dX + Kp[..., None] * dY).bfloat16()
            if kernel is not None:
                BACKWARD_LAUNCHES[kernel] += 1
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dKe, dKp = assoc_edge_grad(dY, X, src1, dst1, src2, dst2,
                                       ctx.transpose, e1_mask, e2_mask)
            dKe = dKe if ctx.needs_input_grad[2] else None
            dKp = dKp if ctx.needs_input_grad[1] else None
        return dX, dKp, dKe, None, None, None, None, None, None, None


def assoc_matvec_auto(X, Kp, Ke, src1, dst1, src2, dst2,
                      transpose: bool = False, e1_mask=None, e2_mask=None):
    """Static-shape dispatch between the one-shot form (bucket scale) and
    the bounded-memory form (from CHUNKED_NNZ_THRESHOLD association edges per
    sample up). On a CUDA tensor the two forms are the CUDA kernels
    `assoc_matvec_bucket` and `assoc_matvec_large`, which skip the edge
    slots that `e1_mask` / `e2_mask` (B, E) mark as padding; on a CPU tensor
    they are the plain ops above, for which padded slots are inert through
    their Ke == 0. Both are one `torch.autograd.Function` (`_AssocMatvec`),
    whose backward runs on the same device: on a CUDA tensor the kernels
    again (dX) and `kernels.assoc_grad` (dKe, dKp). X is float32 or
    bfloat16, with or without a gradient."""
    wants_grad = torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in (X, Kp, Ke))
    if not wants_grad:
        return _matvec_dispatch(X, Kp, Ke, src1, dst1, src2, dst2, transpose,
                                e1_mask, e2_mask)[0]
    return _AssocMatvec.apply(X, Kp, Ke, src1, dst1, src2, dst2, transpose,
                              e1_mask, e2_mask)


def assoc_degree(Kp_present: torch.Tensor, e1_mask, e2_mask,
                 src1, dst1, src2, dst2, n1: int, n2: int,
                 transpose: bool = False) -> torch.Tensor:
    """Number of stored entries per row of K (or K^T), the normalizer of the
    mean aggregation: deg(i1,i2) = indeg1(i1) * indeg2(i2) + 1 on the valid
    block.

    :param Kp_present: (B, N1, N2) 1.0 where a diagonal entry exists
    :param e1_mask, e2_mask: (B, E) validity of padded edge slots
    :return: (B, N1, N2) float32
    """
    tgt1 = src1 if transpose else dst1
    tgt2 = src2 if transpose else dst2
    B = Kp_present.shape[0]
    dev = Kp_present.device
    deg1 = torch.zeros((B * n1,), dtype=torch.float32, device=dev)
    deg1.index_add_(0, _batch_offsets(tgt1, n1), e1_mask.float().reshape(-1))
    deg2 = torch.zeros((B * n2,), dtype=torch.float32, device=dev)
    deg2.index_add_(0, _batch_offsets(tgt2, n2), e2_mask.float().reshape(-1))
    return (deg1.reshape(B, n1, 1) * deg2.reshape(B, 1, n2)
            + Kp_present.float())


def assoc_aggregate_mean(X, Kp, Ke, src1, dst1, src2, dst2,
                         Kp_present, e1_mask, e2_mask,
                         transpose: bool = True):
    """Mean-aggregated sparse propagation: row-wise (K^T x) / rownnz(K^T)."""
    n1, n2 = X.shape[1], X.shape[2]
    y = assoc_matvec_auto(X, Kp, Ke, src1, dst1, src2, dst2,
                          transpose=transpose, e1_mask=e1_mask,
                          e2_mask=e2_mask)
    deg = assoc_degree(Kp_present, e1_mask, e2_mask, src1, dst1, src2, dst2,
                       n1, n2, transpose=transpose)
    return y / torch.clamp(deg, min=1.0)[..., None]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T) integer indices -> (B, T, n) float32 one-hot rows."""
    return torch.nn.functional.one_hot(idx.long(), n).float()


def assoc_tri_matvec(X: torch.Tensor, Kt: torch.Tensor, tri1, tri2
                     ) -> torch.Tensor:
    """Third-order (triangle hyperedge) association propagation: for each
    pair of triangles (t1, t2) and each corner rotation r, the corner match
    (a1, a2) receives the mean of its partner-corners' features,

        Y[a1, a2] += Kt[t1, t2] (X[b1, b2] + X[c1, c2]) / 2.

    The rotation's W = (X[b1][:, b2] + X[c1][:, c2]) / 2 is gathered and
    summed in X's dtype, then multiplied by Kt in f32; its two segment sums
    (over t2 onto a2, then over t1 onto a1) are products with one-hot
    matrices in f32, whose order of summation is fixed (no atomics on a CUDA
    tensor). Padded triangle slots alias node 0 and MUST carry Kt == 0; they
    are multiplied like every other slot.

    :param X: (B, N1, N2, C) association node features (f32 or bf16)
    :param Kt: (B, T1, T2) triangle-pair affinities (f32)
    :param tri1: (B, T1, 3) graph-1 triangle corners; tri2: (B, T2, 3)
    :return: (B, N1, N2, C) float32
    """
    B, n1, n2, C = X.shape
    t1, t2 = tri1.shape[1], tri2.shape[1]
    Y = None
    for r in range(3):
        a1, b1, c1 = (tri1[..., (r + k) % 3] for k in range(3))
        a2, b2, c2 = (tri2[..., (r + k) % 3] for k in range(3))

        def pairs(i1, i2):
            # X[b][i1[b]][:, i2[b]]: (B, T1, T2, C)
            rows = X.reshape(B * n1, n2, C).index_select(
                0, _batch_offsets(i1, n1)).reshape(B, t1, n2, C)
            rows = rows.transpose(1, 2).reshape(B * n2, t1, C)
            return rows.index_select(0, _batch_offsets(i2, n2)).reshape(
                B, t2, t1, C).transpose(1, 2)

        W = (0.5 * (pairs(b1, b2) + pairs(c1, c2))).float() * Kt[..., None]
        T = torch.einsum("btsc,bsm->btmc", W, _one_hot(a2, n2))
        S = torch.einsum("btn,btmc->bnmc", _one_hot(a1, n1), T)
        Y = S if Y is None else Y + S
    return Y


def assoc_tri_degree(t1_mask, t2_mask, tri1, tri2, n1: int, n2: int
                     ) -> torch.Tensor:
    """Hyperedge count per association node, the normalizer of the mean
    over `assoc_tri_matvec`: sum_r tdeg1_r(i1) tdeg2_r(i2), where tdeg_r
    counts the valid triangles whose r-th corner is the node.

    :param t1_mask, t2_mask: (B, T) validity of the triangle slots
    :param tri1, tri2: (B, T, 3) triangle corners
    :return: (B, N1, N2) float32
    """
    deg = None
    for r in range(3):
        d1 = torch.einsum("bt,btn->bn", t1_mask.float(),
                          _one_hot(tri1[..., r], n1))
        d2 = torch.einsum("bt,btn->bn", t2_mask.float(),
                          _one_hot(tri2[..., r], n2))
        term = d1[:, :, None] * d2[:, None, :]
        deg = term if deg is None else deg + term
    return deg


def assoc_dense(Kp: torch.Tensor, Ke: torch.Tensor, src1, dst1, src2, dst2,
                n1: int, n2: int) -> torch.Tensor:
    """K materialized densely (test / reference path only; the reference's
    `construct_aff_mat`), per sample: (B, n1*n2, n1*n2) with the column-major
    vec indexing (i2*n1 + i1) and association edges flattened e1-outer,
    e2-inner; duplicate entries add up (`index_put_(accumulate=True)`).
    Kp (B, n1, n2), Ke (B, E1, E2), edge lists (B, E)."""
    B = Ke.shape[0]
    m = n1 * n2
    row = (src2[:, None, :].long() * n1 + src1[:, :, None].long())
    col = (dst2[:, None, :].long() * n1 + dst1[:, :, None].long())
    b = torch.arange(B, device=Ke.device)[:, None, None].expand_as(row)
    K = torch.zeros((B, m, m), dtype=Kp.dtype, device=Kp.device)
    K.index_put_((b.reshape(-1), row.reshape(-1), col.reshape(-1)),
                 Ke.reshape(-1).to(Kp.dtype), accumulate=True)
    return K + torch.diag_embed(Kp.transpose(1, 2).reshape(B, m))


def edge_incidence_gather(F: torch.Tensor, src, dst) -> torch.Tensor:
    """[F G ; F H] edge features: the node features at both endpoints,
    concatenated. F (B, N, D), src / dst (B, E) -> (B, E, 2D)."""
    D = F.shape[-1]
    at = lambda i: torch.gather(F, 1, i.long()[..., None].expand(-1, -1, D))
    return torch.cat([at(src), at(dst)], dim=-1)

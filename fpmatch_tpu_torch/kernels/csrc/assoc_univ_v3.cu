// UNIV-scale association matvec for Hopper (sm_90a), padded-degree (ELL) form.
//
// Replaces the TPU Pallas kernel fpmatch_tpu/kernels/assoc_univ_v3.py::_kernel
// (reached through assoc_matvec_univ_v3_raw). Same function, same contract:
//
//   Y[i1,i2,c] = Kp[i1,i2] * X[i1,i2,c]
//              + sum_{a<S1} sum_{b<S2} Ke[e1(i1,a), e2(i2,b)]
//                                      * X[in1(i1,a), in2(i2,b), c]
//
// Each node's incident edges are padded to S1 / S2 slots (the maximum degree
// of its graph, so every edge has a slot and nothing spills); a pad slot has
// edge id -1 and is skipped. The orientation (K or K^T) is fixed by the
// host-built slot tables. X is f32 or bf16, Ke / Kp / the accumulator / Y
// are f32.
//
// What the TPU kernel needed and this one does not: the banded lane gathers
// over a spatially sorted graph 2, the degree-sorted row groups, the MXU
// channel-expansion matmul, the per-row DMA double buffering, the sorted /
// transposed X layout (prep / unprep) and the spill postlude. The card has
// indexed loads, so X stays in the model's (N1, N2, C) layout and Ke is read
// through the slot tables directly (no materialised KeP).
//
// Bound: memory bytes. Each Ke element belongs to exactly one output cell,
// so the least traffic is X + Kp + Ke + Y once; the arithmetic is 2 flops per
// (association edge, channel), far below the f32 rate that those bytes allow.
// Design: one block per output row i1 and a tile of the flattened (i2, c)
// axis; one thread per (i2, c). The C threads of one i2 read the same Ke
// element (a broadcast) and C consecutive X values (coalesced). The row's S1
// slots are staged in shared memory, all at once up to kMaxS1 and kMaxS1 at
// a time beyond (a second instantiation, so rows of ordinary degree run the
// single-stage code), so no degree is too large; the sum runs over the
// chunks in order, then over the S2 slots, then over the chunk's slots — a
// fixed order, so two launches give the same bits.
// No shared-memory tiling of X or Ke, no cp.async / TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS1 = 64;   // slots of one output row staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The row's terms over `na` staged graph-1 slots, added to `acc` in a fixed
// order: S2 slots outer, the staged slots inner.
template <typename XT>
__device__ __forceinline__ float slot_terms(
    const XT* __restrict__ X, const float* __restrict__ Ke,
    const int* __restrict__ in2_slot, const int* __restrict__ e2_slot,
    const int* sh_in1, const int* sh_e1, int na, int i2, int c, int C,
    int S2, long long row_elems, long long ke_stride, float acc) {
  for (int b = 0; b < S2; ++b) {
    const int e2 = e2_slot[(long long)i2 * S2 + b];
    if (e2 < 0) continue;
    const long long col_off =
        (long long)in2_slot[(long long)i2 * S2 + b] * C + c;
    for (int a = 0; a < na; ++a) {
      const int e1 = sh_e1[a];
      if (e1 < 0) continue;
      const float ke = Ke[(long long)e1 * ke_stride + e2];
      const float x = to_f32(X[(long long)sh_in1[a] * row_elems + col_off]);
      acc = fmaf(ke, x, acc);
    }
  }
  return acc;
}

// kChunked: the row has more than kMaxS1 slots and they pass through shared
// memory kMaxS1 at a time; otherwise all are staged at once.
template <typename XT, bool kChunked>
__global__ void assoc_univ_v3_kernel(
    const XT* __restrict__ X,          // (N1, N2, C)
    const float* __restrict__ Kp,      // (N1, N2)
    const float* __restrict__ Ke,      // (E1, E2), row stride ke_stride
    const int* __restrict__ in1_slot,  // (N1, S1) gathered row per slot
    const int* __restrict__ e1_slot,   // (N1, S1) graph-1 edge id, -1 = pad
    const int* __restrict__ in2_slot,  // (N2, S2) gathered column per slot
    const int* __restrict__ e2_slot,   // (N2, S2) graph-2 edge id, -1 = pad
    float* __restrict__ Y,             // (N1, N2, C)
    int N2, int C, int S1, int S2, long long ke_stride) {
  __shared__ int sh_in1[kMaxS1];
  __shared__ int sh_e1[kMaxS1];
  const int i1 = blockIdx.y;
  const int flat = blockIdx.x * blockDim.x + threadIdx.x;   // i2 * C + c
  const bool live = flat < N2 * C;
  const int i2 = live ? flat / C : 0;
  const int c = live ? flat - i2 * C : 0;
  const long long row_elems = (long long)N2 * C;

  float acc = 0.0f;
  for (int a0 = 0; a0 < S1; a0 += kMaxS1) {
    const int na = kChunked ? min(kMaxS1, S1 - a0) : S1;
    if (kChunked && a0 > 0) __syncthreads();   // previous chunk consumed
    for (int a = threadIdx.x; a < na; a += blockDim.x) {
      sh_in1[a] = in1_slot[(long long)i1 * S1 + a0 + a];
      sh_e1[a] = e1_slot[(long long)i1 * S1 + a0 + a];
    }
    __syncthreads();
    if (!kChunked) {
      if (!live) return;
      acc = slot_terms(X, Ke, in2_slot, e2_slot, sh_in1, sh_e1, na, i2, c,
                       C, S2, row_elems, ke_stride, acc);
      break;
    }
    if (live)
      acc = slot_terms(X, Ke, in2_slot, e2_slot, sh_in1, sh_e1, na, i2, c,
                       C, S2, row_elems, ke_stride, acc);
  }
  if (!live) return;
  const long long o = (long long)i1 * row_elems + flat;
  Y[o] = fmaf(Kp[(long long)i1 * N2 + i2], to_f32(X[o]), acc);
}

template <typename XT>
int launch(const void* X, const void* Kp, const void* Ke, const void* in1_slot,
           const void* e1_slot, const void* in2_slot, const void* e2_slot,
           void* Y, int N1, int N2, int C, int S1, int S2,
           long long ke_stride, void* stream) {
  if (N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  dim3 grid((unsigned)(((long long)N2 * C + kThreads - 1) / kThreads),
            (unsigned)N1);
  auto kern = S1 > kMaxS1 ? assoc_univ_v3_kernel<XT, true>
                          : assoc_univ_v3_kernel<XT, false>;
  kern<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const XT*)X, (const float*)Kp, (const float*)Ke, (const int*)in1_slot,
      (const int*)e1_slot, (const int*)in2_slot, (const int*)e2_slot,
      (float*)Y, N2, C, S1, S2, ke_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of the
// launch (0 = success); nothing synchronises and nothing is allocated here.
extern "C" int fpm_assoc_univ_v3_f32(
    const void* X, const void* Kp, const void* Ke, const void* in1_slot,
    const void* e1_slot, const void* in2_slot, const void* e2_slot, void* Y,
    int N1, int N2, int C, int S1, int S2, long long ke_stride, void* stream) {
  return launch<float>(X, Kp, Ke, in1_slot, e1_slot, in2_slot, e2_slot, Y, N1,
                       N2, C, S1, S2, ke_stride, stream);
}

extern "C" int fpm_assoc_univ_v3_bf16(
    const void* X, const void* Kp, const void* Ke, const void* in1_slot,
    const void* e1_slot, const void* in2_slot, const void* e2_slot, void* Y,
    int N1, int N2, int C, int S1, int S2, long long ke_stride, void* stream) {
  return launch<__nv_bfloat16>(X, Kp, Ke, in1_slot, e1_slot, in2_slot, e2_slot,
                               Y, N1, N2, C, S1, S2, ke_stride, stream);
}


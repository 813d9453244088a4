// Batched association matvec for Hopper (sm_90a): the bucket-scale kernel
// (a warp per row tile, channels in registers, Kp term fused) and the blocked
// kernel for pairs of any size (gathers straight from global memory / L2, no
// Kp).
//
// They replace the TPU Pallas kernels of fpmatch_tpu/kernels/assoc_pallas.py:
// `_kernel` (reached through assoc_matvec_pallas) and `_kernel_large`
// (reached through assoc_matvec_pallas_large). Same function, same contract:
//
//   Y[b,a,j,c] = Kp[b,a,j] * X[b,a,j,c]                      (bucket only)
//              + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
//                    Ke[b,e1,e2] * X[b, in1(e1), in2(e2), c]
//
// X is f32 or bf16, Ke / Kp / the accumulator / Y are f32. With bf16 X each
// term rounds as the JAX op's bf16 multiply: bf16(bf16(Ke) * X), then the f32
// sum; with f32 X it is an f32 fma.
//
// What the TPU kernels needed and these do not: the one-hot gather / scatter
// matmuls on the MXU, the channel-major transpose of X, the (E, 1) index
// columns, the XG2 scratch and the sequential E1 grid that carries an
// accumulator from step to step. The card has indexed loads, so each graph's
// edges are grouped once per batch by their scatter endpoint (CSR: `order`
// holds the edge ids sorted by `out`, `ins` the matching gather endpoints,
// `offs` the (N + 1) run offsets per sample) and every output cell gathers
// and reduces its own terms. No atomics: the order of the sum is fixed, so
// two runs give the same bits. Edge slots that the caller masked out are not
// in any run; without a mask the padded slots sit in node 0's run and
// multiply by their Ke == 0.
//
// Bound: memory bytes (X + Kp + Ke + Y once; 2 flops per association edge and
// channel is far below what those bytes allow). Design of the bucket kernel:
// a warp owns (sample b, output row a, a tile of columns, a chunk of up to 32
// channels). It stages the row's run of (e1, in1) in shared memory, 32
// entries at a time (so any degree runs, with no block barrier). Its lanes
// own cells: L = ceil(min(C, 32) / NC) lanes per cell, NC channels of the
// cell in registers each, gathered straight from global memory / L2 (a batch
// of X is a few MB) as 16-byte vectors where C and the alignment allow
// (otherwise one thread holds all of the cell's channels: NC = 32, or 1 at
// C = 1; a lane per channel was slower at C = 17). Each
// Ke value is read once per term for all channels. `Kp * X` is added last
// and the cell is written once. Shared memory does not depend on N2 or C, so
// every width runs. The blocked kernel tiles the channels as well (grid: row
// a, sample b, channel chunk) and stages only the row's edge ids, so nothing
// has to fit anywhere. No cp.async / TMA / tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using fpm_common::load_channels;
using fpm_common::round_bf16;
using fpm_common::store_channels;
using fpm_common::to_f32;

constexpr int kMaxThreads = 256;
constexpr int kStage = 128;   // edge ids of one output row staged at a time
constexpr int kWarps = 4;     // warps per block of the bucket kernel

// One edge term, acc + ke x. f32 X: one fma. bf16 X: as the JAX op's
// `W * Ke.astype(W.dtype)`, Ke rounded to bf16 (`ke_for`, once per term) and
// the product rounded to bf16 before the f32 sum.
template <typename XT>
__device__ __forceinline__ float ke_for(float ke) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value) return round_bf16(ke);
  return ke;
}
template <typename XT>
__device__ __forceinline__ float add_term(float ke, float x, float acc) {
  if constexpr (std::is_same<XT, __nv_bfloat16>::value)
    return acc + round_bf16(ke * x);
  return fmaf(ke, x, acc);
}

// ---------------------------------------------------------------- bucket scale
struct BucketGeom {
  int B, N1, N2, C, E1, E2;
  int L, CH, cpw, tiles, chunks;   // lanes per cell, channels per chunk,
                                   // cells per warp, column tiles, chunks
};

template <typename XT, int NC, bool kVec>
__global__ void __launch_bounds__(kWarps * 32) assoc_bucket_kernel(
    const XT* __restrict__ X,        // (B, N1, N2, C)
    const float* __restrict__ Kp,    // (B, N1, N2)
    const float* __restrict__ Ke,    // (B, E1, E2)
    const int* __restrict__ order1,  // (B, E1) graph-1 edge ids sorted by out1
    const int* __restrict__ ins1,    // (B, E1) in1 of those edges
    const int* __restrict__ offs1,   // (B, N1 + 1) run offsets
    const int* __restrict__ order2,  // (B, E2)
    const int* __restrict__ ins2,    // (B, E2)
    const int* __restrict__ offs2,   // (B, N2 + 1)
    float* __restrict__ Y,           // (B, N1, N2, C)
    BucketGeom g) {
  __shared__ int2 run1[kWarps][32];
  const int wi = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  long long w = (long long)blockIdx.x * kWarps + wi;
  const int chunk = (int)(w % g.chunks);
  w /= g.chunks;
  const int tile = (int)(w % g.tiles);
  w /= g.tiles;
  const int a = (int)(w % g.N1);
  const long long b = w / g.N1;
  if (b >= g.B) return;                    // the whole warp

  const int cell = lane / g.L;
  const int j0 = tile * g.cpw + cell;
  const int c0 = chunk * g.CH + (lane - cell * g.L) * NC;
  const int nc = min(NC, min(g.C, (chunk + 1) * g.CH) - c0);
  const bool live = cell < g.cpw && j0 < g.N2 && nc > 0;
  const int j = live ? j0 : 0;
  const long long rowX = (long long)g.N2 * g.C;
  const XT* Xb = X + b * g.N1 * rowX + (live ? c0 : 0);
  const float* Keb = Ke + b * g.E1 * g.E2;
  const int* ord1 = order1 + b * g.E1;
  const int* in1 = ins1 + b * g.E1;
  const int* ord2 = order2 + b * g.E2;
  const int* in2 = ins2 + b * g.E2;
  const int lo1 = offs1[b * (g.N1 + 1) + a];
  const int hi1 = offs1[b * (g.N1 + 1) + a + 1];
  const int lo2 = live ? offs2[b * (g.N2 + 1) + j] : 0;
  const int hi2 = live ? offs2[b * (g.N2 + 1) + j + 1] : 0;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
  for (int base = lo1; base < hi1; base += 32) {
    const int n = min(32, hi1 - base);
    __syncwarp();                          // the previous chunk's readers
    if (lane < n) run1[wi][lane] = make_int2(ord1[base + lane],
                                             in1[base + lane]);
    __syncwarp();
    for (int p = lo2; p < hi2; ++p) {
      const float* kc = Keb + ord2[p];
      const XT* xc = Xb + (long long)in2[p] * g.C;
      for (int r = 0; r < n; ++r) {
        const int2 u = run1[wi][r];
        const float kv = ke_for<XT>(kc[(long long)u.x * g.E2]);
        float x[NC];
        load_channels<XT, NC, kVec>(xc + (long long)u.y * rowX, nc, x);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = add_term<XT>(kv, x[c], acc[c]);
      }
    }
  }
  if (!live) return;
  const long long cy = (b * g.N1 + a) * g.N2 + j;
  const float kp = Kp[cy];
  float x[NC];
  load_channels<XT, NC, kVec>(Xb + ((long long)a * g.N2 + j) * g.C, nc, x);
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] += kp * x[c];
  store_channels<NC, kVec>(Y + cy * g.C + c0, nc, acc);
}

template <typename XT, int NC, bool kVec>
int launch_bucket_nc(const void* X, const void* Kp, const void* Ke,
                     const void* order1, const void* ins1, const void* offs1,
                     const void* order2, const void* ins2, const void* offs2,
                     void* Y, const BucketGeom& g, unsigned blocks,
                     cudaStream_t stream) {
  assoc_bucket_kernel<XT, NC, kVec><<<blocks, kWarps * 32, 0, stream>>>(
      (const XT*)X, (const float*)Kp, (const float*)Ke, (const int*)order1,
      (const int*)ins1, (const int*)offs1, (const int*)order2,
      (const int*)ins2, (const int*)offs2, (float*)Y, g);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_bucket(const void* X, const void* Kp, const void* Ke,
                  const void* order1, const void* ins1, const void* offs1,
                  const void* order2, const void* ins2, const void* offs2,
                  void* Y, int B, int N1, int N2, int C, int E1, int E2,
                  int nc, int vec, void* stream) {
  if (B <= 0 || N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  if (nc <= 0 || nc > 32) return (int)cudaErrorInvalidValue;
  BucketGeom g{B, N1, N2, C, E1, E2};
  g.CH = C < 32 ? C : 32;
  g.L = (g.CH + nc - 1) / nc;
  g.cpw = 32 / g.L;
  g.tiles = (N2 + g.cpw - 1) / g.cpw;
  g.chunks = (C + g.CH - 1) / g.CH;
  const long long warps = (long long)B * N1 * g.tiles * g.chunks;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FPM_NC(NCV, VECV)                                                    \
  if (nc == NCV && (vec != 0) == VECV)                                       \
    return launch_bucket_nc<XT, NCV, VECV>(X, Kp, Ke, order1, ins1, offs1,   \
                                           order2, ins2, offs2, Y, g,        \
                                           (unsigned)blocks, s);
  FPM_NC(1, false)
  FPM_NC(32, false)
  FPM_NC(16 / (int)sizeof(XT), true)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- any size
template <typename XT>
__global__ void assoc_large_kernel(
    const XT* __restrict__ X,        // (B, N1, N2, C)
    const float* __restrict__ Ke,    // (B, E1, E2)
    const int* __restrict__ order1, const int* __restrict__ ins1,
    const int* __restrict__ offs1, const int* __restrict__ order2,
    const int* __restrict__ ins2, const int* __restrict__ offs2,
    float* __restrict__ Y,           // (B, N1, N2, C), edge terms only
    int N1, int N2, int C, int E1, int E2, int block_c) {
  __shared__ int se1[kStage];
  __shared__ int sin1[kStage];
  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * block_c;
  const int cb = min(block_c, C - c0);       // channels of this chunk
  const long long row_elems = (long long)N2 * C;
  const XT* Xb = X + (long long)b * N1 * row_elems;
  const float* Keb = Ke + (long long)b * E1 * E2;
  const int* ord1 = order1 + (long long)b * E1;
  const int* in1 = ins1 + (long long)b * E1;
  const int* ord2 = order2 + (long long)b * E2;
  const int* in2 = ins2 + (long long)b * E2;
  const int* of2 = offs2 + (long long)b * (N2 + 1);
  const int lo1 = offs1[(long long)b * (N1 + 1) + a];
  const int hi1 = offs1[(long long)b * (N1 + 1) + a + 1];
  float* yrow = Y + ((long long)b * N1 + a) * row_elems;

  // tiles of the (column, channel-in-chunk) axis; every thread of the block
  // takes part in each tile's barriers, whether it owns a cell or not
  const int cells = N2 * cb;
  for (int base = 0; base < cells; base += blockDim.x) {
    const int flat = base + threadIdx.x;
    const bool live = flat < cells;
    const int j = live ? flat / cb : 0;
    const int c = c0 + (live ? flat - j * cb : 0);
    const int p_lo = live ? of2[j] : 0;
    const int p_hi = live ? of2[j + 1] : 0;
    float acc = 0.0f;
    for (int lo = lo1; lo < hi1; lo += kStage) {
      const int nr = min(kStage, hi1 - lo);
      __syncthreads();
      for (int r = threadIdx.x; r < nr; r += blockDim.x) {
        se1[r] = ord1[lo + r];
        sin1[r] = in1[lo + r];
      }
      __syncthreads();
      for (int p = p_lo; p < p_hi; ++p) {
        const float* kecol = Keb + ord2[p];
        const XT* xcol = Xb + (long long)in2[p] * C + c;
        for (int r = 0; r < nr; ++r)
          acc = add_term<XT>(ke_for<XT>(kecol[(long long)se1[r] * E2]),
                             to_f32(xcol[(long long)sin1[r] * row_elems]),
                             acc);
      }
    }
    if (live) yrow[(long long)j * C + c] = acc;
  }
}

template <typename XT>
int launch_large(const void* X, const void* Ke, const void* order1,
                 const void* ins1, const void* offs1, const void* order2,
                 const void* ins2, const void* offs2, void* Y, int B, int N1,
                 int N2, int C, int E1, int E2, int block_c, void* stream) {
  if (B <= 0 || N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  if (block_c < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (C + block_c - 1) / block_c;
  if (B > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)N2 * (block_c < C ? block_c : C);
  int threads = (int)((cells + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  dim3 grid((unsigned)N1, (unsigned)B, (unsigned)chunks);
  assoc_large_kernel<XT><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const XT*)X, (const float*)Ke, (const int*)order1, (const int*)ins1,
      (const int*)offs1, (const int*)order2, (const int*)ins2,
      (const int*)offs2, (float*)Y, N1, N2, C, E1, E2, block_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of the
// launch (0 = success); nothing synchronises and nothing is allocated here.
#define FPM_BUCKET_ARGS                                                       \
  const void *X, const void *Kp, const void *Ke, const void *order1,          \
      const void *ins1, const void *offs1, const void *order2,                \
      const void *ins2, const void *offs2, void *Y, int B, int N1, int N2,    \
      int C, int E1, int E2, int nc, int vec, void *stream
#define FPM_LARGE_ARGS                                                        \
  const void *X, const void *Ke, const void *order1, const void *ins1,        \
      const void *offs1, const void *order2, const void *ins2,                \
      const void *offs2, void *Y, int B, int N1, int N2, int C, int E1,       \
      int E2, int block_c, void *stream

extern "C" int fpm_assoc_bucket_f32(FPM_BUCKET_ARGS) {
  return launch_bucket<float>(X, Kp, Ke, order1, ins1, offs1, order2, ins2,
                              offs2, Y, B, N1, N2, C, E1, E2, nc, vec,
                              stream);
}

extern "C" int fpm_assoc_bucket_bf16(FPM_BUCKET_ARGS) {
  return launch_bucket<__nv_bfloat16>(X, Kp, Ke, order1, ins1, offs1, order2,
                                      ins2, offs2, Y, B, N1, N2, C, E1, E2,
                                      nc, vec, stream);
}

extern "C" int fpm_assoc_large_f32(FPM_LARGE_ARGS) {
  return launch_large<float>(X, Ke, order1, ins1, offs1, order2, ins2, offs2,
                             Y, B, N1, N2, C, E1, E2, block_c, stream);
}

extern "C" int fpm_assoc_large_bf16(FPM_LARGE_ARGS) {
  return launch_large<__nv_bfloat16>(X, Ke, order1, ins1, offs1, order2, ins2,
                                     offs2, Y, B, N1, N2, C, E1, E2, block_c,
                                     stream);
}

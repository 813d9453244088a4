// Batched association matvec for Hopper (sm_90a): the bucket-scale kernel
// (rows of X staged in shared memory, Kp term fused) and the blocked kernel
// for pairs of any size (gathers straight from global memory / L2, no Kp).
//
// They replace the TPU Pallas kernels of fpmatch_tpu/kernels/assoc_pallas.py:
// `_kernel` (reached through assoc_matvec_pallas) and `_kernel_large`
// (reached through assoc_matvec_pallas_large). Same function, same contract:
//
//   Y[b,a,j,c] = Kp[b,a,j] * X[b,a,j,c]                      (bucket only)
//              + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
//                    Ke[b,e1,e2] * X[b, in1(e1), in2(e2), c]
//
// X is f32 or bf16, Ke / Kp / the accumulator / Y are f32.
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
// one block per (sample b, output row a). The X rows in1(e1) of the row's
// incident edges are staged in shared memory, `rows` at a time, and the block's
// threads walk the flattened (column j, channel c) axis: the C threads of one
// j read the same Ke element (a broadcast) and C consecutive staged values;
// sums are kept in a shared row of f32 and stored once, coalesced. The
// blocked kernel tiles the channels as well (grid: row a, sample b, channel
// chunk) and stages only the row's edge ids, so nothing has to fit anywhere.
// No cp.async / TMA / tensor cores yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStage = 128;   // edge ids of one output row staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------- bucket scale
template <typename XT>
__global__ void assoc_bucket_kernel(
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
    int N1, int N2, int C, int E1, int E2, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row_elems = N2 * C;
  float* ys = reinterpret_cast<float*>(smem_raw);              // (row_elems)
  int* se1 = reinterpret_cast<int*>(ys + row_elems);           // (rows)
  XT* xs = reinterpret_cast<XT*>(se1 + rows);                  // (rows, row_elems)

  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const XT* Xb = X + (long long)b * N1 * row_elems;
  const float* Keb = Ke + (long long)b * E1 * E2;
  const int* ord1 = order1 + (long long)b * E1;
  const int* in1 = ins1 + (long long)b * E1;
  const int* ord2 = order2 + (long long)b * E2;
  const int* in2 = ins2 + (long long)b * E2;
  const int* of2 = offs2 + (long long)b * (N2 + 1);
  const int lo1 = offs1[(long long)b * (N1 + 1) + a];
  const int hi1 = offs1[(long long)b * (N1 + 1) + a + 1];

  const XT* xrow = Xb + (long long)a * row_elems;
  const float* kprow = Kp + ((long long)b * N1 + a) * N2;
  for (int flat = threadIdx.x; flat < row_elems; flat += blockDim.x)
    ys[flat] = kprow[flat / C] * to_f32(xrow[flat]);

  for (int lo = lo1; lo < hi1; lo += rows) {
    const int nr = min(rows, hi1 - lo);
    __syncthreads();   // the previous chunk's readers are done
    for (int r = threadIdx.x; r < nr; r += blockDim.x) se1[r] = ord1[lo + r];
    for (int r = 0; r < nr; ++r) {
      const XT* src = Xb + (long long)in1[lo + r] * row_elems;
      XT* dst = xs + (long long)r * row_elems;
      for (int i = threadIdx.x; i < row_elems; i += blockDim.x)
        dst[i] = src[i];
    }
    __syncthreads();
    for (int flat = threadIdx.x; flat < row_elems; flat += blockDim.x) {
      const int j = flat / C;
      const int c = flat - j * C;
      float acc = 0.0f;
      const int hi2 = of2[j + 1];
      for (int p = of2[j]; p < hi2; ++p) {
        const float* kecol = Keb + ord2[p];
        const XT* xcol = xs + in2[p] * C + c;
        for (int r = 0; r < nr; ++r)
          acc = fmaf(kecol[(long long)se1[r] * E2],
                     to_f32(xcol[(long long)r * row_elems]), acc);
      }
      ys[flat] += acc;   // each thread owns its cells of the row
    }
  }
  float* yrow = Y + ((long long)b * N1 + a) * row_elems;
  for (int flat = threadIdx.x; flat < row_elems; flat += blockDim.x)
    yrow[flat] = ys[flat];
}

template <typename XT>
int launch_bucket(const void* X, const void* Kp, const void* Ke,
                  const void* order1, const void* ins1, const void* offs1,
                  const void* order2, const void* ins2, const void* offs2,
                  void* Y, int B, int N1, int N2, int C, int E1, int E2,
                  int rows, void* stream) {
  if (B <= 0 || N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  if (rows < 1 || rows > kMaxThreads || B > 65535)
    return (int)cudaErrorInvalidValue;
  const long long row_elems = (long long)N2 * C;
  const size_t smem = (size_t)row_elems * sizeof(float) +
                      (size_t)rows * sizeof(int) +
                      (size_t)rows * row_elems * sizeof(XT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assoc_bucket_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = (int)((row_elems + 31) / 32 * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  dim3 grid((unsigned)N1, (unsigned)B);
  assoc_bucket_kernel<XT><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const XT*)X, (const float*)Kp, (const float*)Ke, (const int*)order1,
      (const int*)ins1, (const int*)offs1, (const int*)order2,
      (const int*)ins2, (const int*)offs2, (float*)Y, N1, N2, C, E1, E2, rows);
  return (int)cudaGetLastError();
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
          acc = fmaf(kecol[(long long)se1[r] * E2],
                     to_f32(xcol[(long long)sin1[r] * row_elems]), acc);
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
      int C, int E1, int E2, int rows, void *stream
#define FPM_LARGE_ARGS                                                        \
  const void *X, const void *Ke, const void *order1, const void *ins1,        \
      const void *offs1, const void *order2, const void *ins2,                \
      const void *offs2, void *Y, int B, int N1, int N2, int C, int E1,       \
      int E2, int block_c, void *stream

extern "C" int fpm_assoc_bucket_f32(FPM_BUCKET_ARGS) {
  return launch_bucket<float>(X, Kp, Ke, order1, ins1, offs1, order2, ins2,
                              offs2, Y, B, N1, N2, C, E1, E2, rows, stream);
}

extern "C" int fpm_assoc_bucket_bf16(FPM_BUCKET_ARGS) {
  return launch_bucket<__nv_bfloat16>(X, Kp, Ke, order1, ins1, offs1, order2,
                                      ins2, offs2, Y, B, N1, N2, C, E1, E2,
                                      rows, stream);
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

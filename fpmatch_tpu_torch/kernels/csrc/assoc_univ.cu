// Blocked UNIV-scale association matvec for Hopper (sm_90a): the locality
// window form, 3 x 3 blocks of X around each output tile.
//
// Replaces the TPU Pallas kernel fpmatch_tpu/kernels/assoc_univ.py::
// _univ_kernel (reached through _univ_pallas from assoc_matvec_univ). Same
// function over the same host plan (kernels/assoc_univ.py::plan_univ): nodes
// sorted along x, graph 1 cut into row blocks of R1 nodes, graph 2 into
// column blocks of R2, each kept edge filed under the block of its scatter
// endpoint, its gather endpoint inside the 3-block window around it. For the
// output tile (row block i, column block j) and channel c:
//
//   Ys[c, i*R1 + s1(p), j*R2 + s2(q)] +=
//       KeR[i*B1 + p, j*B2 + q] * Xp[c, i*R1 + d1(p), j*R2 + d2(q)]
//
// over the kept slots p of block i and q of block j (KeR: Ke gathered into
// blocks; Xp: X sorted, channel-major, with a zero halo of R1 rows / R2
// columns on each side, so every window lies inside it). Spilled edges and Kp * X are added by the wrapper.
// T is f32, or bf16 for both Xp and KeR (precision "default"); products and
// sums are f32.
//
// What the TPU kernel needed and this one does not: the one-hot matmuls that
// gather the window (3R1 x B1 and 3R2 x B2 selections) and scatter into the
// tile, i.e. the MXU doing indexed loads. Here every output cell reduces its
// own terms: the plan's `.to(device)` orders each block's kept slots by local
// scatter index (CSR: `ord` slot, `dl` window-local gather index, `offs` run
// offsets per local row / column), and cell (a, b) of the tile sums
// run1(a) x run2(b) in that order. No atomics: two launches give the same
// bits. Pad slots are in no run and are never read, where the TPU kernel
// multiplies them by KeR == 0; the two differ only where X is not finite at
// the window position a pad slot aliases.
//
// Bound: memory bytes (X, Kp, Ke and Y once; 2 flops per association edge
// and channel is far below what those bytes allow). Design: one block per
// (channel, column block, row block), channel fastest, so the C blocks that
// read one KeR tile run side by side and share it in L2. The block stages its
// CSR tables in shared memory; the channel's 3R1 x 3R2 window of Xp is read
// through L1, which holds it for the block: a version that staged the window
// in shared memory was slower at all six block sizes of the sweep (fewer
// blocks per SM, and it copies the whole window where the terms touch part
// of it), and it could not hold the window at R1 = 64, R2 = 128 or R1 = 32,
// R2 = 256 in f32 (295 KB). One thread per cell, a warp on 32 neighbouring
// columns of one row: the row's p loop is uniform across the warp, the Y
// store is coalesced. No cp.async / TMA / tensor cores, one channel per
// block: KeR is read C times from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) assoc_univ_kernel(
    const T* __restrict__ Xp,        // (C, (I + 2) R1, (J + 2) R2)
    const T* __restrict__ KeR,       // (I B1, J B2)
    const int* __restrict__ ord1,    // (I, B1) kept slots by local scatter row
    const int* __restrict__ dl1,     // (I, B1) their window-local gather row
    const int* __restrict__ offs1,   // (I, R1 + 1) run offsets
    const int* __restrict__ ord2,    // (J, B2)
    const int* __restrict__ dl2,     // (J, B2)
    const int* __restrict__ offs2,   // (J, R2 + 1)
    float* __restrict__ Ys,          // (C, I R1, J R2)
    int I, int J, int R1, int R2, int B1, int B2) {
  extern __shared__ int smem[];
  int* so1 = smem;               // (R1 + 1) run offsets of the row block
  int* sp1 = so1 + (R1 + 1);     // (B1) slots in run order
  int* sd1 = sp1 + B1;           // (B1) their window-local gather rows
  int* so2 = sd1 + B1;
  int* sq2 = so2 + (R2 + 1);
  int* sd2 = sq2 + B2;

  const int c = blockIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  const long long H = (long long)(I + 2) * R1;
  const long long W = (long long)(J + 2) * R2;

  for (int t = threadIdx.x; t <= R1; t += blockDim.x)
    so1[t] = offs1[(long long)i * (R1 + 1) + t];
  for (int t = threadIdx.x; t < B1; t += blockDim.x) {
    sp1[t] = ord1[(long long)i * B1 + t];
    sd1[t] = dl1[(long long)i * B1 + t];
  }
  for (int t = threadIdx.x; t <= R2; t += blockDim.x)
    so2[t] = offs2[(long long)j * (R2 + 1) + t];
  for (int t = threadIdx.x; t < B2; t += blockDim.x) {
    sq2[t] = ord2[(long long)j * B2 + t];
    sd2[t] = dl2[(long long)j * B2 + t];
  }
  // the window's origin: Xp row i*R1 is sorted row (i - 1)*R1 (halo R1)
  const T* xwin = Xp + ((long long)c * H + (long long)i * R1) * W +
                  (long long)j * R2;
  __syncthreads();

  const long long ke_stride = (long long)J * B2;
  const T* ke = KeR + (long long)i * B1 * ke_stride + (long long)j * B2;
  const long long y_stride = (long long)J * R2;
  float* yt = Ys + ((long long)c * I * R1 + (long long)i * R1) * y_stride +
              (long long)j * R2;
  for (int cell = threadIdx.x; cell < R1 * R2; cell += blockDim.x) {
    const int a = cell / R2;
    const int b = cell - a * R2;
    const int lo2 = so2[b];
    const int hi2 = so2[b + 1];
    const int hi1 = so1[a + 1];
    float acc = 0.0f;
    for (int k1 = so1[a]; k1 < hi1; ++k1) {
      const T* kerow = ke + (long long)sp1[k1] * ke_stride;
      const T* xrow = xwin + sd1[k1] * W;
      for (int k2 = lo2; k2 < hi2; ++k2)
        acc = fmaf(to_f32(kerow[sq2[k2]]), to_f32(xrow[sd2[k2]]), acc);
    }
    yt[(long long)a * y_stride + b] = acc;
  }
}

template <typename T>
int launch(const void* Xp, const void* KeR, const void* ord1, const void* dl1,
           const void* offs1, const void* ord2, const void* dl2,
           const void* offs2, void* Ys, int C, int I, int J, int R1, int R2,
           int B1, int B2, void* stream) {
  if (C <= 0 || I <= 0 || J <= 0) return (int)cudaSuccess;
  if (R1 <= 0 || R2 <= 0 || B1 <= 0 || B2 <= 0 || I > 65535 || J > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * ((size_t)R1 + 1 + 2 * (size_t)B1 +
                                     (size_t)R2 + 1 + 2 * (size_t)B2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        assoc_univ_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)C, (unsigned)J, (unsigned)I);
  assoc_univ_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)Xp, (const T*)KeR, (const int*)ord1, (const int*)dl1,
      (const int*)offs1, (const int*)ord2, (const int*)dl2,
      (const int*)offs2, (float*)Ys, I, J, R1, R2, B1, B2);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of the
// launch (0 = success); nothing synchronises and nothing is allocated here.
#define FPM_UNIV_ARGS                                                        \
  const void *Xp, const void *KeR, const void *ord1, const void *dl1,        \
      const void *offs1, const void *ord2, const void *dl2,                  \
      const void *offs2, void *Ys, int C, int I, int J, int R1, int R2,      \
      int B1, int B2, void *stream

extern "C" int fpm_assoc_univ_f32(FPM_UNIV_ARGS) {
  return launch<float>(Xp, KeR, ord1, dl1, offs1, ord2, dl2, offs2, Ys, C, I,
                       J, R1, R2, B1, B2, stream);
}

extern "C" int fpm_assoc_univ_bf16(FPM_UNIV_ARGS) {
  return launch<__nv_bfloat16>(Xp, KeR, ord1, dl1, offs1, ord2, dl2, offs2,
                               Ys, C, I, J, R1, R2, B1, B2, stream);
}

// The edge / diagonal gradient of the association matvec for Hopper (sm_90a):
// "K6". With the roles (out, in) = (src, dst), or (dst, src) for K^T, the
// forward (K2 / K3, csrc/assoc_bucket.cu) computes
//
//   Y[b,a,j,c] = Kp[b,a,j] * X[b,a,j,c]
//              + sum_{e1: out1(e1)=a} sum_{e2: out2(e2)=j}
//                    Ke[b,e1,e2] * X[b, in1(e1), in2(e2), c]
//
// and for an upstream gradient dY this file computes
//
//   dKe[b,e1,e2] = sum_c dY[b, out1(e1), out2(e2), c] * X[b, in1(e1), in2(e2), c]
//   dKp[b,i,j]   = sum_c dY[b,i,j,c] * X[b,i,j,c]
//
// (dX is K2 / K3 again with the roles swapped.) No Pallas kernel stands
// behind it: on the training path the JAX package leaves the association
// matvec to XLA (fpmatch_tpu/ops/assoc.py:46 assoc_matvec: gather, multiply
// by Ke, two segment sums) and JAX AD derives this gradient from it.
//
// X is f32 or bf16 (dY, dKe, dKp are f32). With bf16 X the forward's terms
// are bf16(bf16(Ke) X), and JAX AD rounds dKe as follows: dY is cast to bf16,
// each product bf16(dY) X is rounded to bf16, and the sum over c is bf16
// (the cast Ke -> bf16 then hands it back as f32). Here dY is rounded to
// bf16 once per staged element, each product is rounded to bf16, the sum is
// f32 and is rounded to bf16 once at the end: JAX's value but for the order
// of its bf16 accumulation. dKp is the f32 sum of dY f32(X), as JAX's
// `Kp * X.astype(f32)` gives it.
//
// Bound: memory bytes. dKe (B E1 E2 f32) is the largest array written;
// dY and X are read, 2 C flops per association edge and channel is far below
// what those bytes allow.
//
// Design (simple and exact first). One launch, two kinds of blocks:
//  * a block per (sample b, graph-1 edge e1) stages the dY row out1(e1) and
//    the X row in1(e1) (N2 x C f32 each, one channel chunk at a time when
//    they do not fit in shared memory) and a thread per e2 takes the dot
//    over C of dY_s[out2(e2)] and X_s[in2(e2)], so the write of
//    dKe[b, e1, :] is coalesced; with more than one chunk the thread adds
//    the chunk's sum to what it wrote for the previous one (same thread, same
//    order). A graph-1 slot that e1_mask marks as padding, or a graph-2 slot
//    that e2_mask marks, gets dKe = 0.
//  * the blocks after those take dKp, a thread per (b, i, j) cell.
// The staged rows are f32 in both instantiations (bf16 X is widened, and dY
// rounded, while it is staged), so one chunk rule serves both.
// No atomics and a fixed summation order (channels in ascending order), so
// two launches give the same bits. No cp.async / TMA / tensor cores.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

using fpm_common::round_bf16;
using fpm_common::to_f32;

template <typename XT>
__global__ void __launch_bounds__(kThreads)
assoc_grad_kernel(const float* __restrict__ dY, const XT* __restrict__ X,
                  const int* __restrict__ out1, const int* __restrict__ in1,
                  const int* __restrict__ out2, const int* __restrict__ in2,
                  const uint8_t* __restrict__ m1,
                  const uint8_t* __restrict__ m2, float* __restrict__ dKe,
                  float* __restrict__ dKp, int B, int N1, int N2, int C,
                  int E1, int E2, int cc) {
  constexpr bool kBf16 = sizeof(XT) == 2;
  extern __shared__ float smem[];
  const long long edge_blocks = (long long)B * E1;
  const long long blk = blockIdx.x;

  if (blk >= edge_blocks) {                       // ---- dKp: a cell a thread
    const long long cell = (blk - edge_blocks) * kThreads + threadIdx.x;
    const long long cells = (long long)B * N1 * N2;
    if (cell >= cells) return;
    const float* y = dY + cell * C;
    const XT* x = X + cell * C;
    float acc = 0.0f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(__ldg(y + c), to_f32(__ldg(x + c)), acc);
    dKp[cell] = acc;
    return;
  }

  const int b = (int)(blk / E1);
  const int e1 = (int)(blk % E1);
  float* row = dKe + blk * E2;                    // dKe[b, e1, :]
  const bool live1 = m1 == nullptr || m1[(long long)b * E1 + e1] != 0;
  if (!live1) {                                   // block-uniform branch
    for (int e2 = threadIdx.x; e2 < E2; e2 += blockDim.x) row[e2] = 0.0f;
    return;
  }
  const int a = out1[(long long)b * E1 + e1];
  const int r = in1[(long long)b * E1 + e1];
  const float* yrow = dY + ((long long)b * N1 + a) * N2 * C;
  const XT* xrow = X + ((long long)b * N1 + r) * N2 * C;
  const int* o2 = out2 + (long long)b * E2;
  const int* i2 = in2 + (long long)b * E2;
  const uint8_t* mk2 = m2 == nullptr ? nullptr : m2 + (long long)b * E2;
  float* ys = smem;                               // (N2, cc)
  float* xs = smem + (long long)N2 * cc;          // (N2, cc)

  for (int c0 = 0; c0 < C; c0 += cc) {
    const int w = min(cc, C - c0);
    __syncthreads();                              // previous chunk consumed
    for (int k = threadIdx.x; k < N2 * w; k += blockDim.x) {
      const int j = k / w, c = k - j * w;
      const float y = __ldg(yrow + (long long)j * C + c0 + c);
      ys[j * w + c] = kBf16 ? round_bf16(y) : y;
      xs[j * w + c] = to_f32(__ldg(xrow + (long long)j * C + c0 + c));
    }
    __syncthreads();
    for (int e2 = threadIdx.x; e2 < E2; e2 += blockDim.x) {
      if (mk2 != nullptr && mk2[e2] == 0) {
        row[e2] = 0.0f;
        continue;
      }
      const float* yp = ys + __ldg(o2 + e2) * w;
      const float* xp = xs + __ldg(i2 + e2) * w;
      float acc = c0 == 0 ? 0.0f : row[e2];
      if constexpr (kBf16) {
        // bf16 x bf16 is exact in f32; the product is rounded as JAX's
        // bf16 multiply, the f32 sum once at the end
        for (int c = 0; c < w; ++c)
          acc = __fadd_rn(acc, round_bf16(__fmul_rn(yp[c], xp[c])));
        row[e2] = c0 + w >= C ? round_bf16(acc) : acc;
      } else {
        for (int c = 0; c < w; ++c) acc = fmaf(yp[c], xp[c], acc);
        row[e2] = acc;
      }
    }
  }
}

template <typename XT>
int launch_grad(const void* dY, const void* X, const void* out1,
                const void* in1, const void* out2, const void* in2,
                const void* m1, const void* m2, void* dKe, void* dKp, int B,
                int N1, int N2, int C, int E1, int E2, int cc, int smem,
                void* stream) {
  const long long edge_blocks = (long long)B * E1;
  const long long cells = (long long)B * N1 * N2;
  const long long blocks = edge_blocks + (cells + kThreads - 1) / kThreads;
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL || C < 1 || cc < 1) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assoc_grad_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  assoc_grad_kernel<XT><<<(unsigned)blocks, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (const float*)dY, (const XT*)X, (const int*)out1, (const int*)in1,
      (const int*)out2, (const int*)in2, (const uint8_t*)m1,
      (const uint8_t*)m2, (float*)dKe, (float*)dKp, B, N1, N2, C, E1, E2, cc);
  return (int)cudaGetLastError();
}

}  // namespace

// dY: (B, N1, N2, C) f32; X: the same shape, f32 (`_f32`) or bf16
// (`_bf16`); out1, in1: (B, E1) int32; out2, in2: (B, E2) int32; m1: (B, E1)
// / m2: (B, E2) bytes (1 = real edge) or null; dKe (B, E1, E2) and dKp
// (B, N1, N2) f32, written in full. cc: channels per staged chunk (the
// wrapper picks it so that 2 N2 cc floats fit in `smem` bytes). Returns the
// cudaError_t of the launch.
#define FPM_GRAD_ENTRY(NAME, XT)                                              \
  extern "C" int NAME(const void* dY, const void* X, const void* out1,        \
                      const void* in1, const void* out2, const void* in2,     \
                      const void* m1, const void* m2, void* dKe, void* dKp,   \
                      int B, int N1, int N2, int C, int E1, int E2, int cc,   \
                      int smem, void* stream) {                               \
    return launch_grad<XT>(dY, X, out1, in1, out2, in2, m1, m2, dKe, dKp, B,  \
                           N1, N2, C, E1, E2, cc, smem, stream);              \
  }

FPM_GRAD_ENTRY(fpm_assoc_grad_f32, float)
FPM_GRAD_ENTRY(fpm_assoc_grad_bf16, __nv_bfloat16)

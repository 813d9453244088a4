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
// bf16 once, each product is rounded to bf16, the sum is f32 and is rounded
// to bf16 once at the end: JAX's value but for the order of its bf16
// accumulation. dKp is the f32 sum of dY f32(X), as JAX's
// `Kp * X.astype(f32)` gives it.
//
// Bound: memory bytes. dKe (B E1 E2 f32) is the largest array written;
// dY and X are read, 2 C flops per association edge and channel is far below
// what those bytes allow.
//
// Design: the row-streaming layout of K3 (csrc/assoc_bucket.cu), on the
// forward's own grouping (`plan_bucket`: order1 / ins1 / offs1, graph-1
// edges sorted by out1), so the backward adds no prologue. A block owns
// (output row a, sample b, a tile of graph-2 edge slots); a thread owns one
// slot e2 of the tile and keeps the dY values it needs, dY[b, a, out2(e2),
// :], in registers (rounded to bf16 and packed in pairs with bf16 X) for
// the whole row. The block walks the row's graph-1 run: for each e1 it
// streams the X row X[b, in1(e1), :, :] into shared memory with cp.async,
// double-buffered (the next row loads while this one is dotted), and each
// thread takes the dot over C with X_s[in2(e2)] and writes dKe[b, e1, e2]:
// the writes of a warp are contiguous. Per term a thread reads C values of
// X from shared memory (two channels per 32-bit word with bf16 X, one packed
// bf16 multiply per pair) and nothing else; a staged node of an even number
// of words is padded by one word, so a warp's reads spread over the banks.
// The same launch writes dKe = 0 on the graph-1 slots that the plan puts in
// no run (masked ones, spread over the blocks) and on masked graph-2 slots,
// and the blocks of tile 0 write dKp for their row while the first X row
// loads (each thread's C values read at once, then summed in order).
// kernels/assoc_grad.py::grad_geometry (the one place of the shape rule)
// picks the tile, the channels a thread holds per pass (more
// than 32 take several passes over the run, each adding to what the same
// thread wrote) and whether two X rows fit the staging budget; otherwise
// the threads read X from global memory / L2. No atomics, channels summed
// in ascending order in one f32 sum per output, so two launches give the
// same bits (and the bits of the earlier block-per-edge form). No TMA /
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

using fpm_common::hi_f32;
using fpm_common::lo_f32;
using fpm_common::load_pairs;
using fpm_common::magic_of;
using fpm_common::mul_bf16x2;
using fpm_common::round_bf16;
using fpm_common::stage;
using fpm_common::stage_padded;
using fpm_common::to_f32;

// The launch geometry, computed by kernels/assoc_grad.py::grad_geometry
// and passed as kGeomInts ints in this order; the magic is derived here.
struct GradGeom {
  int B, N1, N2, C, E1, E2;
  int cb;            // channels per pass (<= nc)
  int passes;        // ceil(C / cb)
  int nc;            // channels a thread holds: the instantiation
  int threads;       // per block: graph-2 slots per tile
  int tiles;         // ceil(E2 / threads)
  int staged;        // 1: X rows through shared memory
  int xs;            // elements per staged node
  int nw;            // words per node when padded (0: as it is)
  int x_bytes;       // one staged X row, 16-byte padded
  int smem;          // dynamic shared memory of a block
  unsigned wmagic;   // ceil(2^32 / nw)
};
constexpr int kGeomInts = 16;
static_assert(offsetof(GradGeom, wmagic) == kGeomInts * sizeof(int),
              "the ints grad_geometry passes come first, in order");
constexpr int kGradTile = 512;        // most threads of a block
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

// X[b, r, :, :] (N2 nodes of C values) into a staged row: as it is, or word
// by word with one word of padding after each node (GradGeom::nw).
template <typename XT>
__device__ __forceinline__ void stage_x(unsigned char* dst, const XT* src,
                                        const GradGeom& g) {
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  if (g.nw == 0)
    stage(dst, s, (int)((long long)g.N2 * g.C * sizeof(XT)));
  else
    stage_padded(dst, s, g.N2, g.nw, g.wmagic);
}

// The dY values a thread keeps for its slot: dY[b, a, out2(e2), c0 + k],
// k < n (0 past n). f32 X: as they are; bf16 X: rounded to bf16, packed in
// pairs (the NC / 2 words of yw), as JAX AD casts dY to bf16.
template <typename XT, int NC>
struct DyCache {
  static constexpr bool kPairs = sizeof(XT) == 2 && NC % 2 == 0;
  float y[kPairs ? 1 : NC];
  unsigned yw[kPairs ? NC / 2 : 1];

  __device__ __forceinline__ void load(const float* p, int n) {
    if constexpr (kPairs) {
#pragma unroll
      for (int k = 0; k < NC / 2; ++k) {
        const float lo = 2 * k < n ? __ldg(p + 2 * k) : 0.0f;
        const float hi = 2 * k + 1 < n ? __ldg(p + 2 * k + 1) : 0.0f;
        const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        yw[k] = *reinterpret_cast<const unsigned*>(&v);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float v = k < n ? __ldg(p + k) : 0.0f;
        y[k] = sizeof(XT) == 2 ? round_bf16(v) : v;
      }
    }
  }

  // acc + sum over k < n of dY_k x_k, in ascending k: an fma per channel
  // (f32 X), bf16(bf16(dY) x) added in f32 (bf16 X; kLdg: x in global
  // memory, else in shared memory)
  template <bool kLdg>
  __device__ __forceinline__ float dot(const XT* x, int n, float acc) const {
    if constexpr (kPairs) {
      unsigned xw[NC / 2];
      load_pairs<NC / 2, kLdg>(x, n, xw);
#pragma unroll
      for (int k = 0; k < NC / 2; ++k) {
        const unsigned t = mul_bf16x2(yw[k], xw[k]);
        if (2 * k < n) acc = __fadd_rn(acc, lo_f32(t));
        if (2 * k + 1 < n) acc = __fadd_rn(acc, hi_f32(t));
      }
    } else {
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (k < n) {
          const float xv = to_f32(kLdg ? __ldg(x + k) : x[k]);
          if constexpr (sizeof(XT) == 2)
            acc = __fadd_rn(acc, round_bf16(__fmul_rn(y[k], xv)));
          else
            acc = fmaf(y[k], xv, acc);
        }
      }
    }
    return acc;
  }
};

// dKp[b, a, :] = sum_c dY[b, a, j, c] X[b, a, j, c] for one row, a thread
// per cell: NC channels' loads issued at once, then an fma each in
// ascending c (one f32 sum, the same bits whatever NC)
template <typename XT, int NC>
__device__ __forceinline__ void dkp_row(const float* __restrict__ y,
                                        const XT* __restrict__ x,
                                        float* __restrict__ out,
                                        const GradGeom& g) {
  for (int j = threadIdx.x; j < g.N2; j += blockDim.x) {
    const float* yj = y + (long long)j * g.C;
    const XT* xj = x + (long long)j * g.C;
    float acc = 0.0f;
    for (int c0 = 0; c0 < g.C; c0 += NC) {
      float yv[NC], xv[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const bool in = c0 + k < g.C;
        yv[k] = in ? __ldg(yj + c0 + k) : 0.0f;
        xv[k] = in ? to_f32(__ldg(xj + c0 + k)) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (c0 + k < g.C) acc = fmaf(yv[k], xv[k], acc);
    }
    out[j] = acc;
  }
}

template <typename XT, int NC, bool kStage>
__global__ void __launch_bounds__(kGradTile)
assoc_grad_kernel(const float* __restrict__ dY, const XT* __restrict__ X,
                  const int* __restrict__ order1,   // (B, E1) by out1
                  const int* __restrict__ ins1,     // (B, E1) their in1
                  const int* __restrict__ offs1,    // (B, N1 + 1)
                  const int* __restrict__ out2, const int* __restrict__ in2,
                  const uint8_t* __restrict__ m2,   // (B, E2) or null
                  float* __restrict__ dKe, float* __restrict__ dKp,
                  GradGeom g) {
  constexpr bool kBf16 = sizeof(XT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const int e2 = blockIdx.z * g.threads + threadIdx.x;
  const bool slot = e2 < g.E2;
  const long long s2 = (long long)b * g.E2 + e2;
  // the slot's endpoints and mask are read together (0 past the tiles)
  const bool live2 = slot && (m2 == nullptr || m2[s2] != 0);
  const int o2 = slot ? out2[s2] : 0;
  const int i2 = slot ? in2[s2] : 0;
  const int* of1 = offs1 + (long long)b * (g.N1 + 1);
  const int* ord1 = order1 + (long long)b * g.E1;
  const int* in1 = ins1 + (long long)b * g.E1;
  const int lo = of1[a];
  const int hi = g.E2 > 0 ? of1[a + 1] : lo;
  const int tail = of1[g.N1];
  const long long row_elems = (long long)g.N2 * g.C;
  const XT* Xb = X + (long long)b * g.N1 * row_elems;
  float* dKeb = dKe + (long long)b * g.E1 * g.E2;
  const float* dYa = dY + ((long long)b * g.N1 + a) * row_elems;

  for (int pass = 0; pass < g.passes; ++pass) {
    const int c0 = pass * g.cb;
    const int n = min(g.cb, g.C - c0);
    const bool last = pass + 1 == g.passes;
    DyCache<XT, NC> dy;
    dy.load(dYa + (long long)o2 * g.C + c0, live2 ? n : 0);

    auto load = [&](int k) {
      stage_x(smem + ((k - lo) & 1) * g.x_bytes,
              Xb + (long long)in1[k] * row_elems, g);
      __pipeline_commit();
    };
    if (kStage && lo < hi) load(lo);
    // dKp of row a, by the blocks of tile 0, while the first row loads
    if (pass == 0 && blockIdx.z == 0)
      dkp_row<XT, NC>(dYa, Xb + a * row_elems,
                      dKp + ((long long)b * g.N1 + a) * g.N2, g);
    for (int k = lo; k < hi; ++k) {
      const XT* x;
      if constexpr (kStage) {
        // two buffers: the next row loads while this one is dotted
        if (k + 1 < hi) {
          load(k + 1);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();               // this row has landed for everyone
        x = reinterpret_cast<const XT*>(smem + ((k - lo) & 1) * g.x_bytes) +
            (long long)i2 * g.xs + c0;
      } else {
        x = Xb + (long long)in1[k] * row_elems + (long long)i2 * g.C + c0;
      }
      if (slot) {
        float* out = dKeb + (long long)ord1[k] * g.E2 + e2;
        float acc = 0.0f;
        if (live2) {
          acc = dy.template dot<!kStage>(x, n, pass == 0 ? 0.0f : *out);
          if (kBf16 && last) acc = round_bf16(acc);
        }
        *out = acc;
      }
      if constexpr (kStage) __syncthreads();   // read before reuse
    }
  }

  // graph-1 slots in no run (masked): dKe = 0, every N1-th one per block
  if (slot)
    for (int t = tail + a; t < g.E1; t += g.N1)
      dKeb[(long long)ord1[t] * g.E2 + e2] = 0.0f;
}

template <typename XT, int NC, bool kStage>
int launch_grad_nc(const void* dY, const void* X, const void* const* plan,
                   const void* out2, const void* in2, const void* m2,
                   void* dKe, void* dKp, const GradGeom& g,
                   cudaStream_t stream) {
  auto kern = assoc_grad_kernel<XT, NC, kStage>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)g.N1, (unsigned)g.B, (unsigned)g.tiles);
  kern<<<grid, g.threads, g.smem, stream>>>(
      (const float*)dY, (const XT*)X, (const int*)plan[0],
      (const int*)plan[1], (const int*)plan[2], (const int*)out2,
      (const int*)in2, (const uint8_t*)m2, (float*)dKe, (float*)dKp, g);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_grad(const void* dY, const void* X, const void* const* plan,
                const void* out2, const void* in2, const void* m2, void* dKe,
                void* dKp, const int* geom, int n_geom, void* stream) {
  if (n_geom != kGeomInts) return (int)cudaErrorInvalidValue;
  GradGeom g;
  std::memcpy(&g, geom, kGeomInts * sizeof(int));
  if (g.B <= 0 || g.N1 <= 0 || g.N2 <= 0 || g.C <= 0) return (int)cudaSuccess;
  // what the kernel relies on; grad_geometry never breaks it
  const bool ok =
      g.E1 >= 0 && g.E2 >= 0 && g.cb >= 1 && g.cb <= g.nc &&
      g.passes == (g.C + g.cb - 1) / g.cb && g.B <= 65535 &&
      g.threads >= 32 && g.threads <= kGradTile && g.threads % 32 == 0 &&
      g.tiles >= 1 && g.tiles <= 65535 &&
      (long long)g.tiles * g.threads >= g.E2 && g.smem >= 0 &&
      g.smem <= kMaxSmem &&
      (!g.staged ||
       (g.xs >= g.C && g.x_bytes % 16 == 0 &&
        g.x_bytes >= (long long)g.N2 * g.xs * (long long)sizeof(XT) &&
        2LL * g.x_bytes <= g.smem &&
        (g.nw == 0 || g.xs * sizeof(XT) ==
                                                        4LL * (g.nw + 1))));
  if (!ok) return (int)cudaErrorInvalidValue;
  g.wmagic = magic_of(g.nw);
  cudaStream_t s = (cudaStream_t)stream;
#define FPM_NC(NCV)                                                           \
  if (g.nc == NCV)                                                            \
    return g.staged                                                           \
               ? launch_grad_nc<XT, NCV, true>(dY, X, plan, out2, in2, m2,    \
                                               dKe, dKp, g, s)                \
               : launch_grad_nc<XT, NCV, false>(dY, X, plan, out2, in2, m2,   \
                                                dKe, dKp, g, s);
  FPM_NC(1) FPM_NC(4) FPM_NC(8) FPM_NC(12) FPM_NC(16) FPM_NC(20) FPM_NC(24)
  FPM_NC(28) FPM_NC(32)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dY: (B, N1, N2, C) f32; X: the same shape, f32 (`_f32`) or bf16
// (`_bf16`); order1, ins1: (B, E1) and offs1: (B, N1 + 1) int32, the
// forward's grouping of graph 1 by out1 (kernels/assoc_bucket.py::
// plan_bucket); out2, in2: (B, E2) int32 in the forward's roles; m2: (B, E2)
// bytes (1 = real edge) or null; dKe (B, E1, E2) and dKp (B, N1, N2) f32,
// written in full; geom: the kGeomInts ints of grad_geometry. Returns the
// cudaError_t of the launch.
#define FPM_GRAD_ENTRY(NAME, XT)                                              \
  extern "C" int NAME(const void* dY, const void* X, const void* order1,      \
                      const void* ins1, const void* offs1, const void* out2,  \
                      const void* in2, const void* m2, void* dKe, void* dKp,  \
                      const int* geom, int n_geom, void* stream) {            \
    const void* plan[3] = {order1, ins1, offs1};                              \
    return launch_grad<XT>(dY, X, plan, out2, in2, m2, dKe, dKp, geom,        \
                           n_geom, stream);                                   \
  }

FPM_GRAD_ENTRY(fpm_assoc_grad_f32, float)
FPM_GRAD_ENTRY(fpm_assoc_grad_bf16, __nv_bfloat16)

// UNIV-scale association matvec for Hopper (sm_90a): one pair, one block per
// output row, (Ke row, X row) pairs streamed through shared memory.
//
// Replaces the TPU Pallas kernel fpmatch_tpu/kernels/assoc_univ_v3.py::_kernel
// (reached through assoc_matvec_univ_v3_raw, which adds the spilled edges).
// Same function, same contract:
//
//   Y[i1,i2,c] = Kp[i1,i2] * X[i1,i2,c]
//              + sum_{e1: out1(e1)=i1} sum_{e2: out2(e2)=i2}
//                    Ke[e1,e2] * X[in1(e1), in2(e2), c]
//
// Every edge takes part here (nothing spills); the orientation (K or K^T) is
// fixed by the host-built tables. X is f32 or bf16, Ke / Kp / the accumulator
// / Y are f32. With bf16 X a pair that the JAX plan keeps (neither table
// entry carries the spill bit) reads Ke rounded to bf16, as the JAX kernel's
// bf16 KeP does; a spilled pair reads f32 Ke, as its XLA postlude does.
//
// What the TPU kernel needed and this one does not: the banded lane gathers
// over a spatially sorted graph 2, the degree-sorted row groups, the MXU
// channel-expansion matmul, the sorted / transposed X layout (prep / unprep)
// and the spill postlude.
//
// Bound: memory bytes. Each Ke element belongs to exactly one output row, so
// the least traffic is X + Kp + Ke + Y once (the arithmetic, 2 flops per
// association edge and channel, is ~5x below what those bytes allow). What
// held the first port back was not DRAM: a thread per (i2, c) re-read every
// index and Ke value once per channel, and every 4-byte read was a scattered
// 32-byte sector. Design:
//  * a block owns one output row i1 (rows largest degree first) and walks
//    the row's graph-1 edges e1 in order. For each it streams the contiguous
//    row Ke[e1, :E2] and the X row X[in1(e1), :, :] (N2 C values) into shared
//    memory with cp.async, double-buffered: the next pair loads while the
//    current one is summed. Ke crosses DRAM once; X (a few MB) stays in L2.
//    Where two buffers do not fit in kStageBytes (or C > 32), a second
//    instantiation reads both from global memory; the launcher picks it by
//    shape. A staged node whose values are an even number of words is
//    padded by one word, so a warp's gathers spread over the banks;
//  * a thread owns an output cell (i1, i2) with up to 32 channels in
//    registers across the whole e1 loop (channel chunks of 32 above that, a
//    grid dimension), so an index and a Ke value are read once per term for
//    all channels, from shared memory;
//  * graph 2's incident lists are a degree-sorted CSR cut into per-warp
//    slices (lane l's entry b at slice + 32 b + l: each step a coalesced
//    256-byte load); a lane reads only its own count, and the lanes of a warp
//    have nearly the same count, so no pad entry is issued;
//  * the epilogue puts the row's sums into shared memory by column, then
//    the block adds Kp X and writes the row contiguously. Written straight
//    from registers (as rows wider than a block still are), a lane's C
//    scalar stores land in their own sectors all over the row: at the
//    serving shapes, C=17, that took the kernel from 0.16 to 0.25 ms
//    (H100, scripts/time_univ_v3.py).
// Each cell's sum runs over the row's e1 in order, then its own e2 in order:
// a fixed order, no atomics, so two launches give the same bits.
// What is left between this and the byte bound: at C = 1 the stream of Ke
// rows through two buffers per block; at C = 17 each term's C words of X
// gathered from shared memory at unrelated banks (32 random banks put ~3.5
// lanes on the busiest one), and each X row crossing L2 once per graph-1
// edge (E1 N2 C values in all, ~3x the Ke bytes).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace {

using fpm_common::round_bf16;
using fpm_common::to_f32;

constexpr int kTile = 640;       // thread positions per block (of N2)
constexpr int kChunk = 32;       // channels per thread
constexpr int kSpill = 0x7fffffff;
// shared memory a block may stage (two (Ke row, X row) buffers), so that two
// blocks share an SM; above it, or above kChunk channels, the kernel reads X
// and Ke from global memory
constexpr int kStageBytes = 112 * 1024;

struct Geom {
  int N1, N2, C, E1, E2;
  long long ke_stride;
  int ke_bytes, x_bytes;         // one staged Ke row / X row, 16-byte padded
  // A staged X row keeps each node's C values contiguous; where they are an
  // even number of 32-bit words, one word of padding follows each node (an
  // even word stride maps the nodes of a warp's gather onto a few banks:
  // unpadded, C=16 f32 ran 3.3x slower than C=17 in chip_smoke.py). xs:
  // elements per staged node; nw: words per node when padded (0: the row is
  // staged as it is).
  int xs, nw;
  int ts;                        // floats per node of the epilogue's row
  unsigned magic, wmagic;        // ceil(2^32 / C), ceil(2^32 / nw): i / C
                                 // = umulhi(i, magic)
};

__device__ __forceinline__ int div_by(int i, int d, unsigned magic) {
  return d == 1 ? i : (int)__umulhi((unsigned)i, magic);
}

// Copy `bytes` (a multiple of 2) from global to shared memory with the
// whole block: cp.async of 16 or 4 bytes where the source allows it, plain
// loads and stores otherwise (both visible after the next barrier that
// follows __pipeline_wait_prior).
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int bytes) {
  const unsigned a = (unsigned)reinterpret_cast<unsigned long long>(src);
  int done = 0;
  if ((a & 15) == 0) {
    const int n = bytes >> 4;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __pipeline_memcpy_async(dst + 16 * i, src + 16 * i, 16);
    done = n << 4;
  }
  if ((a & 3) == 0) {
    const int n = (bytes - done) >> 2;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __pipeline_memcpy_async(dst + done + 4 * i, src + done + 4 * i, 4);
    done += n << 2;
  }
  const int n = (bytes - done) >> 1;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    reinterpret_cast<unsigned short*>(dst + done)[i] =
        reinterpret_cast<const unsigned short*>(src + done)[i];
}

// X[in1, :, :] (N2 nodes of C values) into a staged row: as it is, or
// word by word with one word of padding after each node (Geom::nw).
template <typename XT>
__device__ __forceinline__ void stage_x(unsigned char* dst, const XT* src,
                                        const Geom& g) {
  if (g.nw == 0) {
    stage(dst, reinterpret_cast<const unsigned char*>(src),
          (int)((long long)g.N2 * g.C * sizeof(XT)));
    return;
  }
  const int words = g.N2 * g.nw;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = div_by(i, g.nw, g.wmagic);
    __pipeline_memcpy_async(
        dst + 4 * (i + j),
        reinterpret_cast<const unsigned char*>(src) + 4 * i, 4);
  }
}

// The terms of one graph-1 edge for one cell: its `cnt` graph-2 entries
// (stride 32), each Ke value read once for all channels; a node's values
// start every `xs` elements of x_row.
template <typename XT, int NC>
__device__ __forceinline__ void edge_terms(const float* ke_row,
                                           const XT* x_row,
                                           const int2* __restrict__ ent,
                                           int cnt, int xs, int n,
                                           bool keep1, float (&acc)[NC]) {
  constexpr bool kRound = std::is_same<XT, __nv_bfloat16>::value;
  for (int b = 0; b < cnt; ++b) {
    const int2 v = __ldg(ent + b * 32);
    float ke = ke_row[v.y & kSpill];
    if (kRound && keep1 && v.y >= 0) ke = round_bf16(ke);
    const XT* xp = x_row + (long long)v.x * xs;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < n) acc[k] = fmaf(ke, to_f32(xp[k]), acc[k]);
  }
}

// Blocks per SM: with one channel a block mostly waits for its next Ke row
// and 32 registers do, so three share an SM (at the serving shapes 0.044 ->
// 0.040 ms; four buffers per block instead of two were slower, 0.050).
template <typename XT, int NC, bool kStage>
__global__ void __launch_bounds__(kTile, NC == 1 ? 3 : 2) assoc_univ_v3_kernel(
    const XT* __restrict__ X,         // (N1, N2, C)
    const float* __restrict__ Kp,     // (N1, N2)
    const float* __restrict__ Ke,     // (>= E1, >= E2), row stride ke_stride
    const int* __restrict__ rows1,    // (N1,) output row of each block
    const int* __restrict__ ptr1,     // (N1 + 1,) CSR offsets by output row
    const int2* __restrict__ ent1,    // (E1,) (in1, e1 | spill bit)
    const int* __restrict__ cols2,    // (N2,) output column per position
    const int* __restrict__ cnt2,     // (N2,) entries per position
    const int* __restrict__ sptr2,    // (ceil(N2 / 32),) warp slice starts
    const int2* __restrict__ ent2,    // sliced (in2, e2 | spill bit)
    float* __restrict__ Y,            // (N1, N2, C)
    Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int i1 = rows1[blockIdx.x];
  const int c0 = blockIdx.y * kChunk;
  const int n = min(NC, g.C - c0);
  const int lo = ptr1[i1];
  const int hi = g.E2 > 0 ? ptr1[i1 + 1] : lo;
  const long long row_elems = (long long)g.N2 * g.C;
  const int buf = g.ke_bytes + g.x_bytes;

  for (int t0 = 0; t0 < g.N2; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const bool live = t < g.N2;
    const int cnt = live ? cnt2[t] : 0;
    const int2* ent = ent2 + (live ? sptr2[t >> 5] + (t & 31) : 0);
    float acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = 0.0f;

    auto load = [&](int k, int slot) {
      const int2 u = ent1[k];
      unsigned char* s = smem + slot * buf;
      stage(s, reinterpret_cast<const unsigned char*>(
                   Ke + (long long)(u.y & kSpill) * g.ke_stride),
            4 * g.E2);
      stage_x(s + g.ke_bytes, X + (long long)u.x * row_elems, g);
      __pipeline_commit();
    };
    if (kStage && lo < hi) load(lo, 0);
    for (int k = lo; k < hi; ++k) {
      const int2 u = ent1[k];
      const bool keep1 = u.y >= 0;
      if constexpr (kStage) {
        if (k + 1 < hi) {
          load(k + 1, (k + 1 - lo) & 1);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();               // this pair has landed for everyone
        const unsigned char* s = smem + ((k - lo) & 1) * buf;
        edge_terms<XT, NC>(reinterpret_cast<const float*>(s),
                           reinterpret_cast<const XT*>(s + g.ke_bytes), ent,
                           cnt, g.xs, n, keep1, acc);
        __syncthreads();               // read before the buffer is reused
      } else {
        edge_terms<XT, NC>(Ke + (long long)(u.y & kSpill) * g.ke_stride,
                           X + (long long)u.x * row_elems + c0, ent, cnt,
                           g.C, n, keep1, acc);
      }
    }
    if (kStage && g.N2 <= (int)blockDim.x) {
      // one tile holds the whole row: the sums go to shared memory by
      // column, then the block writes the row contiguously (a thread's
      // cell lies anywhere in the row: written directly, 17 scalar stores
      // of a lane each touch their own sector)
      __syncthreads();
      float* row = reinterpret_cast<float*>(smem);   // node stride g.ts
      if (live) {
        float* r = row + (long long)cols2[t] * g.ts;
#pragma unroll
        for (int k = 0; k < NC; ++k)
          if (k < n) r[k] = acc[k];
      }
      __syncthreads();
      const long long base = (long long)i1 * row_elems;
      for (int i = threadIdx.x; i < row_elems; i += blockDim.x) {
        const int col = div_by(i, g.C, g.magic);
        Y[base + i] = fmaf(Kp[(long long)i1 * g.N2 + col],
                           to_f32(X[base + i]), row[i + col * (g.ts - g.C)]);
      }
      continue;
    }
    if (!live) continue;
    const long long cell = (long long)i1 * g.N2 + cols2[t];
    const float kp = Kp[cell];
    const XT* xo = X + cell * g.C + c0;
    float* yo = Y + cell * g.C + c0;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < n) yo[k] = fmaf(kp, to_f32(xo[k]), acc[k]);
  }
}

template <typename XT, int NC, bool kStage>
int launch_nc(const void* X, const void* Kp, const void* Ke,
              const void* const* tabs, void* Y, const Geom& g, dim3 grid,
              int threads, int smem, cudaStream_t stream) {
  auto kern = assoc_univ_v3_kernel<XT, NC, kStage>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, stream>>>(
      (const XT*)X, (const float*)Kp, (const float*)Ke, (const int*)tabs[0],
      (const int*)tabs[1], (const int2*)tabs[2], (const int*)tabs[3],
      (const int*)tabs[4], (const int*)tabs[5], (const int2*)tabs[6],
      (float*)Y, g);
  return (int)cudaGetLastError();
}

int pad16(long long bytes) { return (int)((bytes + 15) / 16 * 16); }

unsigned magic_of(int d) {
  return d > 1 ? (unsigned)((0x100000000ULL + d - 1) / d) : 0u;
}

template <typename XT>
int launch(const void* X, const void* Kp, const void* Ke,
           const void* const* tabs, void* Y, int N1, int N2, int C, int E1,
           int E2, long long ke_stride, void* stream) {
  if (N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  if (E1 < 0 || E2 < 0) return (int)cudaErrorInvalidValue;
  Geom g{N1, N2, C, E1, E2, ke_stride};
  const int node = C * (int)sizeof(XT);          // bytes of a node's values
  const bool aligned = (reinterpret_cast<unsigned long long>(X) & 3) == 0;
  g.nw = node % 8 == 0 && aligned ? node / 4 : 0;   // 4-byte copies
  g.xs = g.nw ? (node + 4) / (int)sizeof(XT) : C;
  g.ts = C % 2 == 0 ? C + 1 : C;
  g.magic = magic_of(C);
  g.wmagic = magic_of(g.nw);
  // the shape rule between the two instantiations
  g.ke_bytes = pad16(4LL * E2);
  g.x_bytes = pad16((long long)N2 * g.xs * sizeof(XT));
  long long smem = 2LL * (g.ke_bytes + g.x_bytes);
  if (4LL * N2 * g.ts > smem) smem = 4LL * N2 * g.ts;   // the epilogue's row
  const bool staged = C <= kChunk && smem <= kStageBytes;
  if (!staged) smem = g.ke_bytes = g.x_bytes = 0;
  const int chunks = (C + kChunk - 1) / kChunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)N1, (unsigned)chunks);
  const int threads = N2 < kTile ? (N2 + 31) / 32 * 32 : kTile;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = C == 1 ? 1 : (C < kChunk ? (C + 3) / 4 * 4 : kChunk);
#define FPM_NC(NCV)                                                         \
  if (nc == NCV)                                                            \
    return staged ? launch_nc<XT, NCV, true>(X, Kp, Ke, tabs, Y, g, grid,   \
                                             threads, (int)smem, s)         \
                  : launch_nc<XT, NCV, false>(X, Kp, Ke, tabs, Y, g, grid,  \
                                              threads, 0, s);
  FPM_NC(1) FPM_NC(4) FPM_NC(8) FPM_NC(12) FPM_NC(16) FPM_NC(20) FPM_NC(24)
  FPM_NC(28) FPM_NC(32)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of the
// launch (0 = success); nothing synchronises and nothing is allocated here.
// The seven tables are rows1, ptr1, ent1, cols2, cnt2, sptr2, ent2.
#define FPM_UNIV_V3_ARGS                                                      \
  const void *X, const void *Kp, const void *Ke, const void *rows1,           \
      const void *ptr1, const void *ent1, const void *cols2,                  \
      const void *cnt2, const void *sptr2, const void *ent2, void *Y, int N1, \
      int N2, int C, int E1, int E2, long long ke_stride, void *stream

extern "C" int fpm_assoc_univ_v3_f32(FPM_UNIV_V3_ARGS) {
  const void* tabs[7] = {rows1, ptr1, ent1, cols2, cnt2, sptr2, ent2};
  return launch<float>(X, Kp, Ke, tabs, Y, N1, N2, C, E1, E2, ke_stride,
                       stream);
}

extern "C" int fpm_assoc_univ_v3_bf16(FPM_UNIV_V3_ARGS) {
  const void* tabs[7] = {rows1, ptr1, ent1, cols2, cnt2, sptr2, ent2};
  return launch<__nv_bfloat16>(X, Kp, Ke, tabs, Y, N1, N2, C, E1, E2,
                               ke_stride, stream);
}

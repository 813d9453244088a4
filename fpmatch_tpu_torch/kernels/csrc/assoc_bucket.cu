// Batched association matvec for Hopper (sm_90a): the bucket-scale kernel
// (K2: a warp per row tile, channels in registers) and the kernel for pairs
// of any size (K3: a block per output row, (Ke row, X row) pairs streamed
// through shared memory). Both add the Kp term themselves.
//
// They replace the TPU Pallas kernels of fpmatch_tpu/kernels/assoc_pallas.py:
// `_kernel` (reached through assoc_matvec_pallas) and `_kernel_large`
// (reached through assoc_matvec_pallas_large). Same function, same contract:
//
//   Y[b,a,j,c] = Kp[b,a,j] * X[b,a,j,c]
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
// channel is far below what those bytes allow).
//
// K2 (bucket scale). A warp owns (sample b, output row a, a tile of columns,
// a chunk of up to 32 channels). It stages the row's run of (e1, in1) in
// shared memory, 32 entries at a time (so any degree runs, with no block
// barrier). Its lanes own cells: L = ceil(min(C, 32) / NC) lanes per cell, NC
// channels of the cell in registers each, gathered straight from global
// memory / L2 (a batch of X is a few MB) as 16-byte vectors where C and the
// alignment allow; otherwise two lanes share a cell, each holding half of
// min(C, 32) channels rounded up to even (NC = 10 at C = 17; 1 at C = 1;
// kernels/_cells.py::bucket_tiling), so a lane carries a dead channel or
// two at most. Each Ke value is read once per term for
// all channels. `Kp * X` is added last and the cell is written once. Shared
// memory does not depend on N2 or C, so every width runs. No cp.async / TMA /
// tensor cores.
//
// K2 with bf16 X works on channel pairs. The cell's values are read as
// 32-bit words (two channels each; where the cell starts in a word's upper
// half, one byte permute per pair realigns them, and only words that hold a
// live channel are read), Ke is rounded to bf16 once per term into both
// halves of a word, and one packed bf16 multiply (`__hmul2`, round to
// nearest) forms bf16(bf16(Ke) x) for two channels; the two products widen
// to f32 by a shift and a mask and are added to the f32 sums in the same
// order as before. So each term costs one multiply per two channels instead
// of a multiply, a conversion to bf16 and back per channel, and the result is
// the same bits as the per-channel form.
//
// K3 (any size; the layout of csrc/assoc_univ_v3.cu, batched). A block owns
// (output row a, sample b, a slice of up to 32 channels) and walks the row's
// graph-1 run in order. For each edge e1 it streams the contiguous Ke row
// Ke[b, e1, :E2] and the X row X[b, in1(e1), :, :] into shared memory with
// cp.async, double-buffered (the next pair loads while this one is summed),
// so Ke crosses DRAM once and each X row comes from L2 (a sample's X is a few
// MB); a staged node whose values are an even number of words is padded by
// one word, so a warp's gathers spread over the banks. A thread owns output
// column j with the slice's channels in registers and walks its graph-2 run
// (order2 / ins2 from L1): per term one index pair and one Ke value from
// shared memory for all channels. The epilogue puts the row's sums into
// shared memory by column, adds `Kp * X` (f32, after the edge sum, as the JAX
// wrapper does) and writes the row contiguously. Nothing has to fit: where
// two stages and that row exceed the budget, or the row is wider than a
// block, a second instantiation reads Ke and X from global memory / L2,
// tiles the columns and writes from registers. The shape rule lives in
// kernels/assoc_bucket.py::large_geometry, which fills `LargeGeom`. What is
// left between K3 and its byte bound: at C = 1 each block's serial walk over
// its graph-1 edges, a Ke row from DRAM per step; at C > 1 each term's C
// words of X gathered from shared memory at unrelated banks (40 % of the
// time at C = 17 by a diagnostic build), and each X row crossing L2 once per
// graph-1 edge (B E1 N2 C values in all). No TMA / tensor cores.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace {

using fpm_common::div_by;
using fpm_common::hi_f32;
using fpm_common::lo_f32;
using fpm_common::load_channels;
using fpm_common::load_pairs;
using fpm_common::magic_of;
using fpm_common::mul_bf16x2;
using fpm_common::round_bf16;
using fpm_common::splat_bf16;
using fpm_common::stage;
using fpm_common::stage_padded;
using fpm_common::store_channels;
using fpm_common::to_f32;

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

// The NP channel pairs of one cell of bf16 X in global memory as packed
// words: whole 16-byte vectors with kVec (the launcher checked C and the
// alignment), else `load_pairs` (the words that hold one of the n live
// channels).
template <int NP, bool kVec>
__device__ __forceinline__ void load_pair_words(const __nv_bfloat16* p, int n,
                                                unsigned (&w)[NP]) {
  if constexpr (kVec) {
    static_assert(NP % 4 == 0, "whole 16-byte vectors");
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < NP / 4; ++k) {
      const uint4 u = __ldg(v + k);
      w[4 * k] = u.x;
      w[4 * k + 1] = u.y;
      w[4 * k + 2] = u.z;
      w[4 * k + 3] = u.w;
    }
  } else {
    load_pairs<NP, true>(p, n, w);
  }
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
  // bf16 X with an even number of channels a lane: packed pairs
  constexpr bool kPairs =
      std::is_same<XT, __nv_bfloat16>::value && NC % 2 == 0;
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
        if constexpr (kPairs) {
          // bf16(bf16(Ke) x) for two channels per packed multiply
          const unsigned kk = splat_bf16(kc[(long long)u.x * g.E2]);
          unsigned w[NC / 2];
          load_pair_words<NC / 2, kVec>(xc + (long long)u.y * rowX, nc, w);
#pragma unroll
          for (int k = 0; k < NC / 2; ++k) {
            const unsigned t = mul_bf16x2(kk, w[k]);
            acc[2 * k] += lo_f32(t);
            acc[2 * k + 1] += hi_f32(t);
          }
        } else {
          const float kv = ke_for<XT>(kc[(long long)u.x * g.E2]);
          float x[NC];
          load_channels<XT, NC, kVec>(xc + (long long)u.y * rowX, nc, x);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[c] = add_term<XT>(kv, x[c], acc[c]);
        }
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
  // bucket_tiling's counts (1, or half of min(C, 32) rounded up to even)
  FPM_NC(1, false) FPM_NC(2, false) FPM_NC(4, false) FPM_NC(6, false)
  FPM_NC(8, false) FPM_NC(10, false) FPM_NC(12, false) FPM_NC(14, false)
  FPM_NC(16, false)
  FPM_NC(16 / (int)sizeof(XT), true)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- any size
// The launch geometry of K3, computed by kernels/assoc_bucket.py::
// large_geometry (the one place of the shape rule) and passed as kGeomInts
// ints in this order; the magics are derived here.
struct LargeGeom {
  int B, N1, N2, C, E1, E2;
  int cb;                        // channels per grid slice (<= 32)
  int chunks;                    // grid slices: ceil(C / cb)
  int nc;                        // channels a thread holds (instantiation)
  int threads;                   // per block: columns per tile
  int staged;                    // 1: stream through shared memory
  int xs;                        // elements per staged node
  int nw;                        // words per node when padded (0: as it is)
  int ts;                        // floats per node of the epilogue's row
  int ke_bytes, x_bytes;         // one staged Ke row / X row, 16-byte padded
  int smem;                      // dynamic shared memory of a block
  unsigned magic, magic_last, wmagic;   // ceil(2^32 / d) for d = cb, the
                                        // last slice's width, nw
};
constexpr int kGeomInts = 17;
static_assert(offsetof(LargeGeom, magic) == kGeomInts * sizeof(int),
              "the ints large_geometry passes come first, in order");
constexpr int kLargeTile = 640;       // most threads of a block
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory

// X[b, in1, :, :] (N2 nodes of C values) into a staged row: as it is, or
// word by word with one word of padding after each node (LargeGeom::nw).
template <typename XT>
__device__ __forceinline__ void stage_x(unsigned char* dst, const XT* src,
                                        const LargeGeom& g) {
  if (g.nw == 0) {
    stage(dst, reinterpret_cast<const unsigned char*>(src),
          (int)((long long)g.N2 * g.C * sizeof(XT)));
    return;
  }
  stage_padded(dst, reinterpret_cast<const unsigned char*>(src), g.N2, g.nw,
               g.wmagic);
}

// With one channel a cell's graph-2 run is read once per column tile: its
// first eight entries (the Ke offset e2 and the X offset in2 * xs; 0 past
// the run) stay in registers for every graph-1 edge of the row, so the
// cached terms' shared-memory loads issue together instead of each waiting
// for its index from L1 (kernel alone at B=2 / N=256 / E=1536 0.0226 ->
// 0.0185 ms, at B=1 / N=600 / E=3840 0.0565 -> 0.0490 in bf16; H100,
// scripts/time_assoc_large.py). With more channels the registers are worth
// more as accumulators (caching there was slower) and the entries are read
// from L1 per term.
template <int NC>
constexpr int kCacheOf = NC == 1 ? 8 : 0;
template <int KC>
using Cache = int[KC > 0 ? KC : 1];

// The terms of one graph-1 edge for one cell: its graph-2 run (cnt entries,
// the first KC of them in ce / cx, the rest read from L1 at p_lo), each Ke
// value read once for all n channels; x_row is offset to the slice.
template <typename XT, int NC, int KC>
__device__ __forceinline__ void large_terms(
    const float* ke_row, const XT* x_row, const Cache<KC>& ce,
    const Cache<KC>& cx, int cnt, const int* __restrict__ ord2,
    const int* __restrict__ in2, int p_lo, int xs, int n,
    float (&acc)[NC]) {
  static_assert(KC == 0 || NC == 1, "cached entries are for one channel");
#pragma unroll
  for (int q = 0; q < KC; ++q) {
    // no branch: the cached terms' loads issue together (an entry past the
    // run reads element 0 and the select drops it)
    const float t = add_term<XT>(ke_for<XT>(ke_row[ce[q]]),
                                 to_f32(x_row[cx[q]]), acc[0]);
    acc[0] = q < cnt ? t : acc[0];
  }
  for (int p = p_lo + KC; p < p_lo + cnt; ++p) {
    const float kv = ke_for<XT>(ke_row[__ldg(ord2 + p)]);
    const XT* xp = x_row + (long long)__ldg(in2 + p) * xs;
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < n) acc[k] = add_term<XT>(kv, to_f32(xp[k]), acc[k]);
  }
}

// Blocks per SM: up to 20 channels two blocks share an SM (48 registers, a
// few spilled at 20): at B=1 / N=600 two rows of 608 threads, at B=2 /
// N=256 all 512 blocks in one wave (kernel alone at C=17 0.215 -> 0.199 and
// 0.0751 -> 0.0709 ms; H100, scripts/time_assoc_large.py). Above 20 the
// accumulators need the registers.
template <typename XT, int NC, bool kStage>
__global__ void __launch_bounds__(kLargeTile, NC <= 20 ? 2 : 1)
    assoc_large_kernel(
    const XT* __restrict__ X,        // (B, N1, N2, C)
    const float* __restrict__ Kp,    // (B, N1, N2)
    const float* __restrict__ Ke,    // (B, E1, E2)
    const int* __restrict__ order1, const int* __restrict__ ins1,
    const int* __restrict__ offs1, const int* __restrict__ order2,
    const int* __restrict__ ins2, const int* __restrict__ offs2,
    float* __restrict__ Y,           // (B, N1, N2, C)
    LargeGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int a = blockIdx.x;
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * g.cb;
  const int n = min(g.cb, g.C - c0);         // channels of this slice
  const long long row_elems = (long long)g.N2 * g.C;
  const XT* Xb = X + (long long)b * g.N1 * row_elems;
  const float* Keb = Ke + (long long)b * g.E1 * g.E2;
  const int* ord1 = order1 + (long long)b * g.E1;
  const int* in1 = ins1 + (long long)b * g.E1;
  const int* ord2 = order2 + (long long)b * g.E2;
  const int* in2 = ins2 + (long long)b * g.E2;
  const int* of2 = offs2 + (long long)b * (g.N2 + 1);
  const int lo = offs1[(long long)b * (g.N1 + 1) + a];
  const int hi = g.E2 > 0 ? offs1[(long long)b * (g.N1 + 1) + a + 1] : lo;
  const long long cell0 = ((long long)b * g.N1 + a) * g.N2;
  const int buf = g.ke_bytes + g.x_bytes;

  for (int t0 = 0; t0 < g.N2; t0 += blockDim.x) {
    const int j = t0 + threadIdx.x;
    const bool live = j < g.N2;
    const int p_lo = live ? of2[j] : 0;
    const int cnt = live ? of2[j + 1] - p_lo : 0;
    constexpr int KC = kCacheOf<NC>;
    Cache<KC> ce, cx;
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      ce[q] = q < cnt ? __ldg(ord2 + p_lo + q) : 0;
      cx[q] = q < cnt ? __ldg(in2 + p_lo + q) * g.xs : 0;
    }
    float acc[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[k] = 0.0f;

    auto load = [&](int k) {
      unsigned char* s = smem + ((k - lo) & 1) * buf;
      stage(s, reinterpret_cast<const unsigned char*>(
                   Keb + (long long)ord1[k] * g.E2),
            4 * g.E2);
      stage_x(s + g.ke_bytes, Xb + (long long)in1[k] * row_elems, g);
      __pipeline_commit();
    };
    if (kStage && lo < hi) load(lo);
    for (int k = lo; k < hi; ++k) {
      if constexpr (kStage) {
        // two buffers: the next edge's pair loads while this one is summed
        if (k + 1 < hi) {
          load(k + 1);
          __pipeline_wait_prior(1);
        } else {
          __pipeline_wait_prior(0);
        }
        __syncthreads();               // this pair has landed for everyone
        const unsigned char* s = smem + ((k - lo) & 1) * buf;
        large_terms<XT, NC, KC>(
            reinterpret_cast<const float*>(s),
            reinterpret_cast<const XT*>(s + g.ke_bytes) + c0, ce, cx, cnt,
            ord2, in2, p_lo, g.xs, n, acc);
        __syncthreads();               // read before the buffer is reused
      } else {
        large_terms<XT, NC, KC>(Keb + (long long)ord1[k] * g.E2,
                                Xb + (long long)in1[k] * row_elems + c0, ce,
                                cx, cnt, ord2, in2, p_lo, g.xs, n, acc);
      }
    }
    if constexpr (kStage) {
      // one tile holds the whole row (the shape rule): the sums go to
      // shared memory by column, then the block adds Kp X and writes the
      // slice of the row contiguously
      __syncthreads();
      float* row = reinterpret_cast<float*>(smem);   // node stride g.ts
      if (live) {
        float* r = row + (long long)j * g.ts;
#pragma unroll
        for (int k = 0; k < NC; ++k)
          if (k < n) r[k] = acc[k];
      }
      __syncthreads();
      const unsigned magic = n == g.cb ? g.magic : g.magic_last;
      const int cells = g.N2 * n;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const int col = div_by(i, n, magic);
        const int k = i - col * n;
        const long long y = (cell0 + col) * g.C + c0 + k;
        Y[y] = __fadd_rn(row[col * g.ts + k],
                         __fmul_rn(Kp[cell0 + col], to_f32(X[y])));
      }
    } else if (live) {
      const long long y = (cell0 + j) * g.C + c0;
      const float kp = Kp[cell0 + j];
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (k < n)
          Y[y + k] = __fadd_rn(acc[k], __fmul_rn(kp, to_f32(X[y + k])));
    }
  }
}

template <typename XT, int NC, bool kStage>
int launch_large_nc(const void* X, const void* Kp, const void* Ke,
                    const void* const* plan, void* Y, const LargeGeom& g,
                    cudaStream_t stream) {
  auto kern = assoc_large_kernel<XT, NC, kStage>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)g.N1, (unsigned)g.B, (unsigned)g.chunks);
  kern<<<grid, g.threads, g.smem, stream>>>(
      (const XT*)X, (const float*)Kp, (const float*)Ke, (const int*)plan[0],
      (const int*)plan[1], (const int*)plan[2], (const int*)plan[3],
      (const int*)plan[4], (const int*)plan[5], (float*)Y, g);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_large(const void* X, const void* Kp, const void* Ke,
                 const void* const* plan, void* Y, const int* geom,
                 int n_geom, void* stream) {
  if (n_geom != kGeomInts) return (int)cudaErrorInvalidValue;
  LargeGeom g;
  std::memcpy(&g, geom, kGeomInts * sizeof(int));
  if (g.B <= 0 || g.N1 <= 0 || g.N2 <= 0 || g.C <= 0) return (int)cudaSuccess;
  // what the kernel relies on; large_geometry never breaks it
  const bool ok =
      g.E1 >= 0 && g.E2 >= 0 && g.cb >= 1 && g.cb <= 32 &&
      g.chunks == (g.C + g.cb - 1) / g.cb && g.chunks <= 65535 &&
      g.B <= 65535 && g.nc >= g.cb && g.threads >= 32 &&
      g.threads <= kLargeTile && g.threads % 32 == 0 && g.smem >= 0 &&
      g.smem <= kMaxSmem &&
      (!g.staged ||
       (g.N2 <= g.threads && g.ts >= g.cb &&
        4LL * g.N2 * g.ts <= g.smem && g.ke_bytes >= 4LL * g.E2 &&
        g.x_bytes >= (long long)g.N2 * g.xs * (long long)sizeof(XT) &&
        g.xs >= g.C && 2LL * (g.ke_bytes + g.x_bytes) <= g.smem &&
        g.ke_bytes % 16 == 0 && g.x_bytes % 16 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  const int last = g.C - (g.chunks - 1) * g.cb;
  g.magic = magic_of(g.cb);
  g.magic_last = magic_of(last);
  g.wmagic = magic_of(g.nw);
  cudaStream_t s = (cudaStream_t)stream;
#define FPM_NC(NCV)                                                          \
  if (g.nc == NCV)                                                           \
    return g.staged ? launch_large_nc<XT, NCV, true>(X, Kp, Ke, plan, Y, g, \
                                                     s)                      \
                    : launch_large_nc<XT, NCV, false>(X, Kp, Ke, plan, Y, g, \
                                                      s);
  FPM_NC(1) FPM_NC(4) FPM_NC(8) FPM_NC(12) FPM_NC(16) FPM_NC(20) FPM_NC(24)
  FPM_NC(28) FPM_NC(32)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
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
  const void *X, const void *Kp, const void *Ke, const void *order1,          \
      const void *ins1, const void *offs1, const void *order2,                \
      const void *ins2, const void *offs2, void *Y, const int *geom,          \
      int n_geom, void *stream

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
  const void* plan[6] = {order1, ins1, offs1, order2, ins2, offs2};
  return launch_large<float>(X, Kp, Ke, plan, Y, geom, n_geom, stream);
}

extern "C" int fpm_assoc_large_bf16(FPM_LARGE_ARGS) {
  const void* plan[6] = {order1, ins1, offs1, order2, ins2, offs2};
  return launch_large<__nv_bfloat16>(X, Kp, Ke, plan, Y, geom, n_geom,
                                     stream);
}

// Blocked UNIV-scale association matvec for Hopper (sm_90a): the whole
// assoc_matvec_univ in one launch (kept terms of the 3 x 3 locality window,
// spilled terms and Kp * X).
//
// Replaces the TPU Pallas kernel fpmatch_tpu/kernels/assoc_univ.py::
// _univ_kernel (reached through _univ_pallas from assoc_matvec_univ) and the
// XLA spill terms that wrapper adds. Same function over the same host plan
// (kernels/assoc_univ.py::plan_univ): nodes sorted along x, graph 1 cut into
// row blocks of R1 nodes, graph 2 into column blocks of R2, each kept edge
// filed under the block of its scatter endpoint with its gather endpoint in
// the 3-block window around it. For the cell (sorted row as, sorted column
// bs) and channel c, with a = perm1[as], b = perm2[bs] the original nodes:
//
//   Y[a, b, c] = kept + spill + Kp[a, b] X[a, b, c]
//   kept  = sum_{p in run1(as)} sum_{q in run2(bs)} KeR[i B1 + p, j B2 + q]
//                                                  X[g1(p), g2(q), c]
//   spill = sum over (spilled e1 at as) x (every e2 at bs)
//         + sum over (kept e1 at as) x (spilled e2 at bs)  of Ke[e1, e2] X[..]
//
// Runs are in the order UnivPlan.to built them: the kept slots of a block by
// local scatter row / column (`blk`: slot, original gather node; `offs`), the
// spilled and kept lists by sorted scatter node over the whole graph (offs,
// (edge id, original gather node)). A spilled e1 meets every e2 and a kept e1
// only the spilled e2, so each association edge is counted once. X is read in
// its own (N1, N2, C) layout through the original gather nodes: no sorted or
// halo copy. Types, as the JAX wrapper computes: f32 X with f32 KeR
// ("highest"); f32 X rounded to bf16 where it is loaded for the kept terms
// with bf16 KeR ("default"; spill and Kp terms unrounded); bf16 X with bf16
// KeR, the kept sum rounded to bf16 (JAX scatters it into zeros_like(X)) and
// each spilled product bf16(X) * bf16(Ke) rounded to bf16 (JAX multiplies
// them in X's dtype), sums in f32. Order fixed (kept runs, spill runs, Kp
// term), no atomics: two launches give the same bits. Pad slots are in no
// run; cells beyond n1 / n2 are not written.
//
// Bound: memory bytes (X, Kp, Ke and Y once; 2 flops per association edge and
// channel is far below what those bytes allow). Design: a thread owns NC
// channels of one cell in registers and L = ceil(min(C, 32) / NC) lanes
// share the cell (channel chunks of 32 above C = 32), so each KeR / Ke value
// is read once per term, not once per channel, and a term's channels are
// 16-byte loads where C and the alignment allow (NC = 4 f32 / 8 bf16),
// otherwise scalar loads by one thread that holds all of the cell's (up to
// 32) channels (NC = 32; NC = 1 at C = 1). A
// block holds a sub-tile of ra rows x cb columns of one (row block, column
// block) tile and stages only those rows' and columns' run entries in shared
// memory (at most B1 + B2 entries of 8 bytes). The spill lists and X are
// read through L1 / L2. No cp.async / TMA / tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using fpm_common::load_channels;
using fpm_common::round_bf16;
using fpm_common::store_channels;
using fpm_common::to_f32;

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

struct Runs {                          // a CSR over sorted scatter nodes
  const int* offs;                     // (n + 1)
  const int2* ent;                     // (edge id, original gather node)
};

struct Geom {
  int N1, N2, C, E2, J, R1, R2, B1, B2;
  int L, CH, ra, cb, nsub_c, nsub;
};

// acc += sum over r1's run at row `as` x r2's run at column `bs` of
// Ke[e1, e2] X[g1, g2, c0 ..]: f32 products (fma), or for bf16 X the
// product of the bf16 values rounded to bf16
template <typename XT, int NC, bool kVec>
__device__ __forceinline__ void cross(float (&acc)[NC], Runs r1, int as,
                                      Runs r2, int bs,
                                      const float* __restrict__ Ke, int E2,
                                      const XT* __restrict__ X, long long rowX,
                                      int C, int nc) {
  const int lo1 = r1.offs[as], hi1 = r1.offs[as + 1];
  if (lo1 == hi1) return;
  const int lo2 = r2.offs[bs], hi2 = r2.offs[bs + 1];
  for (int t1 = lo1; t1 < hi1; ++t1) {
    const int2 u = r1.ent[t1];
    const float* kr = Ke + (long long)u.x * E2;
    const XT* xr = X + (long long)u.y * rowX;
    for (int t2 = lo2; t2 < hi2; ++t2) {
      const int2 v = r2.ent[t2];
      const float kv = kr[v.x];
      float x[NC];
      load_channels<XT, NC, kVec>(xr + (long long)v.y * C, nc, x);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if constexpr (sizeof(XT) == 2)
          acc[c] += round_bf16(x[c] * round_bf16(kv));
        else
          acc[c] = fmaf(kv, x[c], acc[c]);
      }
    }
  }
}

template <typename XT, typename KT, bool kRoundX, int NC, bool kVec>
__global__ void __launch_bounds__(kThreads) assoc_univ_kernel(
    const XT* __restrict__ X,        // (N1, N2, C) original order
    const KT* __restrict__ KeR,      // (I B1, J B2) block-gathered Ke
    const float* __restrict__ Ke,    // (E1, E2)
    const float* __restrict__ Kp,    // (N1, N2)
    const int* __restrict__ perm1,   // (N1) sorted node -> original node
    const int* __restrict__ perm2,
    const int2* __restrict__ blk1,   // (I, B1) kept slots by local row
    const int* __restrict__ offs1,   // (I, R1 + 1)
    const int2* __restrict__ blk2,   // (J, B2)
    const int* __restrict__ offs2,   // (J, R2 + 1)
    Runs spill1, Runs keep1, Runs all2, Runs spill2,
    float* __restrict__ Y,           // (N1, N2, C)
    Geom g) {
  extern __shared__ int2 smem[];
  int2* s1 = smem;            // run entries of the sub-tile's rows (<= B1)
  int2* s2 = smem + g.B1;     // and of its columns (<= B2)

  const int i = blockIdx.z;
  const int j = blockIdx.y;
  const int sub = blockIdx.x % g.nsub;
  const int chunk = blockIdx.x / g.nsub;
  const int a0 = (sub / g.nsub_c) * g.ra;
  const int b0 = (sub % g.nsub_c) * g.cb;
  const int a1 = min(a0 + g.ra, g.R1);
  const int b1 = min(b0 + g.cb, g.R2);
  const int* o1 = offs1 + (long long)i * (g.R1 + 1);
  const int* o2 = offs2 + (long long)j * (g.R2 + 1);
  const int lo1 = o1[a0];
  const int lo2 = o2[b0];
  for (int t = threadIdx.x; t < o1[a1] - lo1; t += blockDim.x)
    s1[t] = blk1[(long long)i * g.B1 + lo1 + t];
  for (int t = threadIdx.x; t < o2[b1] - lo2; t += blockDim.x)
    s2[t] = blk2[(long long)j * g.B2 + lo2 + t];
  __syncthreads();

  const int cell = threadIdx.x / g.L;
  const int lane = threadIdx.x - cell * g.L;
  const int a = a0 + cell / g.cb;
  const int b = b0 + cell % g.cb;
  if (a >= a1 || b >= b1) return;
  const int as = i * g.R1 + a;
  const int bs = j * g.R2 + b;
  if (as >= g.N1 || bs >= g.N2) return;
  const int c0 = chunk * g.CH + lane * NC;
  const int nc = min(NC, min(g.C, (chunk + 1) * g.CH) - c0);
  if (nc <= 0) return;
  const long long rowX = (long long)g.N2 * g.C;
  const XT* Xc = X + c0;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

  // kept terms: run1(a) x run2(b) of this tile
  const long long kes = (long long)g.J * g.B2;
  const KT* ke = KeR + (long long)i * g.B1 * kes + (long long)j * g.B2;
  const int k1e = o1[a + 1] - lo1;
  const int k2b = o2[b] - lo2;
  const int k2e = o2[b + 1] - lo2;
  for (int k1 = o1[a] - lo1; k1 < k1e; ++k1) {
    const int2 p = s1[k1];
    const KT* kr = ke + (long long)p.x * kes;
    const XT* xr = Xc + (long long)p.y * rowX;
    for (int k2 = k2b; k2 < k2e; ++k2) {
      const int2 q = s2[k2];
      const float kv = to_f32(kr[q.x]);
      float x[NC];
      load_channels<XT, NC, kVec>(xr + (long long)q.y * g.C, nc, x);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = fmaf(kv, kRoundX ? round_bf16(x[c]) : x[c], acc[c]);
    }
  }
  if constexpr (sizeof(XT) == 2) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = round_bf16(acc[c]);
  }

  // spilled terms, then Kp X
  cross<XT, NC, kVec>(acc, spill1, as, all2, bs, Ke, g.E2, Xc, rowX, g.C, nc);
  cross<XT, NC, kVec>(acc, keep1, as, spill2, bs, Ke, g.E2, Xc, rowX, g.C, nc);
  const long long cy = (long long)perm1[as] * g.N2 + perm2[bs];
  const float kp = Kp[cy];
  float x[NC];
  load_channels<XT, NC, kVec>(Xc + cy * g.C, nc, x);
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] += kp * x[c];
  store_channels<NC, kVec>(Y + cy * g.C + c0, nc, acc);
}

struct Ptrs {
  const void *X, *KeR, *Ke, *Kp, *perm1, *perm2, *blk1, *offs1, *blk2, *offs2;
  Runs spill1, keep1, all2, spill2;
  void* Y;
};

template <typename XT, typename KT, bool kRoundX, int NC, bool kVec>
int launch_nc(const Ptrs& p, const Geom& g, dim3 grid, int threads,
              size_t smem, cudaStream_t stream) {
  auto kernel = assoc_univ_kernel<XT, KT, kRoundX, NC, kVec>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(
      (const XT*)p.X, (const KT*)p.KeR, (const float*)p.Ke,
      (const float*)p.Kp, (const int*)p.perm1, (const int*)p.perm2,
      (const int2*)p.blk1, (const int*)p.offs1, (const int2*)p.blk2,
      (const int*)p.offs2, p.spill1, p.keep1, p.all2, p.spill2, (float*)p.Y,
      g);
  return (int)cudaGetLastError();
}

template <typename XT, typename KT, bool kRoundX>
int launch(const Ptrs& p, int N1, int N2, int C, int E2, int I, int J, int R1,
           int R2, int B1, int B2, int nc, int vec, void* stream) {
  if (N1 <= 0 || N2 <= 0 || C <= 0) return (int)cudaSuccess;
  if (I <= 0 || J <= 0 || R1 <= 0 || R2 <= 0 || B1 <= 0 || B2 <= 0 ||
      I > 65535 || J > 65535 || (long long)I * R1 < N1 ||
      (long long)J * R2 < N2 || nc <= 0 || nc > 32)
    return (int)cudaErrorInvalidValue;
  Geom g{N1, N2, C, E2, J, R1, R2, B1, B2};
  g.CH = C < 32 ? C : 32;                      // channels per chunk
  g.L = (g.CH + nc - 1) / nc;                  // lanes per cell
  const int cells = kThreads / g.L > 0 ? kThreads / g.L : 1;
  g.cb = 1;
  while (g.cb * 2 <= cells && g.cb * 2 <= R2) g.cb *= 2;
  g.ra = cells / g.cb < R1 ? cells / g.cb : R1;
  g.nsub_c = (R2 + g.cb - 1) / g.cb;
  g.nsub = (R1 + g.ra - 1) / g.ra * g.nsub_c;
  const long long gx = (long long)g.nsub * ((C + g.CH - 1) / g.CH);
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int2) * ((size_t)B1 + (size_t)B2);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)J, (unsigned)I);
  const int threads = g.ra * g.cb * g.L;
  cudaStream_t s = (cudaStream_t)stream;
#define FPM_NC(NCV, VECV)                                                    \
  if (nc == NCV && (vec != 0) == VECV)                                       \
    return launch_nc<XT, KT, kRoundX, NCV, VECV>(p, g, grid, threads, smem, s);
  FPM_NC(1, false)
  FPM_NC(32, false)
  FPM_NC(16 / (int)sizeof(XT), true)
#undef FPM_NC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the cudaError_t of the
// launch (0 = success); nothing synchronises and nothing is allocated here.
// `nc` channels per thread: 1 or 32 with scalar loads (only the first
// min(C, 32) are live), or one 16-byte vector with `vec` nonzero: 4 f32 or
// 8 bf16 (C a multiple of nc, X 16-byte aligned: the wrapper checks).
#define FPM_UNIV_ARGS                                                        \
  const void *X, const void *KeR, const void *Ke, const void *Kp,            \
      const void *perm1, const void *perm2, const void *blk1,                \
      const void *offs1, const void *blk2, const void *offs2,                \
      const void *sp1_offs, const void *sp1, const void *kp1_offs,           \
      const void *kp1, const void *al2_offs, const void *al2,                \
      const void *sp2_offs, const void *sp2, void *Y, int N1, int N2, int C, \
      int E2, int I, int J, int R1, int R2, int B1, int B2, int nc, int vec, \
      void *stream
#define FPM_UNIV_PTRS                                                        \
  Ptrs {                                                                     \
    X, KeR, Ke, Kp, perm1, perm2, blk1, offs1, blk2, offs2,                  \
        Runs{(const int*)sp1_offs, (const int2*)sp1},                        \
        Runs{(const int*)kp1_offs, (const int2*)kp1},                        \
        Runs{(const int*)al2_offs, (const int2*)al2},                        \
        Runs{(const int*)sp2_offs, (const int2*)sp2}, Y                      \
  }

extern "C" int fpm_assoc_univ_f32(FPM_UNIV_ARGS) {
  return launch<float, float, false>(FPM_UNIV_PTRS, N1, N2, C, E2, I, J, R1,
                                     R2, B1, B2, nc, vec, stream);
}

extern "C" int fpm_assoc_univ_f32_bf16(FPM_UNIV_ARGS) {
  return launch<float, __nv_bfloat16, true>(FPM_UNIV_PTRS, N1, N2, C, E2, I,
                                            J, R1, R2, B1, B2, nc, vec,
                                            stream);
}

extern "C" int fpm_assoc_univ_bf16(FPM_UNIV_ARGS) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      FPM_UNIV_PTRS, N1, N2, C, E2, I, J, R1, R2, B1, B2, nc, vec, stream);
}

// Masked log-space Sinkhorn on the square bucket for Hopper (sm_90a): the
// whole call of ops/sinkhorn.sinkhorn_batch in one launch, and its gradient
// in one more. It replaces no Pallas kernel: the JAX package leaves the loop
// (fpmatch_tpu/ops/sinkhorn.py:sinkhorn_batch) to XLA, which fuses it under
// jit; the port ran it as ~17 eager ops a sweep (365 launches for 20
// sweeps), each on a few MB, so the card waited on the host's dispatch.
//
// The function (ops/sinkhorn.py's contract): per sample b with valid counts
// (n1, n2), a = min(n1, n2), m = max(n1, n2), and n1 > n2 flipping the
// sample, work in the frame where the short side is the rows (the sample
// read transposed when flipped):
//
//   x[i, j] = s[i, j] / tau       i < a, j < m      (the valid block)
//   x[i, j] = -100                a <= i < m, j < m (the dummy band; only
//                                                    with dummy_row)
//
// over the region R x m (R = m with the dummy band, a without it), then
// `iters` masked logsumexp sweeps, rows on even steps and columns on odd
// ones, each x <- x - lse (an lse that is not finite subtracts 0, an empty
// line is -inf, as masked_logsumexp), and out = exp(x) on the valid block,
// 0 elsewhere, written back in the sample's own frame.
//
// The gradient (fpm_sinkhorn_bwd): ds = dL/ds for dy = dL/dout. It re-runs
// the sweeps, keeping each sweep's subtracted normalizer (iters x S floats),
// then walks them in reverse: g = dy exp(x) on the valid block, and for a
// sweep along a line, whose output is x' = x - lse(x),
//
//   g <- g - exp(x') * sum_line(g)        (exp(x') is softmax(x) on the line)
//   x <- x' + lse                         (the state before the sweep)
//
// and finally ds = g / tau on the valid block, 0 elsewhere. The dummy band
// carries gradient through the sweeps and gets none.
//
// Bound: memory bytes, and far from them. A call reads B S^2 floats and
// writes B S^2 (the backward reads two arrays); at B = 512, S = 64 that is
// 16.8 MB (~5 us at 3.35 TB/s), while 20 sweeps take about 10 flops and an
// exp per entry and sweep: latency of the sweeps' reductions, not bytes or
// flops, sets the time.
//
// Design: a block per sample holds its tile in shared memory for the whole
// call (rows padded to S + 1 floats, so that a warp walking a row or a
// column, and the transposed load of a flipped sample, hit 32 banks); no
// sweep's tile touches device memory. A warp owns up to kQ = 8 lines (rows,
// or columns) of a sweep and walks them at once, so that the shuffles of
// their reductions overlap; each lane holds K = ceil(S / 32) entries of a
// line in registers; max and sum are warp shuffles, sums in f32, expf / logf
// at full precision. Only the region's R x m entries are swept. The backward adds a
// second tile for g and the normalizers (2 S (S + 1) + iters S floats:
// 38 KB at S = 64 and 20 sweeps, 139 KB at S = 128). Counts are read in
// place (int32 or int64, any stride) and scores and dy at any strides, so a
// call launches nothing else. kernels/sinkhorn.py::sinkhorn_geometry is the
// shape rule (threads, K, shared memory). No atomics: two launches give the
// same bits.

#include "common.cuh"

#include <math.h>
#include <string.h>

namespace {

constexpr float kDummyLog = -100.0f;
constexpr unsigned kFull = 0xffffffffu;
// lines a warp walks at once (kernels/sinkhorn.py::LINES_PER_WARP)
constexpr int kQ = 8;
// threads of a block at S = 128 (16 warps): at most 128 registers a thread
constexpr int kMaxThreads = 512;

// geometry, as kernels/sinkhorn.py::SinkhornGeom passes it (int64 each)
struct Geom {
  long long B, S, iters, dummy, threads, vals, smem_fwd, smem_bwd;
  long long s_b, s_r, s_c;       // strides of the scores
  long long d_b, d_r, d_c;       // strides of dy (backward)
  long long n1_stride, n1_wide;  // counts: element stride, 1 for int64
  long long n2_stride, n2_wide;
};
constexpr int kGeomLen = sizeof(Geom) / sizeof(long long);

// a launch's arguments, passed to the kernel by value
struct Args {
  const float* s;
  const float* dy;
  const void* n1;
  const void* n2;
  float* out;
  float tau;
  Geom g;
};

// warp-wide max / sum of kQ independent values at once, so that their
// shuffles overlap
template <int N>
__device__ __forceinline__ void warp_max(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = fmaxf(v[q], __shfl_xor_sync(kFull, v[q], o));
}

template <int N>
__device__ __forceinline__ void warp_sum(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] += __shfl_xor_sync(kFull, v[q], o);
}

__device__ __forceinline__ long long count_at(const void* p, long long stride,
                                              int wide, int b) {
  return wide ? static_cast<const long long*>(p)[b * stride]
              : (long long)static_cast<const int*>(p)[b * stride];
}

// One sample in its working frame: the valid block is rows [0, a) x cols
// [0, m), the region rows [0, R) x cols [0, m); r1 x c1 is the valid block
// in the sample's own frame.
struct Frame {
  int a, m, R, r1, c1;
  bool flip;
};

__device__ __forceinline__ Frame frame_of(const Args& a, int b) {
  const Geom& g = a.g;
  const long long n1 = count_at(a.n1, g.n1_stride, (int)g.n1_wide, b);
  const long long n2 = count_at(a.n2, g.n2_stride, (int)g.n2_wide, b);
  const auto clip = [&](long long n) {
    return (int)(n < 0 ? 0 : (n > g.S ? g.S : n));
  };
  Frame f;
  f.flip = n1 > n2;
  f.r1 = clip(n1);
  f.c1 = clip(n2);
  f.a = f.flip ? f.c1 : f.r1;
  f.m = f.flip ? f.r1 : f.c1;
  f.R = g.dummy ? f.m : f.a;
  return f;
}

// the working-frame position of the sample's own (i, j)
__device__ __forceinline__ int at(const Frame& f, int P, int i, int j) {
  return f.flip ? j * P + i : i * P + j;
}

// x over the region: the valid block s / tau (read transposed for a flipped
// sample, coalesced along the sample's own rows), the dummy band -100
__device__ void load_scores(float* x, const Args& a, const Frame& f, int P,
                            int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* __restrict__ s = a.s + b * a.g.s_b;
  for (int i = warp; i < f.r1; i += nw)
    for (int j = lane; j < f.c1; j += 32)
      x[at(f, P, i, j)] = s[i * a.g.s_r + j * a.g.s_c] / a.tau;
  for (int i = f.a + warp; i < f.R; i += nw)
    for (int j = lane; j < f.m; j += 32) x[i * P + j] = kDummyLog;
}

// The lines of a sweep (rows when t is even, columns when odd) over the
// region: warp w owns lines w, w + nw, ... and walks kQ of them at once; lane
// u holds entries u, u + 32, ... (K of them) of each. Entry e of line l is
// x[l * base + e * step].
struct Lines {
  int count, len, base, step;
};

__device__ __forceinline__ Lines lines_of(const Frame& f, int P, int t) {
  return (t & 1) == 0 ? Lines{f.R, f.m, P, 1} : Lines{f.m, f.R, 1, P};
}

// sweep t: each line x <- x - lse (masked_logsumexp's guards: -inf for an
// empty line, a non-finite lse subtracts 0); what each line subtracted into
// norm[line] where norm is given
template <int K>
__device__ void sweep(float* x, float* norm, const Frame& f, int P, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const Lines ln = lines_of(f, P, t);
  for (int l0 = warp; l0 < ln.count; l0 += kQ * nw) {
    float v[kQ][K], mx[kQ], sum[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int l = l0 + q * nw;
      mx[q] = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        v[q][k] = l < ln.count && e < ln.len ? x[l * ln.base + e * ln.step]
                                             : -INFINITY;
        mx[q] = fmaxf(mx[q], v[q][k]);
      }
    }
    warp_max(mx);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      mx[q] = isfinite(mx[q]) ? mx[q] : 0.0f;
      sum[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane + 32 * k < ln.len) sum[q] += expf(v[q][k] - mx[q]);
    }
    warp_sum(sum);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int l = l0 + q * nw;
      if (l >= ln.count) continue;
      const float lse =
          sum[q] > 0.0f ? logf(fmaxf(sum[q], 1e-38f)) + mx[q] : -INFINITY;
      const float sub = isfinite(lse) ? lse : 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        if (e < ln.len) x[l * ln.base + e * ln.step] = v[q][k] - sub;
      }
      if (norm != nullptr && lane == 0) norm[l] = sub;
    }
  }
}

// the adjoint of sweep t on each line: g <- g - exp(x') sum(g), where x' is
// the sweep's output, then (t > 0) x' <- x' + norm[line], the line's state
// before the sweep
template <int K>
__device__ void adjoint(float* x, float* g, const float* norm, const Frame& f,
                        int P, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const Lines ln = lines_of(f, P, t);
  for (int l0 = warp; l0 < ln.count; l0 += kQ * nw) {
    float gv[kQ][K], gs[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int l = l0 + q * nw;
      gs[q] = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        gv[q][k] = l < ln.count && e < ln.len ? g[l * ln.base + e * ln.step]
                                              : 0.0f;
        gs[q] += gv[q][k];
      }
    }
    warp_sum(gs);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int l = l0 + q * nw;
      if (l >= ln.count) continue;
      const float add = t > 0 ? norm[l] : 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int e = lane + 32 * k;
        if (e < ln.len) {
          const int w = l * ln.base + e * ln.step;
          const float xv = x[w];
          g[w] = fmaf(-expf(xv), gs[q], gv[q][k]);
          x[w] = xv + add;
        }
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads) sinkhorn_fwd_kernel(Args a) {
  extern __shared__ float x[];
  const int b = blockIdx.x, S = (int)a.g.S, P = S + 1;
  const Frame f = frame_of(a, b);
  load_scores(x, a, f, P, b);
  __syncthreads();
  for (int t = 0; t < a.g.iters; ++t) {
    sweep<K>(x, nullptr, f, P, t);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float* out = a.out + (long long)b * S * S;
  for (int i = warp; i < S; i += nw)
    for (int j = lane; j < S; j += 32)
      out[i * S + j] =
          i < f.r1 && j < f.c1 ? expf(x[at(f, P, i, j)]) : 0.0f;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads) sinkhorn_bwd_kernel(Args a) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, S = (int)a.g.S, P = S + 1;
  float* x = sm;
  float* gr = sm + S * P;
  float* norms = gr + S * P;
  const Frame f = frame_of(a, b);
  load_scores(x, a, f, P, b);
  __syncthreads();
  for (int t = 0; t < a.g.iters; ++t) {
    sweep<K>(x, norms + t * S, f, P, t);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float* dy = a.dy + b * a.g.d_b;
  for (int i = warp; i < f.r1; i += nw)
    for (int j = lane; j < f.c1; j += 32) {
      const int w = at(f, P, i, j);
      gr[w] = dy[i * a.g.d_r + j * a.g.d_c] * expf(x[w]);
    }
  for (int i = f.a + warp; i < f.R; i += nw)
    for (int j = lane; j < f.m; j += 32) gr[i * P + j] = 0.0f;
  __syncthreads();
  for (int t = (int)a.g.iters - 1; t >= 0; --t) {
    adjoint<K>(x, gr, norms + t * S, f, P, t);
    __syncthreads();
  }
  float* ds = a.out + (long long)b * S * S;
  for (int i = warp; i < S; i += nw)
    for (int j = lane; j < S; j += 32)
      ds[i * S + j] = i < f.r1 && j < f.c1 ? gr[at(f, P, i, j)] / a.tau : 0.0f;
}

template <int K>
cudaError_t launch_k(bool backward, const Args& a, cudaStream_t stream) {
  const Geom& geo = a.g;
  const int smem = (int)(backward ? geo.smem_bwd : geo.smem_fwd);
  const void* fn = backward ? (const void*)sinkhorn_bwd_kernel<K>
                            : (const void*)sinkhorn_fwd_kernel<K>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (backward)
    sinkhorn_bwd_kernel<K><<<(int)geo.B, (int)geo.threads, smem, stream>>>(a);
  else
    sinkhorn_fwd_kernel<K><<<(int)geo.B, (int)geo.threads, smem, stream>>>(a);
  return cudaGetLastError();
}

int launch(bool backward, const void* s, const void* dy, const void* n1,
           const void* n2, void* out, float tau, const long long* geom,
           int n_geom, void* stream) {
  if (n_geom != kGeomLen) return (int)cudaErrorInvalidValue;
  Args a{(const float*)s, (const float*)dy, n1, n2, (float*)out, tau, {}};
  memcpy(&a.g, geom, sizeof(Geom));
  if (a.g.B <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (a.g.vals) {
    case 1: return (int)launch_k<1>(backward, a, st);
    case 2: return (int)launch_k<2>(backward, a, st);
    case 4: return (int)launch_k<4>(backward, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fpm_sinkhorn_fwd(const void* s, const void* n1, const void* n2,
                                void* out, float tau, const long long* geom,
                                int n_geom, void* stream) {
  return launch(false, s, nullptr, n1, n2, out, tau, geom, n_geom, stream);
}

extern "C" int fpm_sinkhorn_bwd(const void* s, const void* dy, const void* n1,
                                const void* n2, void* ds, float tau,
                                const long long* geom, int n_geom,
                                void* stream) {
  return launch(true, s, dy, n1, n2, ds, tau, geom, n_geom, stream);
}

// Shared by every kernel source under csrc/ (each source becomes one shared
// library with its own statically linked CUDA runtime, loaded with ctypes).
//
// fpm_cuda_error_string: the message of a cudaError_t a launch returned.
//
// fpm_inoculate: y = x + 1 over n f32 values. It replaces the TPU Pallas
// kernel fpmatch_tpu/kernels/assoc_pallas.py::inoculate, a trivial kernel run
// once so that a process's first kernel compile comes before anything else.
// Here the compile happens in nvcc ahead of time; what a first launch in a
// library still pays is its own runtime's initialisation and module load, so
// kernels/inoculate.py launches this once in each library before timed work.
// Bound: bytes (8 KB for the (8, 128) tile), i.e. launch latency only.
//
// fpm_common::load_channels / store_channels: the NC channels of one
// association cell that one thread owns, kept in registers. With kVec the NC
// values are whole 16-byte vectors (the caller checked the alignment);
// otherwise they are read one by one and only the first n are live.
//
// fpm_common::load_pairs / mul_bf16x2 / lo_f32 / hi_f32: bf16 values two at a
// time, as packed 32-bit words, for kernels that round each bf16 product as
// the JAX package's bf16 multiply does (one packed multiply per two values
// instead of a multiply, a conversion to bf16 and one back per value).
//
// fpm_common::stage / div_by: the block-wide cp.async copy of a row into
// shared memory and the division by a magic number, shared by the kernels
// that stream rows (K3 in assoc_bucket.cu, K6 in assoc_grad.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace fpm_common {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round to bf16 (nearest, ties to even: torch's .to(torch.bfloat16)) and back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int NC, bool kVec>
__device__ __forceinline__ void load_channels(const T* __restrict__ p, int n,
                                              float (&x)[NC]) {
  if constexpr (kVec) {
    static_assert((NC * sizeof(T)) % 16 == 0, "whole 16-byte vectors");
    constexpr int kPer = 16 / sizeof(T);
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < NC / kPer; ++k) {
      const uint4 u = __ldg(v + k);
      if constexpr (sizeof(T) == 4) {
        x[k * 4 + 0] = __uint_as_float(u.x);
        x[k * 4 + 1] = __uint_as_float(u.y);
        x[k * 4 + 2] = __uint_as_float(u.z);
        x[k * 4 + 3] = __uint_as_float(u.w);
      } else {
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {   // bf16 -> f32 is a 16-bit shift
          x[k * 8 + 2 * h] = __uint_as_float(w[h] << 16);
          x[k * 8 + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k) x[k] = k < n ? to_f32(p[k]) : 0.0f;
  }
}

template <int NC, bool kVec>
__device__ __forceinline__ void store_channels(float* __restrict__ p, int n,
                                               const float (&y)[NC]) {
  if constexpr (kVec && NC % 4 == 0) {
    float4* v = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int k = 0; k < NC / 4; ++k)
      v[k] = make_float4(y[4 * k], y[4 * k + 1], y[4 * k + 2], y[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < NC; ++k)
      if (k < n) p[k] = y[k];
  }
}

// The pairs (2k, 2k + 1), k < NP, of a bf16 vector of n <= 2 NP live values
// at p (global or shared memory), as words with the even value in the low
// half. Only the aligned words that hold a live value are read (the others
// are 0), so nothing past the vector's last value is touched but the rest of
// its word; where p sits in a word's upper half, one byte permute per pair
// realigns them. A pair's upper half past n is whatever the word holds.
template <int NP, bool kLdg>
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p, int n,
                                           unsigned (&w)[NP]) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  const int odd = (int)((a >> 1) & 1);
  const unsigned* q = reinterpret_cast<const unsigned*>(a - 2 * odd);
  const unsigned sel = odd ? 0x5432u : 0x3210u;
  unsigned v[NP + 1];
#pragma unroll
  for (int j = 0; j <= NP; ++j)
    v[j] = 2 * j - odd < n ? (kLdg ? __ldg(q + j) : q[j]) : 0u;
#pragma unroll
  for (int k = 0; k < NP; ++k) w[k] = __byte_perm(v[k], v[k + 1], sel);
}

// bf16(a * b) for both halves of two packed words, rounded to nearest
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  using B2 = __nv_bfloat162;
  const B2 r = __hmul2(*reinterpret_cast<const B2*>(&a),
                       *reinterpret_cast<const B2*>(&b));
  return *reinterpret_cast<const unsigned*>(&r);
}

// both halves of bf16(v) as one packed word
__device__ __forceinline__ unsigned splat_bf16(float v) {
  const __nv_bfloat162 r = __float2bfloat162_rn(v);
  return *reinterpret_cast<const unsigned*>(&r);
}

// the low / high bf16 of a packed word, widened to f32 (exact)
__device__ __forceinline__ float lo_f32(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_f32(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ int div_by(int i, int d, unsigned magic) {
  return d == 1 ? i : (int)__umulhi((unsigned)i, magic);
}

// ceil(2^32 / d), the magic of div_by (0 for d <= 1)
inline unsigned magic_of(int d) {
  return d > 1 ? (unsigned)((0x100000000ULL + d - 1) / d) : 0u;
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

// `nodes` nodes of `nw` 32-bit words each from global memory into shared
// memory with one word of padding after each node (cp.async of 4 bytes;
// wmagic = magic_of(nw)), so that a warp's reads of whole nodes spread over
// the banks.
__device__ __forceinline__ void stage_padded(unsigned char* dst,
                                             const unsigned char* src,
                                             int nodes, int nw,
                                             unsigned wmagic) {
  const int words = nodes * nw;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int j = div_by(i, nw, wmagic);
    __pipeline_memcpy_async(dst + 4 * (i + j), src + 4 * i, 4);
  }
}

__global__ void inoculate_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1.0f;
}

}  // namespace fpm_common

extern "C" int fpm_inoculate(const void* x, void* y, int n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 128;
  fpm_common::inoculate_kernel<<<(n + threads - 1) / threads, threads, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, n);
  return (int)cudaGetLastError();
}

extern "C" const char* fpm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

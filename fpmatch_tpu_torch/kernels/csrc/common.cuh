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

#pragma once

#include <cuda_bf16.h>
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

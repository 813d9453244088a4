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

#pragma once

#include <cuda_runtime.h>

namespace fpm_common {

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

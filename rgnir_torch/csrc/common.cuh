// Shared helpers of the analysis kernels: the C export macro, the error
// string for the ctypes wrappers, float atomics and warp reductions.
// Each kernel source includes this once and builds into its own shared
// library (rgnir_torch/kernels/_build.py), loaded with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RGNIR_EXPORT extern "C" __attribute__((visibility("default")))

// Every C entry returns cudaGetLastError() after its launches; the
// Python wrapper raises with this text when it is not 0.
RGNIR_EXPORT const char* rgnir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Float min/max through integer atomics. A float whose sign bit is
// clear orders like its bits as a signed int; one whose sign bit is set
// orders in reverse of its bits as an unsigned int. Exact, and
// independent of the order in which blocks arrive.
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (!signbit(v)) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The 24-bit quantized order key of an index value v in [-1, 1]:
// min(floor((v + 1) * 2^23), 2^24 - 1). The add is rounded once, the
// power-of-two scale is exact, and the float-to-int conversion
// truncates, which is the floor here. Its top byte is the render byte
// min(floor((v + 1) * 128), 255).
__device__ __forceinline__ int q24_key(float v) {
  return min(static_cast<int>(__fmul_rn(__fadd_rn(v, 1.0f), 8388608.0f)),
             16777215);
}

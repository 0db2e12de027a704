// Shared helpers of the analysis kernels: the C export macro, the error
// string for the ctypes wrappers, float atomics, warp reductions, the
// q24 key, and the select kernels' row map and tail fold.
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

// The select kernels' row map (the TPU kernels' take_prefix index map):
// the input rows are groups of `group` consecutive rows of which the
// first `take` are selected; selected row bi is input row
// (bi / take) * group + bi % take.
__device__ __forceinline__ long long input_row(long long bi, int group, int take) {
  return (bi / take) * group + bi % take;
}

// Folds each thread's tail partials of one row (least value of the
// winning key, least value above it, sum of squares) into the row's
// outputs: warp shuffles, then one atomic each from thread 0. Every
// thread of the block (Warps warps) must call it.
template <int Warps>
__device__ __forceinline__ void block_fold_tail(float lo, float nx, float s,
                                                float* lohi, double* ss) {
  __shared__ float w_lo[Warps], w_nx[Warps], w_ss[Warps];
  lo = warp_min(lo);
  nx = warp_min(nx);
  s = warp_sum(s);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    w_lo[warp] = lo;
    w_nx[warp] = nx;
    w_ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int wi = 0; wi < Warps; ++wi) {
      lo = fminf(lo, w_lo[wi]);
      nx = fminf(nx, w_nx[wi]);
      total += w_ss[wi];
    }
    atomic_min_f32(lohi, lo);
    atomic_min_f32(lohi + 1, nx);
    atomicAdd(ss, total);
  }
}

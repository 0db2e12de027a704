// The exact median's data passes over index maps: one radix round's
// byte histogram, and the tail pass that recovers the median's value,
// its even-n successor and the centred sum of squares.
//
// Replace rgnir_tpu/kernels/select.py:_byte_hist_kernel (in its "q24"
// key mode) and rgnir_tpu/kernels/select.py:_q24_tail_kernel. The TPU
// kernels read (R, 1024) row blocks, counted through nibble one-hots on
// the MXU and read the per-row prefix from SMEM scalars. Here a block
// reads a contiguous chunk of one row, counts in shared memory, and
// reads its row's prefix, key or mean from device memory: the prefix
// and ranks between rounds stay on the device, so a whole select makes
// no host round trip. Offsets are 64-bit, so rows may exceed 2^31
// elements.
//
// Bound: memory. Each pass reads every selected element once (4 bytes):
// 2 kinds x 8 x 1024^2 elements are 67 MB, about 20 us at 3.35 TB/s.
// The per-element work (one add, one scale, a compare, and for the
// histogram a shared atomic only for the few elements whose higher key
// bits match) is far below the card's rate. Design: a grid of (chunk,
// row) blocks, coalesced loads one element per thread per step; the
// tail's mins and sum go through warp shuffles to one atomic per block.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kElemsPerBlock = 8192;

// 256-bin histogram of key byte (key >> shift) & 255 over the elements
// whose key bits above that byte equal those of the row's prefix.
__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const float* __restrict__ vals, long long n,
                 const int* __restrict__ prefix, int shift,
                 int* __restrict__ out) {
  __shared__ int sh[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) sh[i] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const float* x = vals + row * n;
  const int high = shift + 8;
  const int want = prefix[row] >> high;
  const long long start = static_cast<long long>(blockIdx.x) * kElemsPerBlock;
  const long long end = min(start + kElemsPerBlock, n);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const int key = q24_key(__ldg(x + i));
    if ((key >> high) == want) atomicAdd(&sh[(key >> shift) & 255], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    if (sh[i]) atomicAdd(out + row * 256 + i, sh[i]);
  }
}

// lohi[row] = (least value whose key is kp, least value whose key
// exceeds kp); ss[row] = sum of (v - mean)^2.
__global__ void __launch_bounds__(kThreads)
q24_tail_kernel(const float* __restrict__ vals, long long n,
                const int* __restrict__ kp, const float* __restrict__ means,
                float* __restrict__ lohi, double* __restrict__ ss) {
  __shared__ float w_lo[kWarps], w_nx[kWarps], w_ss[kWarps];
  const long long row = blockIdx.y;
  const float* x = vals + row * n;
  const int target = kp[row];
  const float mean = means[row];
  float lo = INFINITY, nx = INFINITY, s = 0.0f;
  const long long start = static_cast<long long>(blockIdx.x) * kElemsPerBlock;
  const long long end = min(start + kElemsPerBlock, n);
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float v = __ldg(x + i);
    const int key = q24_key(v);
    if (key == target) lo = fminf(lo, v);
    if (key > target) nx = fminf(nx, v);
    const float c = v - mean;
    s += c * c;
  }
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
    for (int wi = 0; wi < kWarps; ++wi) {
      lo = fminf(lo, w_lo[wi]);
      nx = fminf(nx, w_nx[wi]);
      total += w_ss[wi];
    }
    atomic_min_f32(lohi + row * 2, lo);
    atomic_min_f32(lohi + row * 2 + 1, nx);
    atomicAdd(ss + row, total);
  }
}

dim3 row_grid(long long rows, long long n) {
  return dim3(static_cast<unsigned>((n + kElemsPerBlock - 1) / kElemsPerBlock),
              static_cast<unsigned>(rows));
}

}  // namespace

// vals: (rows, n) f32 contiguous; prefix: (rows,) i32; out: (rows, 256)
// i32, zeroed by the caller.
RGNIR_EXPORT int rgnir_byte_hist(const void* vals, long long rows, long long n,
                                 const void* prefix, int shift, void* out,
                                 void* stream) {
  if (rows > 0 && n > 0) {
    byte_hist_kernel<<<row_grid(rows, n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), n, static_cast<const int*>(prefix),
        shift, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: (rows, n) f32; kp: (rows,) i32; means: (rows,) f32; lohi: (rows, 2)
// f32 set to +inf by the caller; ss: (rows,) f64 zeroed.
RGNIR_EXPORT int rgnir_q24_tail(const void* vals, long long rows, long long n,
                                const void* kp, const void* means, void* lohi,
                                void* ss, void* stream) {
  if (rows > 0 && n > 0) {
    q24_tail_kernel<<<row_grid(rows, n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), n, static_cast<const int*>(kp),
        static_cast<const float*>(means), static_cast<float*>(lohi),
        static_cast<double*>(ss));
  }
  return static_cast<int>(cudaGetLastError());
}

// The exact median's data passes: one radix round's byte histogram, and
// the tail pass that recovers the q24 median's value, its even-n
// successor and the centred sum of squares.
//
// Replace rgnir_tpu/kernels/select.py:_byte_hist_kernel (its "q24" and
// "f32" key modes) and rgnir_tpu/kernels/select.py:_q24_tail_kernel. The
// TPU kernels read (R, 1024) row blocks, counted through nibble one-hots
// on the MXU and read the per-row prefix from SMEM scalars. Here a block
// reads a contiguous chunk of one row, counts in shared memory, and
// reads its row's prefix, key or mean from device memory: the prefix
// and ranks between rounds stay on the device, so a whole select makes
// no host round trip. Offsets are 64-bit, so rows may exceed 2^31
// elements.
//
// Row map (input_row, common.cuh): only the first `take` rows of each
// group of `group` rows are selected, and the skipped rows are never
// read; group = take = 1 selects every row.
//
// Positional validity of byte_hist and q24_tail (the TPU kernels' modes,
// for the sharded median): a prefix (the first n_valid elements of each
// row) or a rectangle (each row a row-major (n / row_cols, row_cols)
// block of which the top-left rows_live x cols_live count). The prefix is
// a shorter row: the default instantiation's loop unchanged (the default
// is n_valid = n), reading only the valid elements. The rectangle has its
// own instantiation, which walks the live rows whole as the prefix walks
// its elements, loads every element and takes only the live columns, a
// thread carrying its column from step to step (PERF.md has the variants
// measured). An element outside the valid set has no key (the TPU
// kernel's key -1) and adds 0 to the sum of squares. Positions and
// columns are 64-bit.
//
// Bound: memory. Each pass reads every selected element once (4 bytes):
// 2 kinds x 8 x 1024^2 elements are 67 MB, about 20 us at 3.35 TB/s.
// The per-element work (the key, a compare, and for the histogram a
// shared atomic only for the elements whose higher key bits match) is
// far below the card's rate. Design: a grid of (chunk, row) blocks,
// coalesced loads one element per thread per step; the tail's mins and
// sum go through warp shuffles to one atomic per block.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kElemsPerBlock = 8192;

enum KeyMode { kQ24 = 0, kF32 = 1 };

// The order-preserving uint32 of the float32 bits: negative values
// invert every bit, others set the sign bit. Bits are compared, never
// floats, so -0.0 keys below +0.0.
__device__ __forceinline__ unsigned f32_key(float v) {
  const unsigned bits = __float_as_uint(v);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

template <int Mode>
__device__ __forceinline__ unsigned radix_key(float v) {
  return Mode == kF32 ? f32_key(v) : static_cast<unsigned>(q24_key(v));
}

// 256-bin histogram of key byte (key >> shift) & 255 over the valid
// elements whose key bits above that byte equal those of the row's
// prefix. The top round (hi_mask 0) counts every valid element. A row
// holds n elements, of which the valid are its first `live`, or with
// kRect the columns before `cols` of its first `live` elements, whole
// rows of a row_cols-wide block.
template <int Mode, bool kRect>
__global__ void __launch_bounds__(kThreads)
byte_hist_kernel(const float* __restrict__ vals, long long n, long long live,
                 long long cols, long long row_cols,
                 const unsigned* __restrict__ prefix, int shift,
                 unsigned hi_mask, int group, int take, int* __restrict__ out) {
  __shared__ int sh[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) sh[i] = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const float* x = vals + input_row(row, group, take) * n;
  const unsigned want = prefix[row] & hi_mask;
  const long long start = static_cast<long long>(blockIdx.x) * kElemsPerBlock;
  const long long end = min(start + kElemsPerBlock, live);
  auto count = [&](float v, bool valid) {
    const unsigned key = radix_key<Mode>(v);
    if (valid && (key & hi_mask) == want) atomicAdd(&sh[(key >> shift) & 255u], 1);
  };
  if (!kRect) {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) count(__ldg(x + i), true);
  } else {
    // the same walk over the rectangle's rows, whole: every element is
    // loaded (a load under a branch would stall the loop; the columns past
    // `cols` are a sliver of the rows) and those before `cols` counted. A
    // thread's column is carried from step to step: a step of kThreads is
    // step_c columns and at most one row wrap.
    long long c = (start + threadIdx.x) % row_cols;
    const long long step_c = kThreads % row_cols;
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      count(__ldg(x + i), c < cols);
      c += step_c;
      if (c >= row_cols) c -= row_cols;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    if (sh[i]) atomicAdd(out + row * 256 + i, sh[i]);
  }
}

// lohi[row] = (least valid value whose key is kp, least valid value whose
// key exceeds kp); ss[row] = sum of (v - mean)^2 over the valid values.
// The valid values are the first `live` of the row, or with kRect the
// columns before `cols` of its first `live` elements (whole rows of a
// row_cols-wide block), as for byte_hist_kernel.
template <bool kRect>
__global__ void __launch_bounds__(kThreads)
q24_tail_kernel(const float* __restrict__ vals, long long n, long long live,
                long long cols, long long row_cols, const int* __restrict__ kp,
                const float* __restrict__ means, int group, int take,
                float* __restrict__ lohi, double* __restrict__ ss) {
  const long long row = blockIdx.y;
  const float* x = vals + input_row(row, group, take) * n;
  const int target = kp[row];
  const float mean = means[row];
  float lo = INFINITY, nx = INFINITY, s = 0.0f;
  const long long start = static_cast<long long>(blockIdx.x) * kElemsPerBlock;
  const long long end = min(start + kElemsPerBlock, live);
  auto take_value = [&](float v, bool valid) {
    const int key = q24_key(v);
    if (valid && key == target) lo = fminf(lo, v);
    if (valid && key > target) nx = fminf(nx, v);
    const float c = v - mean;
    if (valid) s += c * c;
  };
  if (!kRect) {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      take_value(__ldg(x + i), true);
    }
  } else {
    // byte_hist_kernel's rectangle walk: every element of the live rows
    // loaded, the column carried from step to step.
    long long c = (start + threadIdx.x) % row_cols;
    const long long step_c = kThreads % row_cols;
    for (long long i = start + threadIdx.x; i < end; i += kThreads) {
      take_value(__ldg(x + i), c < cols);
      c += step_c;
      if (c >= row_cols) c -= row_cols;
    }
  }
  block_fold_tail<kWarps>(lo, nx, s, lohi + row * 2, ss + row);
}

// The grid of a row pass over `live` positions of each row: at least one
// block per row, so that every row's outputs are written.
dim3 row_grid(long long rows, long long live) {
  const long long blocks = std::max(1LL, (live + kElemsPerBlock - 1) / kElemsPerBlock);
  return dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(rows));
}

// The positions a row's walk covers (the prefix, or the rectangle's live
// rows whole), or -1 for a validity the row does not hold.
long long walk_length(long long n, long long n_valid, long long cols_live,
                      long long row_cols) {
  if (n_valid < 0 || row_cols < 0) return -1;
  if (row_cols == 0) return n_valid <= n ? n_valid : -1;
  if (n % row_cols != 0 || n_valid > n / row_cols || cols_live < 0 ||
      cols_live > row_cols) {
    return -1;
  }
  return n_valid * row_cols;
}

template <int Mode>
void launch_byte_hist(dim3 grid, cudaStream_t s, const float* v, long long n,
                      long long live, long long cols, long long row_cols,
                      const unsigned* p, int shift, unsigned hi_mask, int group,
                      int take, int* o) {
  if (row_cols > 0) {
    byte_hist_kernel<Mode, true><<<grid, kThreads, 0, s>>>(
        v, n, live, cols, row_cols, p, shift, hi_mask, group, take, o);
  } else {
    byte_hist_kernel<Mode, false><<<grid, kThreads, 0, s>>>(
        v, n, live, cols, row_cols, p, shift, hi_mask, group, take, o);
  }
}

}  // namespace

// vals: (B, n) f32 contiguous; rows: the selected rows (B / group *
// take); prefix: (rows,) u32 bit patterns; key_mode: 0 q24, 1 f32; out:
// (rows, 256) i32, zeroed by the caller. Validity: with row_cols == 0 the
// first n_valid elements of each row count (n_valid = n: all); with
// row_cols > 0 each row is a row-major (n / row_cols, row_cols) block of
// which the top-left n_valid (rows) x cols_live rectangle counts.
RGNIR_EXPORT int rgnir_byte_hist(const void* vals, long long rows, long long n,
                                 long long n_valid, long long cols_live,
                                 long long row_cols, const void* prefix, int shift,
                                 int key_mode, int group, int take, void* out,
                                 void* stream) {
  const int top_shift = key_mode == kF32 ? 24 : 16;
  const long long live = walk_length(n, n_valid, cols_live, row_cols);
  if (shift < 0 || shift > top_shift || shift % 8 != 0 || take < 1 ||
      group < take || live < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The key bits above this round's byte; none in the top round. The
  // shift by 32 that the f32 top round would need is never taken.
  const unsigned hi_mask = shift >= top_shift ? 0u : (~0u << (shift + 8));
  if (rows > 0 && n > 0) {
    const auto* v = static_cast<const float*>(vals);
    const auto* p = static_cast<const unsigned*>(prefix);
    auto* o = static_cast<int*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid = row_grid(rows, live);
    if (key_mode == kF32) {
      launch_byte_hist<kF32>(grid, s, v, n, live, cols_live, row_cols, p, shift,
                             hi_mask, group, take, o);
    } else {
      launch_byte_hist<kQ24>(grid, s, v, n, live, cols_live, row_cols, p, shift,
                             hi_mask, group, take, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// vals: (B, n) f32; rows, group, take and the validity (n_valid,
// cols_live, row_cols) as for rgnir_byte_hist; kp: (rows,) i32; means:
// (rows,) f32; lohi: (rows, 2) f32 set to +inf by the caller; ss: (rows,)
// f64 zeroed.
RGNIR_EXPORT int rgnir_q24_tail(const void* vals, long long rows, long long n,
                                long long n_valid, long long cols_live,
                                long long row_cols, const void* kp, const void* means,
                                int group, int take, void* lohi, void* ss, void* stream) {
  const long long live = walk_length(n, n_valid, cols_live, row_cols);
  if (take < 1 || group < take || live < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0 && n > 0) {
    const auto* v = static_cast<const float*>(vals);
    const auto* k = static_cast<const int*>(kp);
    const auto* m = static_cast<const float*>(means);
    auto* lh = static_cast<float*>(lohi);
    auto* sq = static_cast<double*>(ss);
    const auto s = static_cast<cudaStream_t>(stream);
    if (row_cols > 0) {
      q24_tail_kernel<true><<<row_grid(rows, live), kThreads, 0, s>>>(
          v, n, live, cols_live, row_cols, k, m, group, take, lh, sq);
    } else {
      q24_tail_kernel<false><<<row_grid(rows, live), kThreads, 0, s>>>(
          v, n, live, cols_live, row_cols, k, m, group, take, lh, sq);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

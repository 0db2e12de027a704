// The one-pass q24 select: radix rounds 1 and 2, both cdf picks and the
// tail (the median's value, its even-n successor, the centred sum of
// squares and eq_minus_rank) in one launch that reads the values from
// device memory once.
//
// Replaces rgnir_tpu/kernels/select.py:_q24_onepass_kernel. The TPU
// kernel streams a row once into a VMEM copy (up to 4 MiB) and runs
// round 2 and the tail from that copy. A Hopper block has 227 KB of
// shared memory, far less than one 1024^2 row, so here the on-chip copy
// is the 50 MB L2 cache: the selected rows are taken in groups small
// enough to stay in L2, and for each group the whole grid reads the
// group from device memory in round 1, then reads it again from L2 in
// round 2 and in the tail. One cooperative launch (every block
// co-resident) separates the phases with grid-wide barriers, two per
// group and one at the start:
//
//   zero the counts | per group: round 1 (count byte 1 under the
//   round-0 byte) | round 2 (pick 1, count byte 2 under the 16-bit
//   prefix; items in reverse, so the last ones read come first) | tail
//   (pick 2, then the mins and the sum of squares)
//
// Each item does its row's pick itself (a 256-bin scan, far cheaper than
// a grid barrier); the item at a row's chunk 0 stores the row's pick 1
// for the tail and its eq_minus_rank. The picks are the arithmetic of
// cdf_pick (rgnir_torch/ops/select.py): one bin per thread, an inclusive
// scan in int64, and the winning bin is the count of cdf entries <= rank.
// Counts are integers throughout (the TPU kernel's float dots needed
// Precision.HIGHEST; nothing here rounds). Items are sized so that one
// group's items are about one per block, and rows whose length is a
// multiple of 4 are read 16 bytes at a time.
//
// Bound: memory. The selected elements are read once, 4 bytes each
// (2 kinds x 8 x 1024^2 elements: 67 MB, about 20 us at 3.35 TB/s); the
// two further reads hit L2. Per element the work is the q24 key, two
// compares, two mins and a square: far below the card's rate.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // one histogram bin per thread in a pick
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* vals;       // (B, n) f32
  long long n;             // elements per row
  long long rows;          // selected rows
  int group, take;         // row map (input_row, common.cuh)
  long long group_rows;    // selected rows per L2-resident group
  long long chunk;         // elements per item, a multiple of 1024
  long long chunks;        // items per row
  bool vec;                // rows are read as float4 (n % 4 == 0)
  const int* sel0;         // (rows,) round-0 byte
  const long long* rank1;  // (rows,) rank left after round 0
  const float* means;      // (rows,) centres of the sum of squares
  int* hist;               // (rows, 2, 256) scratch: rounds 1 and 2
  long long* rank2;        // (rows,) scratch: rank left after round 1
  int* prefix;             // (rows,) scratch: the 16-bit prefix
  float* lohi;             // (rows, 2) out: lo, nxt
  double* ss;              // (rows,) out: centred sum of squares
  long long* eqmr;         // (rows,) out: count of the key at ranks >= k
};

__device__ __forceinline__ const float* row_ptr(const Params& p, long long bi) {
  return p.vals + input_row(bi, p.group, p.take) * p.n;
}

// Calls f on each element of the item (row, c), the block's threads
// taking neighbouring elements.
template <class F>
__device__ __forceinline__ void for_each(const Params& p, long long row, long long c,
                                         F f) {
  const float* x = row_ptr(p, row);
  const long long start = c * p.chunk;
  const long long end = min(start + p.chunk, p.n);
  if (p.vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = start / 4 + threadIdx.x; i < end / 4; i += kThreads) {
      const float4 v = __ldg(x4 + i);
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads) f(__ldg(x + i));
  }
}

// Adds the counts of byte (key >> shift) & 255, over the item's elements
// whose key >> (shift + 8) equals want, to h[256].
__device__ void count_item(const Params& p, long long row, long long c, int shift,
                           int want, int* __restrict__ h, int* sh) {
  sh[threadIdx.x] = 0;
  __syncthreads();
  for_each(p, row, c, [&](float v) {
    const int key = q24_key(v);
    if ((key >> (shift + 8)) == want) atomicAdd(&sh[(key >> shift) & 255], 1);
  });
  __syncthreads();
  const int count = sh[threadIdx.x];
  if (count) atomicAdd(h + threadIdx.x, count);
  __syncthreads();
}

struct Pick {
  int sel;           // the bin holding the rank
  long long below;   // the count below that bin
  long long in_bin;  // the count inside it
};

// cdf_pick on h[256] against rank, for every thread of the block.
__device__ __forceinline__ Pick block_pick(const int* h, long long rank) {
  __shared__ long long warp_total[kWarps];
  __shared__ long long below_s, at_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long c = h[t];
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += u;
  }
  if (lane == 31) warp_total[warp] = c;
  if (t == 0) below_s = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) c += warp_total[w];
  const int s = __syncthreads_count(c <= rank);
  if (t == s - 1) below_s = c;
  if (t == min(s, 255)) at_s = c;
  __syncthreads();
  const Pick pick{s, below_s, at_s - below_s};
  __syncthreads();
  return pick;
}

// The tail over the item (row, c) for the winning key kp: the least
// value of key kp, the least above it and the sum of squares about the
// row's mean, each folded into the row's outputs by one atomic.
__device__ void tail_item(const Params& p, long long row, long long c, int kp) {
  const float mean = p.means[row];
  float lo = INFINITY, nx = INFINITY, s = 0.0f;
  for_each(p, row, c, [&](float v) {
    const int key = q24_key(v);
    if (key == kp) lo = fminf(lo, v);
    if (key > kp) nx = fminf(nx, v);
    const float d = v - mean;
    s += d * d;
  });
  block_fold_tail<kWarps>(lo, nx, s, p.lohi + row * 2, p.ss + row);
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) q24_onepass_kernel(const Params p) {
  __shared__ int sh[256];
  cg::grid_group grid = cg::this_grid();
  const long long stride = gridDim.x;
  for (long long i = blockIdx.x * kThreads + threadIdx.x; i < p.rows * 512;
       i += stride * kThreads) {
    p.hist[i] = 0;
  }
  for (long long r = blockIdx.x * kThreads + threadIdx.x; r < p.rows;
       r += stride * kThreads) {
    p.lohi[2 * r] = INFINITY;
    p.lohi[2 * r + 1] = INFINITY;
    p.ss[r] = 0.0;
  }
  grid.sync();
  for (long long g0 = 0; g0 < p.rows; g0 += p.group_rows) {
    const long long items = (min(g0 + p.group_rows, p.rows) - g0) * p.chunks;
    // round 1: byte 1 of the keys whose top byte is sel0
    for (long long it = blockIdx.x; it < items; it += stride) {
      const long long row = g0 + it / p.chunks;
      count_item(p, row, it % p.chunks, 8, p.sel0[row], p.hist + row * 512, sh);
    }
    grid.sync();
    // round 2: pick 1, then byte 0 of the keys whose top 16 bits are the
    // prefix; the items in reverse, so those read last are read first
    for (long long it = blockIdx.x; it < items; it += stride) {
      const long long item = items - 1 - it;
      const long long row = g0 + item / p.chunks;
      const long long c = item % p.chunks;
      const Pick pick = block_pick(p.hist + row * 512, p.rank1[row]);
      const int prefix = (p.sel0[row] << 8) | pick.sel;
      if (c == 0 && threadIdx.x == 0) {
        p.prefix[row] = prefix;
        p.rank2[row] = p.rank1[row] - pick.below;
      }
      count_item(p, row, c, 0, prefix, p.hist + row * 512 + 256, sh);
    }
    grid.sync();
    // tail: pick 2, then the mins and the sum of squares
    for (long long it = blockIdx.x; it < items; it += stride) {
      const long long row = g0 + it / p.chunks;
      const long long c = it % p.chunks;
      const long long rank2 = p.rank2[row];
      const Pick pick = block_pick(p.hist + row * 512 + 256, rank2);
      if (c == 0 && threadIdx.x == 0) p.eqmr[row] = pick.in_bin - (rank2 - pick.below);
      tail_item(p, row, c, (p.prefix[row] << 8) | pick.sel);
    }
  }
}

}  // namespace

// vals: (B, n) f32 contiguous; rows: the selected rows (B / group *
// take); sel0: (rows,) i32; rank1: (rows,) i64; means: (rows,) f32;
// scratch: rows * 2060 bytes, 8-aligned, not initialised; lohi: (rows, 2)
// f32; ss: (rows,) f64; eqmr: (rows,) i64. lohi and ss are initialised
// here. group_rows: selected rows per L2-resident group.
RGNIR_EXPORT int rgnir_q24_onepass(const void* vals, long long rows, long long n,
                                   int group, int take, long long group_rows,
                                   const void* sel0, const void* rank1,
                                   const void* means, void* scratch, void* lohi,
                                   void* ss, void* eqmr, void* stream) {
  if (take < 1 || group < take || group_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.vals = static_cast<const float*>(vals);
  p.n = n;
  p.rows = rows;
  p.group = group;
  p.take = take;
  p.group_rows = group_rows;
  p.vec = n % 4 == 0;
  p.sel0 = static_cast<const int*>(sel0);
  p.rank1 = static_cast<const long long*>(rank1);
  p.means = static_cast<const float*>(means);
  // scratch layout: rank2 (rows i64), hist (rows x 512 i32), prefix (rows i32)
  auto* base = static_cast<char*>(scratch);
  p.rank2 = reinterpret_cast<long long*>(base);
  p.hist = reinterpret_cast<int*>(base + rows * 8);
  p.prefix = reinterpret_cast<int*>(base + rows * 8 + rows * 2048);
  p.lohi = static_cast<float*>(lohi);
  p.ss = static_cast<double*>(ss);
  p.eqmr = static_cast<long long*>(eqmr);

  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q24_onepass_kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // Every block must be resident at once for the grid barriers. Items of
  // a multiple of 1024 elements, about one per block for a whole group;
  // more blocks than a group's items would only wait at the barriers.
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long group_elems = std::min(group_rows, rows) * n;
  p.chunk = std::max((group_elems + resident * 1024 - 1) / (resident * 1024), 1LL) * 1024;
  p.chunks = (n + p.chunk - 1) / p.chunk;
  const unsigned blocks = static_cast<unsigned>(
      std::min(resident, std::min(group_rows, rows) * p.chunks));
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(q24_onepass_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

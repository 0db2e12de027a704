// The one-pass q24 select: radix rounds 1 and 2, both cdf picks and the
// tail (the median's value, its even-n successor, the centred sum of
// squares and eq_minus_rank) in one launch over up to 64 rows (the
// wrapper's ONEPASS_TABLE_ROWS) that reads each valid value from device
// memory once and never again.
//
// Replaces rgnir_tpu/kernels/select.py:_q24_onepass_kernel. The TPU
// kernel streams a row once into a VMEM copy (up to 4 MiB) and reruns
// the rounds from that copy. A Hopper block has 227 KB of shared memory,
// far less than one 1024^2 row, so here nothing is kept to be read
// again: one sweep computes everything that needs every value, into
// per-row tables small enough to pick from.
//
// The sweep: the rows' valid prefixes are cut into items of kChunk
// elements, one block each, row by row, small blocks with few registers
// so that many are resident on an SM and their loads overlap each
// other's arithmetic. Per element: the q24 key,
// (x - mean)^2 into the row's sum, and by the key's top byte against the
// row's round-0 byte sel0:
//   above sel0 -> x into the least value above the bin (nx0);
//   equal      -> one count and x's min into the bin of the key's low 16
//                 bits (the fine key) in the row's 2^16-bin table.
// A smooth or constant frame sends most elements to a few fine keys, so
// the counts are aggregated twice before they reach the table: each
// thread keeps a run (key, count, min) in registers and adds it where
// the key changes, into a direct-mapped table of its block (shared-memory
// atomics); at the end of its item, the block adds each entry of that
// table to the row's tables in device memory (one atomic count, min,
// coarse count and touched bit per distinct key; a run whose slot holds
// another key goes there at once), with its sum of squares and nx0.
//
// The picks: each block then counts itself into the row's arrivals, and
// the block that completes them (the row's last) picks: byte 1 from the
// row's 256 coarse counts (byte 1 of
// the key), byte 0 from the 256 fine counts under it; lo is kp's bin
// minimum, nxt the minimum of the first non-empty bin above kp, or nx0
// when none (the key is monotone in the value). The same block then
// zeroes what the row's sweep touched: the fine bins marked in the row's
// bitmap, the bitmap, its coarse counts and its scalars. The tables are a
// scratch buffer (533,520 bytes a row of the launch) that the wrapper
// zeroes once per device and each launch leaves zeroed, so no launch
// clears it and no grid barrier is needed. Counts
// and minima are exact integer arithmetic (minima on the order-preserving
// u32 of the float bits), so nothing depends on a key holding one
// distinct value. The picks are cdf_pick's arithmetic
// (rgnir_torch/ops/select.py): an inclusive scan, the winning bin the
// count of cdf entries <= rank.
//
// Rows whose length is a multiple of 4 are read 16 bytes at a time. A
// block is 256 threads and the kernel 32 registers, so 8 blocks fit on an
// SM and a launch over (a1)'s rows is one wave: more bytes in flight came
// from more resident warps, not from more loads a thread, which cost
// registers and residency (PERF.md). The result equals q24_onepass_plain's
// wherever rank1 lies inside the round-0 bin (rank1 < the count of valid
// keys with top byte sel0, as the round-0 pick of the same rows' counts
// gives), or the row has no valid element.
//
// Bound: memory. The valid elements are read once, 4 bytes each (2 kinds
// x 8 x 1024^2 elements: 67 MB, about 20 us at 3.35 TB/s). Per element
// the work is the key (an add, a multiply, a conversion, a min), a
// subtract and a fused multiply-add, two compares and, in the round-0
// bin, the run update: far below the card's rate.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                   // one thread per bin in a pick
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 16384;             // elements per item (block)
constexpr int kFine = 1 << 16;                  // fine keys under the round-0 byte
constexpr int kSlots = 512;                     // a block's direct-mapped run table
constexpr unsigned kNone = 0xFFFFFFFFu;         // an empty slot's key

// Per-row scratch in device memory, zero between launches: the fine
// counts and minima, a bitmap of the fine keys touched, the coarse
// counts, then (items arrived, nx0, two unused): 533,520 bytes a row,
// whatever its length. The rows' sums of squares (f64) follow the
// launch's rows.
constexpr long long kRowWords = 2LL * kFine + kFine / 32 + 256 + 4;

struct Params {
  const float* vals;       // (B, n) f32
  long long n;             // elements per row (the row stride)
  long long nv;            // the valid prefix of each row
  long long first;         // the first selected row of this launch
  long long items;         // items (blocks) per row
  int group, take;         // row map (input_row, common.cuh)
  bool vec;                // rows are read as float4 (n % 4 == 0, aligned)
  const long long* sel0;   // (rows,) round-0 byte
  const long long* rank1;  // (rows,) rank left after round 0
  const float* means;      // (rows,) centres of the sum of squares
  unsigned* scratch;       // (launch rows, kRowWords) u32, zero on entry and exit
  double* sums;            // (launch rows,) f64 scratch, zero on entry and exit
  float* lohi;             // (rows, 2) out: lo, nxt
  double* ss;              // (rows,) out: centred sum of squares
  long long* eqmr;         // (rows,) out: count of the key at ranks >= k
};

// A least value as the complement of the order-preserving u32 of its
// bits: larger is smaller, and 0 (nothing yet) is below every value's
// image, so zeroed memory is neutral to atomicMax.
__device__ __forceinline__ unsigned least_key(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? b : ~(b | 0x80000000u);
}

__device__ __forceinline__ float from_least_key(unsigned k) {
  if (k == 0) return INFINITY;
  const unsigned o = ~k;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

struct Row {
  unsigned* cnt;     // [kFine] counts of the fine keys
  unsigned* mn;      // [kFine] their least values (least_key)
  unsigned* bits;    // [kFine / 32] the fine keys touched
  unsigned* coarse;  // [256] counts of byte 1
  unsigned* meta;    // [4] items arrived, nx0 (least_key)

  __device__ Row(const Params& p, long long local) {
    unsigned* base = p.scratch + local * kRowWords;
    cnt = base;
    mn = base + kFine;
    bits = base + 2 * kFine;
    coarse = bits + kFine / 32;
    meta = coarse + 256;
  }

  // A count and a least value of fine key k (atomics whose result is
  // not read: reductions in the L2 cache that do not stall the block).
  __device__ __forceinline__ void add(unsigned k, unsigned count, unsigned least) const {
    atomicAdd(cnt + k, count);
    atomicMax(mn + k, least);
    atomicOr(bits + (k >> 5), 1u << (k & 31));
    atomicAdd(coarse + (k >> 8), count);
  }
};

struct Pick {
  int sel;           // the bin holding the rank
  long long below;   // the count below that bin
  long long in_bin;  // the count inside it
};

// cdf_pick on 256 counts against rank: thread t < 256 holds bin t's
// count h; every thread of the block calls it and gets the pick.
__device__ Pick block_pick(unsigned h, long long rank) {
  __shared__ long long warp_total[kWarps];
  __shared__ long long below_s, at_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  long long c = t < 256 ? h : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += u;
  }
  if (lane == 31) warp_total[warp] = c;
  if (t == 0) below_s = 0;
  __syncthreads();
  for (int w = 0; w < warp; ++w) c += warp_total[w];
  const int s = __syncthreads_count(t < 256 && c <= rank);
  if (t == s - 1) below_s = c;
  if (t == min(s, 255)) at_s = c;
  __syncthreads();
  const Pick pick{s, below_s, at_s - below_s};
  __syncthreads();
  return pick;
}

// The block's largest v; every thread calls it and gets it.
__device__ unsigned block_max(unsigned v) {
  __shared__ unsigned w_max[kWarps];
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) w_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kWarps; ++w) v = max(v, w_max[w]);
  __syncthreads();
  return v;
}

// Selected row r's picks and outputs, by the block that completed its
// sweep; then its scratch (the launch's row `local`) back to zero.
// Thread t holds bin t of each 256-bin table read; every read that does
// not wait on a pick is issued with the first, so the picks wait on two
// rounds of reads from the L2 cache.
__device__ void finish_row(const Params& p, long long r, long long local) {
  static_assert(kThreads == 256, "one thread per bin");
  const Row row(p, local);
  const unsigned t = threadIdx.x;
  const unsigned h1 = __ldcg(row.coarse + t);
  const unsigned nx0 = __ldcg(row.meta + 1);
  const double sum = __ldcg(p.sums + local);
  const long long rank1 = p.rank1[r];
  const Pick p1 = block_pick(h1, rank1);
  const long long rank2 = rank1 - p1.below;
  // the chosen coarse bin's fine bins, and those of the next non-empty
  // coarse bin above it, where nxt lies when no fine bin above kp in the
  // chosen one is non-empty
  const unsigned seg = static_cast<unsigned>(p1.sel) << 8;
  const unsigned next = 256 - block_max(t > static_cast<unsigned>(p1.sel) && h1 ? 256 - t : 0);
  const bool has_next = next < 256;
  unsigned h2 = 0, m2 = 0, m3 = 0;
  if (p1.sel < 256) {
    h2 = __ldcg(row.cnt + (seg | t));
    m2 = __ldcg(row.mn + (seg | t));
  }
  if (has_next && __ldcg(row.cnt + ((next << 8) | t))) m3 = __ldcg(row.mn + ((next << 8) | t));
  const Pick p2 = block_pick(h2, rank2);
  // kp's fine key when kp lies in the round-0 bin; else (only when the
  // bin is empty) no fine key qualifies
  const bool inside = p1.sel < 256 && p2.sel < 256;
  const unsigned kf = seg | p2.sel;
  // every value of the next coarse bin is above those of the chosen one,
  // and least_key reverses the order: the max takes the chosen bin's
  // first non-empty fine bin above kp when there is one
  unsigned above = inside ? m3 : 0;
  if (inside && (seg | t) > kf && h2) above = max(above, m2);
  above = block_max(above);
  if (inside && t == static_cast<unsigned>(p2.sel)) p.lohi[2 * r] = from_least_key(h2 ? m2 : 0);
  if (t == 0) {
    if (!inside) p.lohi[2 * r] = INFINITY;
    p.lohi[2 * r + 1] = from_least_key(max(above, nx0));
    p.ss[r] = sum;
    p.eqmr[r] = p2.in_bin - (rank2 - p2.below);
  }
  __syncthreads();
  // the bitmap's words all read at once, then the touched bins cleared
  constexpr int kWords = kFine / 32 / kThreads;
  unsigned touched[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) touched[j] = __ldcg(row.bits + j * kThreads + t);
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const unsigned w = j * kThreads + t;
    for (unsigned word = touched[j]; word; word &= word - 1) {
      const unsigned k = w * 32 + __ffs(word) - 1;
      row.cnt[k] = 0;
      row.mn[k] = 0;
    }
    if (touched[j]) row.bits[w] = 0;
  }
  row.coarse[t] = 0;
  if (t < 4) row.meta[t] = 0;
  if (t == 0) p.sums[local] = 0.0;
}

__global__ void __launch_bounds__(kThreads) q24_onepass_kernel(const Params p) {
  __shared__ unsigned tag[kSlots], lcnt[kSlots], lmin[kSlots];
  __shared__ float w_ss[kWarps];
  __shared__ unsigned w_nx[kWarps];
  __shared__ int last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < kSlots; i += kThreads) {
    tag[i] = kNone;
    lcnt[i] = 0;
    lmin[i] = 0;
  }
  __syncthreads();

  const long long local = blockIdx.x / p.items;
  const long long r = p.first + local;
  const long long start = blockIdx.x % p.items * kChunk;
  const long long end = min(start + kChunk, p.nv);
  const int sel0 = static_cast<int>(p.sel0[r]);
  const float mean = p.means[r];
  const float* x = p.vals + input_row(r, p.group, p.take) * p.n;
  const Row row(p, local);
  float s = 0.0f;
  unsigned nx0 = 0;
  unsigned run_key = kNone, run_cnt = 0, run_min = 0;

  // A run into the block's run table, or to the row's table when the
  // slot holds another key.
  auto add_run = [&]() {
    const unsigned slot = run_key & (kSlots - 1);
    // a slot's key, once set, stays for the block's item
    unsigned held = *reinterpret_cast<volatile unsigned*>(tag + slot);
    if (held == kNone) held = atomicCAS(tag + slot, kNone, run_key);
    if (held == kNone || held == run_key) {
      atomicAdd(lcnt + slot, run_cnt);
      atomicMax(lmin + slot, run_min);
    } else {
      row.add(run_key, run_cnt, run_min);
    }
  };
  auto in_bin = [&](unsigned fine, float v) {
    const unsigned k = least_key(v);
    if (fine == run_key) {
      ++run_cnt;
      run_min = max(run_min, k);
    } else {
      if (run_cnt) add_run();
      run_key = fine;
      run_cnt = 1;
      run_min = k;
    }
  };
  auto visit = [&](float v) {
    const int key = q24_key(v);
    const float d = v - mean;
    s += d * d;
    if ((key >> 16) > sel0) nx0 = max(nx0, least_key(v));
    if ((key >> 16) == sel0) in_bin(key & (kFine - 1), v);
  };
  // four elements: the branch-free work first, one branch for the bin
  auto visit4 = [&](const float4& v) {
    const float e[4] = {v.x, v.y, v.z, v.w};
    int key[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      key[j] = q24_key(e[j]);
      const float d = e[j] - mean;
      s += d * d;
      if ((key[j] >> 16) > sel0) nx0 = max(nx0, least_key(e[j]));
      any |= (key[j] >> 16) == sel0;
    }
    if (any) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((key[j] >> 16) == sel0) in_bin(key[j] & (kFine - 1), e[j]);
      }
    }
  };

  long long tail = start;
  if (p.vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long q1 = end / 4;
    for (long long q = start / 4 + t; q < q1; q += kThreads) visit4(__ldg(x4 + q));
    tail = q1 * 4;
  }
  // the elements no 16-byte load took: the valid prefix's last (fewer
  // than 4), or all of a row that is not read as float4
  for (long long e = tail + t; e < end; e += kThreads) visit(__ldg(x + e));
  if (run_cnt) add_run();

  // the run table into the row's tables, the sum and nx0, then the
  // arrival; the block that completes the row finishes it
  s = warp_sum(s);
  nx0 = __reduce_max_sync(0xffffffffu, nx0);
  if (lane == 0) {
    w_ss[warp] = s;
    w_nx[warp] = nx0;
  }
  __syncthreads();
  for (int i = t; i < kSlots; i += kThreads) {
    if (tag[i] != kNone) row.add(tag[i], lcnt[i], lmin[i]);
  }
  if (t == 0) {
    double total = 0.0;
    unsigned least = 0;
    for (int w = 0; w < kWarps; ++w) {
      total += w_ss[w];
      least = max(least, w_nx[w]);
    }
    atomicAdd(p.sums + local, total);
    if (least) atomicMax(row.meta + 1, least);
  }
  // every thread's updates of the row land before the arrival
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(row.meta, 1u) + 1 == p.items;
  __syncthreads();
  if (last) {
    __threadfence();
    finish_row(p, r, local);
  }
}

}  // namespace

// Bytes of the zeroed scratch a launch over `rows` rows needs.
RGNIR_EXPORT long long rgnir_q24_onepass_scratch_bytes(long long rows) {
  return rows * (kRowWords * 4 + 8);
}

// vals: (B, n) f32 contiguous; first, rows: the selected rows this
// launch takes (of B / group * take); n_valid: the valid prefix of each
// row (<= n); sel0: (selected rows,) i64; rank1: (selected rows,) i64;
// means: (selected rows,) f32; scratch: rgnir_q24_onepass_scratch_bytes(rows)
// bytes, 8-aligned and zero (each launch leaves it zero); lohi: (selected
// rows, 2) f32; ss: (selected rows,) f64; eqmr: (selected rows,) i64. Rows
// first to first + rows - 1 of every output are written here.
RGNIR_EXPORT int rgnir_q24_onepass(const void* vals, long long first, long long rows,
                                   long long n, long long n_valid, int group, int take,
                                   const void* sel0, const void* rank1, const void* means,
                                   void* scratch, void* lohi, void* ss, void* eqmr,
                                   void* stream) {
  if (take < 1 || group < take || first < 0 || n_valid < 0 || n_valid > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.vals = static_cast<const float*>(vals);
  p.n = n;
  p.nv = n_valid;
  p.first = first;
  // a row with no valid element still has one (empty) item, so that a
  // block finishes it
  p.items = std::max((n_valid + kChunk - 1) / kChunk, 1LL);
  p.group = group;
  p.take = take;
  p.vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  p.sel0 = static_cast<const long long*>(sel0);
  p.rank1 = static_cast<const long long*>(rank1);
  p.means = static_cast<const float*>(means);
  p.scratch = static_cast<unsigned*>(scratch);
  p.sums = reinterpret_cast<double*>(static_cast<char*>(scratch) + rows * kRowWords * 4);
  p.lohi = static_cast<float*>(lohi);
  p.ss = static_cast<double*>(ss);
  p.eqmr = static_cast<long long*>(eqmr);

  // one block per item, row by row: the rows are finished in order
  q24_onepass_kernel<<<static_cast<unsigned>(rows * p.items), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

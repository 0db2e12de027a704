// Joint 256 x 256 histograms of channel pairs of an interleaved uint8 band.
//
// Replaces the band reduction of the streamed mosaic,
// rgnir_tpu/pipeline/gigapixel.py:87-191 (_joint_hists_body and its
// single-device and sharded jits): per chunk of pixels, bf16 one-hots of
// each referenced channel and one (256, chunk) x (chunk, 256) MXU product
// per pair. That is jnp, not a Pallas kernel. On the card a product of
// one-hots would do 65,536 multiply-adds a pixel for one count; a
// histogram wants atomics.
//
// out[p, a, b] += #{i : px[i, ia[p]] == a and px[i, ib[p]] == b}, into
// (P, 256, 256) int32 bins (the row index is the pair's first channel).
//
// Bound: it reads each band byte once (N * C bytes) and adds into the
// P * 65,536 bins, so memory bounds it: 60.25 us for a 2048 x 32768 band
// of three channels and two pairs at 3.35 TB/s. What stands between a
// kernel and that bound is the adds into the bins, one per pixel and
// pair (134 M a band). Design (times: that band, H100 SXM at 700 W,
// PERF.md):
//
// - The bins live in the shared memory of a thread-block cluster. A
//   pair's 65,536 int32 bins (256 KB) exceed a block's 227 KB, so each
//   block owns a slice of 32,768 (128 KB): the keys (a << 8) | b of pair
//   p with a >> 7 == h belong to the block of rank 2p + h. Two pairs
//   make a cluster of 4, one block an SM; up to 4 pairs a cluster of 2P,
//   within the portable size of 8. 5-8 pairs count in two launch rows
//   (blockIdx.y) of up to 4 pairs, reading the band twice: a
//   non-portable cluster of 16 blocks of 224 KB needs 16 SMs of one GPC
//   (an H100's hold 16-18), so at most one fits a GPC and fewer SMs work.
// - The pixels go to every owner, not the adds: each block's share of a
//   tile is multicast by one bulk copy (cp.async.bulk ... multicast::
//   cluster) from device memory into the same offset of every block's
//   shared memory, counted by each block's mbarrier; every block then
//   reads the whole tile from its own shared memory and adds its slice's
//   keys there. The cluster reads each byte of the band once. Adds into
//   a peer's slice through distributed shared memory (red.shared::cluster)
//   ran at about 85 G/s, no faster than the L2 atomics of the first
//   design (1.59 ms a band); peers' shares read with ld.shared::cluster
//   took 0.39 ms, every block reading the cluster's range from L2 0.41,
//   the multicast 0.28.
// - Equal keys are not merged: a local shared-memory add to one address
//   costs no more than to spread ones, and every merge tried
//   (__match_any_sync, warp reductions, a lane's runs) was slower on both
//   uniform bytes and the smooth field.
// - Two stages of 48 KB tiles (with the slice, 224 KB a block): tile t + 1
//   is in flight while tile t is counted. One cluster barrier a tile
//   keeps a stage from being written while a peer still reads it; more
//   stages of smaller tiles, an mbarrier per stage with a producer warp,
//   or the barrier split in two were slower (tools/kernel_variants.py
//   --only jointhist).
// - 512 threads a block, each counting 16 pixels (C whole 16-byte pieces
//   of shared memory) at a time; a pair's bytes are picked by one byte
//   permute with a run-time selector.
// - A persistent grid sized by n: at most as many clusters as the card
//   holds at once (cudaOccupancyMaxActiveClusters), and one per
//   kMinPixelsPerCluster pixels, so a small band does not zero and flush
//   128 KB in many blocks. Each cluster takes a contiguous range.
// - Bulk copies want 16-byte aligned bytes: the pixels before the first
//   aligned one (head) and after the last whole unit of 16, at most 30,
//   are counted from device memory by the first cluster.
// - Then each owning block adds its non-zero bins into out, one coalesced
//   global add each, from a start that differs by cluster.
// - Counts are integers: exact in any order. A band holds fewer than
//   2^31 pixels (the wrapper's limit), so no int32 bin overflows.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kStages = 2;
constexpr int kStageBytes = 49152;  // one tile of the cluster's range, in each stage
constexpr long long kMinPixelsPerCluster = 1LL << 18;
constexpr int kMaxPairs = 8;
constexpr int kGroupPairs = 4;  // pairs of one cluster: 2 blocks each, 8 at most
constexpr int kSlice = 32768;   // bins a block owns: half of a pair's 256 x 256
constexpr int kSmemBytes = kSlice * 4 + kStages * kStageBytes + kStages * 8;

// Each pair of a launch row as a byte-permute selector: (ia << 4) | ib,
// so that __byte_perm(x, y, sel + 0x11 * k) & 0xffff is
// (byte ia << 8) | byte ib of the pixel whose bytes start at byte k of x:y.
struct Pairs {
  int np[2];  // pairs of each launch row
  int sel[2][kGroupPairs];
};

__device__ __forceinline__ void add_local(uint32_t address) {
  asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(address) : "memory");
}

__device__ __forceinline__ void barrier_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void barrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void barrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes from global memory to the same offset (dst) of the shared memory
// of every block of the cluster in mask, each block's barrier at offset
// bar counting them
__device__ __forceinline__ void multicast(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Counts the keys of this block's slice among a unit of 16 pixels (the
// 16 * C bytes of w): a key k of the pair with k >> 15 == half adds one to
// bin k & 0x7fff (hx = half << 15).
template <int C>
__device__ __forceinline__ void count_unit(const uint32_t (&w)[4 * C], uint32_t sel, uint32_t hx,
                                           uint32_t bins) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int first = (k * C) >> 2;  // the word of the pixel's first byte
    const uint32_t x = w[first];
    const uint32_t y = w[first + 1 < 4 * C ? first + 1 : first];
    const uint32_t v = (__byte_perm(x, y, sel + 0x11u * ((k * C) & 3)) & 0xffffu) ^ hx;
    if (v < 0x8000u) add_local(bins + 4u * v);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
jointhist_kernel(const uint8_t* __restrict__ px, uint32_t n, uint32_t head, Pairs pairs,
                 int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* bins = smem;            // this block's slice
  uint32_t* tile = smem + kSlice;   // kStages tiles of the band, as the band holds them
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t cs = cluster.num_blocks();
  const uint32_t rank = cluster.block_rank();
  const uint32_t cid = blockIdx.x / cs, nclusters = gridDim.x / cs;
  const uint32_t tid = threadIdx.x;
  const bool row0 = blockIdx.y == 0;
  const int np = row0 ? pairs.np[0] : pairs.np[1];
  // the slice this block owns: keys of pair rank / 2 of its launch row
  // whose first byte has its top bit equal to rank & 1
  const int pair = static_cast<int>(rank >> 1);
  const bool owner = pair < np;
  uint32_t sel = 0;
#pragma unroll
  for (int q = 0; q < kGroupPairs; ++q) {
    if (q == pair) sel = row0 ? pairs.sel[0][q] : pairs.sel[1][q];
  }
  const uint32_t hx = (rank & 1u) << 15;
  const uint32_t bins_at = static_cast<uint32_t>(__cvta_generic_to_shared(bins));
  const uint32_t tile_at = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  const uint32_t bar_at = tile_at + kStages * kStageBytes;  // kStages mbarriers

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) barrier_init(bar_at + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  uint4* zero = reinterpret_cast<uint4*>(bins);
  for (uint32_t i = tid; i < kSlice / 4; i += kThreads) zero[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // Units of 16 pixels (16 * C bytes) from pixel head on, where the band's
  // bytes are 16-byte aligned: the cluster's contiguous range of them, in
  // tiles of one share per block.
  constexpr uint32_t kUnitBytes = 16 * C;
  const uint32_t units = n > head ? (n - head) / 16 : 0u;
  const uint32_t per = (units + nclusters - 1) / nclusters;
  const uint32_t u0 = min(units, cid * per), u1 = min(units, u0 + per);
  const uint32_t share = kStageBytes / kUnitBytes / cs;  // units of one block's share
  const uint32_t tile_units = cs * share;
  const uint32_t tiles = (u1 - u0 + tile_units - 1) / tile_units;
  const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1u);

  // the pixels before head and after the last unit: every owning block of
  // the first cluster counts its keys among them
  const uint32_t loose = n - units * 16;  // at most 15 + 15
  if (owner && cid == 0 && tid < loose) {
    const uint32_t i = tid < head ? tid : head + units * 16 + (tid - head);
    uint32_t x = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) x |= static_cast<uint32_t>(px[static_cast<size_t>(i) * C + c]) << (8 * c);
    const uint32_t v = (__byte_perm(x, 0, sel) & 0xffffu) ^ hx;
    if (v < 0x8000u) add_local(bins_at + 4u * v);
  }

  // by thread 0: expect tile t's bytes, and multicast this block's share
  // of it to every block of the cluster
  auto load_tile = [&](uint32_t t) {
    const uint32_t s = t % kStages;
    const uint32_t first = u0 + t * tile_units;
    barrier_expect(bar_at + 8 * s, min(tile_units, u1 - first) * kUnitBytes);
    const uint32_t mine = first + rank * share;
    if (mine < u1) {
      multicast(tile_at + s * kStageBytes + rank * share * kUnitBytes,
                px + (static_cast<size_t>(head) + 16ull * mine) * C,
                min(share, u1 - mine) * kUnitBytes, bar_at + 8 * s, mask);
    }
  };

  cluster.sync();  // every barrier initialised and every slice zeroed
  if (tid == 0) {
    for (uint32_t t = 0; t + 1 < kStages && t < tiles; ++t) load_tile(t);
  }
  for (uint32_t t = 0; t < tiles; ++t) {
    const uint32_t s = t % kStages;
    // the stage of tile t + kStages - 1 held tile t - 1, which every block
    // finished reading before the last cluster barrier
    if (tid == 0 && t + kStages - 1 < tiles) load_tile(t + kStages - 1);
    barrier_wait(bar_at + 8 * s, (t / kStages) & 1u);
    if (owner) {
      const uint32_t nu = min(tile_units, u1 - (u0 + t * tile_units));
      for (uint32_t u = tid; u < nu; u += kThreads) {
        uint32_t w[4 * C];
        const uint4* src =
            reinterpret_cast<const uint4*>(tile + (s * kStageBytes + u * kUnitBytes) / 4);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const uint4 v = src[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
        count_unit<C>(w, sel, hx, bins_at);
      }
    }
    // no block's stage is written again while a peer may still read it
    cluster.sync();
  }

  // flush this block's non-zero bins
  if (owner) {
    int* dst = out + static_cast<size_t>(blockIdx.y * (cs / 2) + pair) * (2 * kSlice) +
               (rank & 1u) * kSlice;
    const uint32_t start = (cid * (kSlice / nclusters)) & ~31u;
    for (uint32_t i = tid; i < kSlice; i += kThreads) {
      const uint32_t j = (i + start) & (kSlice - 1);
      const int v = static_cast<int>(bins[j]);
      if (v) atomicAdd(dst + j, v);
    }
  }
}

template <int C>
cudaError_t launch(const uint8_t* px, uint32_t n, const Pairs& pairs, int rows, int cluster,
                   int* out, cudaStream_t stream) {
  // the first pixel whose bytes start 16-byte aligned, as bulk copies need
  uint32_t head = 0;
  while ((reinterpret_cast<uintptr_t>(px) + head * C) % 16 != 0) ++head;
  auto kernel = jointhist_kernel<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, reinterpret_cast<const void*>(kernel), &cfg);
  if (e != cudaSuccess) return e;
  if (active < 1) return cudaErrorLaunchOutOfResources;
  // the resident clusters, split over the launch rows, and no more than
  // one per kMinPixelsPerCluster pixels
  const long long want =
      (static_cast<long long>(n) + kMinPixelsPerCluster - 1) / kMinPixelsPerCluster;
  const long long clusters =
      std::max(1LL, std::min(want, static_cast<long long>(active / rows)));
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster), rows);
  return cudaLaunchKernelEx(&cfg, kernel, px, n, head, pairs, out);
}

}  // namespace

// px: (n, channels) uint8, contiguous, 4-byte aligned, n < 2^31;
// channels in [1, 4]; ca, cb: npairs <= kMaxPairs channel numbers on the
// host; out: (npairs, 256, 256) int32 on the device, added to. One
// launch on stream.
RGNIR_EXPORT int rgnir_jointhist(const void* px, long long n, int channels, const int* ca,
                                 const int* cb, int npairs, void* out, void* stream) {
  if (n < 0 || n >= (1LL << 31) || channels < 1 || channels > 4 || npairs < 1 ||
      npairs > kMaxPairs || (reinterpret_cast<uintptr_t>(px) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // up to kGroupPairs pairs in one launch row; 5-8 in two rows of
  // ceil(npairs / 2) and the rest
  const int rows = npairs <= kGroupPairs ? 1 : 2;
  const int per = (npairs + rows - 1) / rows;
  Pairs pairs{};
  for (int p = 0; p < npairs; ++p) {
    if (ca[p] < 0 || ca[p] >= channels || cb[p] < 0 || cb[p] >= channels) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pairs.np[p / per] += 1;
    pairs.sel[p / per][p % per] = (ca[p] << 4) | cb[p];
  }
  cudaError_t e = cudaSuccess;
  if (n > 0) {
    auto s = static_cast<cudaStream_t>(stream);
    auto p = static_cast<const uint8_t*>(px);
    auto o = static_cast<int*>(out);
    const auto un = static_cast<uint32_t>(n);
    switch (channels) {
      case 1: e = launch<1>(p, un, pairs, rows, 2 * per, o, s); break;
      case 2: e = launch<2>(p, un, pairs, rows, 2 * per, o, s); break;
      case 3: e = launch<3>(p, un, pairs, rows, 2 * per, o, s); break;
      default: e = launch<4>(p, un, pairs, rows, 2 * per, o, s); break;
    }
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

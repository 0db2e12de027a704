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
// P * 65,536 bins, so memory bounds it: 60 µs for a 2048 x 32768 band of
// three channels at 3.35 TB/s. What holds this first design back is the
// rate of the atomics on the bins, up to one per pixel and pair. Design:
//
// - A pair's bins are 256 KB, more than the 227 KB of shared memory a
//   block can have, so the counts go to the bins in device memory by
//   global atomics, which the 50 MB L2 keeps resident.
// - Equal keys are aggregated within each warp first: __match_any_sync
//   gives the lanes holding one key, and only the lowest of them adds
//   their count. Smooth bands, with long runs of one value, cost one
//   atomic per warp and pixel slot; uniform bytes one per lane.
// - A thread takes four pixels at a time as C whole 32-bit words (three
//   for C = 3, as fused.cu reads its frames), in a grid-stride loop that
//   every lane of a warp runs the same number of times, so the match
//   always has the full warp; lanes past the end hold no key.
// - The band is read as it is, interleaved with stride C: the kernel
//   picks each pair's channels, so the host sends the band whole.
// - The pixels after the last group of four, one per lane of the first
//   block's first warp.
// - Counts are integers: exact in any order. One band holds fewer than
//   2^31 pixels (the wrapper's limit), so no int32 bin overflows.
//
// A cluster of two blocks, each holding half of a pair's bins in its
// shared memory and reaching the other half through distributed shared
// memory, is the Hopper redesign that would take the atomics off the L2
// (ROADMAP.md).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxPairs = 8;
constexpr int kBins = 256 * 256;
constexpr uint32_t kNoKey = 0xffffffffu;  // a lane with no pixel

struct Pairs {
  int np;
  int a[kMaxPairs];
  int b[kMaxPairs];
};

// ch[c] for a channel c known only at run time, by selects (no local
// memory).
template <int C>
__device__ __forceinline__ uint32_t pick(const uint32_t (&ch)[C], int c) {
  uint32_t v = ch[0];
#pragma unroll
  for (int i = 1; i < C; ++i) v = c == i ? ch[i] : v;
  return v;
}

// Every lane of the warp calls this: the lanes holding one key add their
// number to its bin with one atomic, from the lowest of them.
__device__ __forceinline__ void warp_count(int* bins, uint32_t key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (key != kNoKey && static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(bins + key, __popc(peers));
  }
}

// The pairs' keys of one pixel (channels ch), counted by the warp.
template <int C>
__device__ __forceinline__ void count_pixel(const uint32_t (&ch)[C], bool live,
                                            const Pairs& pairs, int* out) {
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p >= pairs.np) break;
    const uint32_t key =
        live ? (pick<C>(ch, pairs.a[p]) << 8) | pick<C>(ch, pairs.b[p]) : kNoKey;
    warp_count(out + p * kBins, key);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
jointhist_kernel(const uint8_t* __restrict__ px, long long n, Pairs pairs,
                 int* __restrict__ out) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(px);
  const int lane = threadIdx.x & 31;
  const long long groups = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  // the warp's first group: the same for all its lanes, so the loop is
  // warp-uniform
  for (long long g0 = static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
       g0 < groups; g0 += stride) {
    const long long g = g0 + lane;
    const bool live = g < groups;
    uint32_t w[C];
#pragma unroll
    for (int i = 0; i < C; ++i) w[i] = live ? __ldg(words + C * g + i) : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t ch[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = k * C + c;  // the byte of pixel k, channel c, in the group
        ch[c] = (w[j >> 2] >> (8 * (j & 3))) & 255u;
      }
      count_pixel<C>(ch, live, pairs, out);
    }
  }
  // the last n % 4 pixels
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long i = groups * 4 + lane;
    const bool live = i < n;
    uint32_t ch[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ch[c] = live ? px[i * C + c] : 0u;
    count_pixel<C>(ch, live, pairs, out);
  }
}

template <int C>
void launch(dim3 grid, cudaStream_t stream, const uint8_t* px, long long n,
            const Pairs& pairs, int* out) {
  jointhist_kernel<C><<<grid, kThreads, 0, stream>>>(px, n, pairs, out);
}

}  // namespace

// px: (n, channels) uint8, contiguous, 4-byte aligned, n < 2^31;
// channels in [1, 4]; ca, cb: npairs <= kMaxPairs channel numbers on the
// host; out: (npairs, 256, 256) int32 on the device, added to.
RGNIR_EXPORT int rgnir_jointhist(const void* px, long long n, int channels, const int* ca,
                                 const int* cb, int npairs, void* out, void* stream) {
  if (n < 0 || n >= (1LL << 31) || channels < 1 || channels > 4 || npairs < 1 ||
      npairs > kMaxPairs || (reinterpret_cast<uintptr_t>(px) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pairs pairs{};
  pairs.np = npairs;
  for (int p = 0; p < npairs; ++p) {
    if (ca[p] < 0 || ca[p] >= channels || cb[p] < 0 || cb[p] >= channels) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pairs.a[p] = ca[p];
    pairs.b[p] = cb[p];
  }
  if (n > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // the resident grid, and no more blocks than give every thread a group
    const long long want = (n / 4 + kThreads - 1) / kThreads;
    const long long blocks =
        std::max(1LL, std::min(want, static_cast<long long>(sms) * kBlocksPerSM));
    const dim3 grid(static_cast<unsigned>(blocks));
    auto s = static_cast<cudaStream_t>(stream);
    auto p = static_cast<const uint8_t*>(px);
    auto o = static_cast<int*>(out);
    switch (channels) {
      case 1: launch<1>(grid, s, p, n, pairs, o); break;
      case 2: launch<2>(grid, s, p, n, pairs, o); break;
      case 3: launch<3>(grid, s, p, n, pairs, o); break;
      default: launch<4>(grid, s, p, n, pairs, o); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

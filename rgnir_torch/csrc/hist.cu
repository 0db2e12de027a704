// Per-channel 256-bin histograms of interleaved (B, H, W, 3) uint8 frames.
//
// Replaces rgnir_tpu/kernels/hist.py:_hist_kernel (its call sites
// _hist_call, one frame, and _hist_call_batched, a batch). The TPU
// kernel counted through nibble one-hots on the MXU over a planar copy
// of the frames; here the interleaved bytes are read as they are.
//
// Bound: it reads each input byte once (B*H*W*3 bytes) and writes
// B*3*256 counts, so memory bounds it: 25.2 MB for 8 x 1024^2 frames.
// What holds a simple version back is too few bytes in flight (one
// 4-byte load per thread, then four shared atomics before the next).
// With the loads below the reads run at the card's memory rate, and the
// rate of shared atomics, one per byte, is what is left (PERF.md has
// the times, taken on an NVIDIA H100 80GB HBM3 at 700 W, and those of
// the variants named here, from tools/kernel_variants.py). Design:
//
// - A frame's body is cut into warp items of 1536 bytes from its first
//   16-byte aligned address. A warp reads an item as three coalesced
//   16-byte loads per lane (rows of 512 bytes), and issues the next
//   item's three loads before it counts this one's, so every lane keeps
//   48 to 96 bytes in flight. The grid is a few blocks per SM (from the
//   device's properties), each warp striding over its frame's items.
// - 1536, 512 and 16 are 0, 2 and 1 modulo 3, so the channel of byte j of
//   a lane's r-th load is (head + lane + 2r + j) mod 3: three per-lane
//   histogram bases, picked by compile-time (2r + j) mod 3. No modulo in
//   the loop.
// - Counts go to one shared histogram per block (3 KB), one add of 1 per
//   byte. Such an add aggregates the lanes of a warp that hit one word in
//   hardware, so smooth frames (most lanes in one bin) cost no more than
//   uniform bytes. A copy per warp or per lane measured no faster;
//   combining equal neighbours in a lane first, and aggregation with
//   __match_any_sync, measured slower.
// - The bytes before the aligned body and after its last whole item are
//   counted one per thread step by the frame's first block.
// - The block adds each nonzero bin to the frame's global counts with
//   one atomic. Counts are integers: exact in any order.
// - Positional validity (the TPU kernel's n_valid, for the sharded
//   mosaic): only the first frame_bytes bytes of each frame, its valid
//   length, are read and counted, and the frames lie frame_stride bytes
//   apart. So the mask costs nothing: a masked frame is a shorter frame,
//   its ragged end (mid-pixel, mid-word) counted one byte per thread like
//   any frame's tail, and by default the two are equal.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxBlocksPerSM = 64;  // the most a caller may ask for
constexpr int kRowBytes = 32 * 16;        // one coalesced 16-byte load per lane
constexpr int kItemBytes = 3 * kRowBytes;  // a warp item: a multiple of 3 and 16

// Counts bytes j0, j0 + 3, ... of the 16 bytes of v (those of one
// channel) into h.
template <int j0>
__device__ __forceinline__ void count_channel(const uint4& v, int* h) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = j0; j < 16; j += 3) {
    atomicAdd(h + ((w[j >> 2] >> (8 * (j & 3))) & 255u), 1);
  }
}

// h0, h1, h2: the histograms of the channels of bytes 0, 1, 2 of v.
__device__ __forceinline__ void count16(const uint4& v, int* h0, int* h1, int* h2) {
  count_channel<0>(v, h0);
  count_channel<1>(v, h1);
  count_channel<2>(v, h2);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ img, long long frame_stride,
            long long frame_bytes, int* __restrict__ out) {
  __shared__ int sh[3 * 256];

  const int frame = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* base = img + static_cast<long long>(frame) * frame_stride;
  int* h = sh;

  // Bytes before the first 16-byte aligned address of the frame.
  const long long head = min(
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15),
      frame_bytes);
  const long long items = (frame_bytes - head) / kItemBytes;
  const uint8_t* body = base + head;

  // The histogram of the channel of byte (2r + j) mod 3 == c of this lane.
  const int ph = static_cast<int>((head + lane) % 3);
  int* hc0 = h + 256 * ph;
  int* hc1 = h + 256 * (ph == 2 ? 0 : ph + 1);
  int* hc2 = h + 256 * (ph == 0 ? 2 : ph - 1);

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  long long it = static_cast<long long>(blockIdx.x) * kWarps + warp;
  uint4 a0, a1, a2;
  if (it < items) {
    const uint4* p = reinterpret_cast<const uint4*>(body + it * kItemBytes) + lane;
    a0 = __ldg(p);
    a1 = __ldg(p + 32);
    a2 = __ldg(p + 64);
  }
  // the histograms are cleared while the first loads are in flight
  for (int i = threadIdx.x; i < 768; i += kThreads) sh[i] = 0;
  __syncthreads();
  while (it < items) {
    const long long nx = it + stride;
    uint4 b0, b1, b2;
    if (nx < items) {
      const uint4* p = reinterpret_cast<const uint4*>(body + nx * kItemBytes) + lane;
      b0 = __ldg(p);
      b1 = __ldg(p + 32);
      b2 = __ldg(p + 64);
    }
    count16(a0, hc0, hc1, hc2);  // row 0: channel of byte j is c = j mod 3
    count16(a1, hc2, hc0, hc1);  // row 1: c = (2 + j) mod 3
    count16(a2, hc1, hc2, hc0);  // row 2: c = (1 + j) mod 3
    a0 = b0;
    a1 = b1;
    a2 = b2;
    it = nx;
  }

  // The head and what follows the last whole item, by the first block.
  if (blockIdx.x == 0) {
    const long long tail = head + items * kItemBytes;
    const long long edge = head + (frame_bytes - tail);
    for (long long i = threadIdx.x; i < edge; i += kThreads) {
      const long long j = i < head ? i : tail + (i - head);
      atomicAdd(&h[(j % 3) * 256 + base[j]], 1);
    }
  }
  __syncthreads();

  int* dst = out + static_cast<long long>(frame) * 768;
  for (int bin = threadIdx.x; bin < 768; bin += kThreads) {
    if (sh[bin]) atomicAdd(dst + bin, sh[bin]);
  }
}

}  // namespace

// img: (frames, H, W, 3) uint8, contiguous, frames stride bytes apart;
// the first valid bytes of each frame (valid <= stride, a multiple of 3)
// are counted into out: (frames, 3, 256) int32, zeroed by the caller.
// blocks_per_sm: the resident blocks an SM is given (the grid's only
// tunable, rgnir_torch/utils/autotune.py); 0 takes kBlocksPerSM.
RGNIR_EXPORT int rgnir_hist(const void* img, long long frames, long long stride,
                            long long valid, void* out, int blocks_per_sm,
                            void* stream) {
  if (valid < 0 || valid > stride || valid % 3 != 0 || blocks_per_sm < 0 ||
      blocks_per_sm > kMaxBlocksPerSM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (frames > 0 && stride > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // Blocks of a frame: its share of the resident grid, and no more than
    // give every warp an item.
    const long long resident =
        static_cast<long long>(sms) * (blocks_per_sm > 0 ? blocks_per_sm : kBlocksPerSM);
    const long long want = (valid / kItemBytes + kWarps - 1) / kWarps;
    const long long per_frame =
        std::max(1LL, std::min(want, (resident + frames - 1) / frames));
    dim3 grid(static_cast<unsigned>(per_frame), static_cast<unsigned>(frames));
    hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), stride, valid, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Per-channel 256-bin histograms of interleaved (B, H, W, 3) uint8 frames.
//
// Replaces rgnir_tpu/kernels/hist.py:_hist_kernel (its call sites
// _hist_call, one frame, and _hist_call_batched, a batch). The TPU
// kernel counted through nibble one-hots on the MXU over a planar copy
// of the frames; here the interleaved bytes are read as they are, with
// the channel of a byte its offset within the frame modulo 3.
//
// Bound: it reads each input byte once (B*H*W*3 bytes) and writes
// B*3*256 counts, so memory bounds it: 25.2 MB for 8 x 1024^2 frames,
// about 7.5 us at 3.35 TB/s. Design: a grid of (chunk, frame) blocks;
// each thread loads 32-bit words and adds to a shared-memory histogram
// private to its warp, so warps never contend with one another; the
// block then sums its warp copies and adds each nonzero bin to the
// frame's global counts with one atomic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kBytesPerBlock = 48 * 1024;  // a multiple of 3 and 4

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ img, long long frame_bytes,
            int* __restrict__ out) {
  __shared__ int sh[kWarps][3 * 256];
  int* flat = &sh[0][0];
  for (int i = threadIdx.x; i < kWarps * 768; i += kThreads) flat[i] = 0;
  __syncthreads();

  const int frame = blockIdx.y;
  const uint8_t* base = img + static_cast<long long>(frame) * frame_bytes;
  const long long start = static_cast<long long>(blockIdx.x) * kBytesPerBlock;
  const long long end = min(start + kBytesPerBlock, frame_bytes);
  int* h = sh[threadIdx.x >> 5];

  // Bytes before the first 4-byte aligned address, one per thread.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + start);
  const long long head = min(static_cast<long long>((4 - (addr & 3)) & 3),
                             end - start);
  if (threadIdx.x < head) {
    const long long j = start + threadIdx.x;
    atomicAdd(&h[(j % 3) * 256 + base[j]], 1);
  }
  const long long body = start + head;
  const long long nwords = (end - body) >> 2;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(base + body);
  for (long long w = threadIdx.x; w < nwords; w += kThreads) {
    const uint32_t v = __ldg(words + w);
    int ch = static_cast<int>((body + 4 * w) % 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      atomicAdd(&h[ch * 256 + ((v >> (8 * i)) & 255u)], 1);
      ch = (ch == 2) ? 0 : ch + 1;
    }
  }
  // Bytes after the last whole word.
  const long long tail = body + 4 * nwords;
  if (tail + threadIdx.x < end) {
    const long long j = tail + threadIdx.x;
    atomicAdd(&h[(j % 3) * 256 + base[j]], 1);
  }
  __syncthreads();

  int* dst = out + static_cast<long long>(frame) * 768;
  for (int bin = threadIdx.x; bin < 768; bin += kThreads) {
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += sh[wi][bin];
    if (s) atomicAdd(dst + bin, s);
  }
}

}  // namespace

// img: (frames, H, W, 3) uint8, contiguous; out: (frames, 3, 256) int32,
// zeroed by the caller.
RGNIR_EXPORT int rgnir_hist(const void* img, long long frames,
                            long long frame_bytes, void* out, void* stream) {
  if (frames > 0 && frame_bytes > 0) {
    dim3 grid(static_cast<unsigned>((frame_bytes + kBytesPerBlock - 1) / kBytesPerBlock),
              static_cast<unsigned>(frames));
    hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(img), frame_bytes, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

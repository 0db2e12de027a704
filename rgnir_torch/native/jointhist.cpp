// Host-side 256x256 joint-histogram accumulator for the streamed
// gigapixel path's reduce="host" (rgnir_torch/pipeline/gigapixel.py).
//
// A copy of rgnir_tpu/native/jointhist.cpp with the same C ABI. The
// streamed band reduction is exact because white balance and index
// statistics are a function of the joint histogram of the two channels
// an index references (see pipeline/gigapixel.py). On the card the
// jointhist CUDA kernel (rgnir_torch/csrc/jointhist.cu) accumulates the
// bands; this accumulator is the route that never touches the device.
// Both feed the same 65536-bin closure, so the results are identical.
//
// C ABI (ctypes, see jointhist.py):
//   jh_accumulate(px, n, stride, ca, cb, npairs, hist, n_threads)
//     px:     n rows of `stride` uint8 channels (C-contiguous)
//     ca/cb:  npairs channel-index pairs into [0, stride)
//     hist:   npairs * 65536 uint32 bins, ADDED TO in place
//     n_threads: <=1 single-threaded; else split rows, merge privates
// Caller guarantees n < 2^32 - existing bin counts (the Python layer
// flushes to int64 per band, far below that).
//
// Built with -march=native where the compiler takes it
// (rgnir_torch/native/_build.py), which enables the AVX-512 path below on
// hosts that have AVX-512 VBMI.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
#define JH_HAVE_AVX512 1
#include <immintrin.h>
#endif

namespace {

constexpr int kBins = 256 * 256;

#ifdef JH_HAVE_AVX512
// AVX-512 VBMI bin-gather + run-length-coalesced increment sweep for
// the single-pair stride-3 case. One vpermb per channel turns a
// 64-byte load (16 pixels + over-read) into contiguous u16 bins,
// removing the strided address math from the critical path. Same-host
// interleaved A/B vs the scalar loop below (measured for the JAX
// package's copy, 24 MPix x 9 rounds, median): 64-px runs 1010 vs 565
// MPix/s (+79%), 2-bin ripple 624 vs 562 (+11%), uniform noise 711 vs
// 835 (-15%) —
// the scalar loop keeps noise-like content (see prefer_simd).
void simd_coalesced_range(const uint8_t* px, int64_t begin, int64_t end,
                          int a, int b, uint32_t* hist) {
  constexpr int64_t B = 8192;
  alignas(64) uint16_t bins[B];
  alignas(64) uint8_t idxa[64], idxb[64];
  for (int i = 0; i < 16; ++i) {
    idxa[i] = static_cast<uint8_t>(3 * i + a);
    idxb[i] = static_cast<uint8_t>(3 * i + b);
  }
  for (int i = 16; i < 64; ++i) idxa[i] = idxb[i] = 0;
  const __m512i va = _mm512_load_si512(idxa);
  const __m512i vb = _mm512_load_si512(idxb);
  if (begin >= end) return;
  // 16 px per iteration reads 48 + 16 bytes of over-read: stop 6 px
  // short of `end` so the read never passes the caller's range (a
  // threaded sibling owns the bytes beyond it, but the BUFFER may
  // also end exactly at `end`).
  const int64_t simd_end =
      (end - begin > 22)
          ? begin + ((end - 6 - begin) & ~int64_t(15))
          : begin;
  const uint8_t* p0 = px + begin * 3;
  uint32_t prev = (static_cast<uint32_t>(p0[a]) << 8) | p0[b];
  uint32_t count = 0;
  for (int64_t base = begin; base < simd_end; base += B) {
    const int64_t m = (simd_end - base) < B ? (simd_end - base) : B;
    const uint8_t* p = px + base * 3;
    for (int64_t k = 0; k + 16 <= m; k += 16) {
      const __m512i z = _mm512_loadu_si512(p + k * 3);
      const __m128i av =
          _mm512_castsi512_si128(_mm512_permutexvar_epi8(va, z));
      const __m128i bv =
          _mm512_castsi512_si128(_mm512_permutexvar_epi8(vb, z));
      // bin = (A << 8) | B -> u16 with low byte B, high byte A.
      _mm_store_si128(reinterpret_cast<__m128i*>(bins + k),
                      _mm_unpacklo_epi8(bv, av));
      _mm_store_si128(reinterpret_cast<__m128i*>(bins + k + 8),
                      _mm_unpackhi_epi8(bv, av));
    }
    for (int64_t k = 0; k < m; ++k) {
      const uint32_t bin = bins[k];
      if (bin == prev) {
        ++count;
      } else {
        hist[prev] += count;
        prev = bin;
        count = 1;
      }
    }
  }
  for (int64_t i = simd_end; i < end; ++i) {
    const uint8_t* row = px + i * 3;
    const uint32_t bin = (static_cast<uint32_t>(row[a]) << 8) | row[b];
    if (bin == prev) {
      ++count;
    } else {
      hist[prev] += count;
      prev = bin;
      count = 1;
    }
  }
  hist[prev] += count;
}

// Content probe: the SIMD sweep wins on coalescible content (adjacent
// runs) and on small working sets of bins (palette-like content whose
// same-bin store chains throttle the scalar loop's wider body); the
// scalar loop wins only on high-entropy noise-like content. Sample
// ~2048 adjacent pairs evenly across the range; runs OR a small
// distinct-bin count pick SIMD.
bool prefer_simd(const uint8_t* px, int64_t begin, int64_t end, int a,
                 int b) {
  const int64_t n = end - begin;
  if (n < (1 << 16)) return false;  // too small for the probe to pay
  const int64_t samples = 2048;
  const int64_t step = n / samples;
  int64_t equal = 0;
  static thread_local uint8_t seen[kBins / 8];
  std::memset(seen, 0, sizeof(seen));
  int distinct = 0;
  for (int64_t s = 0; s < samples; ++s) {
    const uint8_t* row = px + (begin + s * step) * 3;
    const uint32_t bin0 = (static_cast<uint32_t>(row[a]) << 8) | row[b];
    const uint32_t bin1 =
        (static_cast<uint32_t>(row[3 + a]) << 8) | row[3 + b];
    equal += (bin0 == bin1);
    if (!(seen[bin0 >> 3] & (1u << (bin0 & 7)))) {
      seen[bin0 >> 3] |= 1u << (bin0 & 7);
      ++distinct;
    }
  }
  return equal * 8 >= samples || distinct < (samples >> 2);
}
#endif  // JH_HAVE_AVX512

void accumulate_range(const uint8_t* px, int64_t begin, int64_t end,
                      int stride, const int* ca, const int* cb,
                      int npairs, uint32_t* hist) {
  if (npairs == 1) {
    // Run-length-coalesced increment: natural image bands carry long
    // runs of equal values, so consecutive pixels hit the SAME bin
    // and the plain ++hist[bin] loop serializes on its store-to-load
    // dependency (~5 cycles/px measured). Buffering the current run
    // and adding its length once turns a run of R into one update;
    // the bin-equality branch is period-predictable on both extremes
    // (always-equal in runs, always-different in noise), so this is
    // never slower than the plain loop and much faster on runs.
    // Same-host A/B, 32 MPix x3 channels: uniform noise 865 vs 844
    // MPix/s, 64-px runs 676 vs 439, 2-bin ripple 576 vs 575.
    // (A 4-way sub-histogram split was also measured: it wins only on
    // the ripple case and loses on noise from L2 pressure — rejected.)
    // Totals are identical: hist[bin] += run is the same adds in the
    // same u32 counters, just batched.
    const int a = ca[0], b = cb[0];
    if (begin >= end) return;
#ifdef JH_HAVE_AVX512
    if (stride == 3 && prefer_simd(px, begin, end, a, b)) {
      simd_coalesced_range(px, begin, end, a, b, hist);
      return;
    }
#endif
    const uint8_t* row = px + begin * stride;
    uint32_t prev = (static_cast<uint32_t>(row[a]) << 8) | row[b];
    uint32_t count = 1;
    for (int64_t i = begin + 1; i < end; ++i) {
      row = px + i * stride;
      const uint32_t bin = (static_cast<uint32_t>(row[a]) << 8) | row[b];
      if (bin == prev) {
        ++count;
      } else {
        hist[prev] += count;
        prev = bin;
        count = 1;
      }
    }
    hist[prev] += count;
    return;
  }
  for (int64_t i = begin; i < end; ++i) {
    const uint8_t* row = px + i * stride;
    for (int p = 0; p < npairs; ++p) {
      ++hist[p * kBins +
             ((static_cast<uint32_t>(row[ca[p]]) << 8) | row[cb[p]])];
    }
  }
}

}  // namespace

extern "C" {

int jh_accumulate(const uint8_t* px, int64_t n, int stride,
                  const int* ca, const int* cb, int npairs,
                  uint32_t* hist, int n_threads) {
  if (n < 0 || stride <= 0 || npairs <= 0) return 1;
  for (int p = 0; p < npairs; ++p) {
    if (ca[p] < 0 || ca[p] >= stride || cb[p] < 0 || cb[p] >= stride)
      return 1;
  }
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads < 1) n_threads = 1;
  }
  // Below ~4M pixels thread spawn + merge overhead beats the win.
  if (n_threads == 1 || n < (1 << 22)) {
    accumulate_range(px, 0, n, stride, ca, cb, npairs, hist);
    return 0;
  }
  const size_t bins = static_cast<size_t>(npairs) * kBins;
  std::vector<std::vector<uint32_t>> privates(
      n_threads, std::vector<uint32_t>(bins, 0));
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t begin = t * per;
    const int64_t end = begin + per < n ? begin + per : n;
    if (begin >= end) break;
    threads.emplace_back(accumulate_range, px, begin, end, stride, ca,
                         cb, npairs, privates[t].data());
  }
  for (auto& th : threads) th.join();
  for (auto& priv : privates)
    for (size_t i = 0; i < bins; ++i) hist[i] += priv[i];
  return 0;
}

}  // extern "C"

#!/usr/bin/env python3
"""Time design variants of the hist, fused, one-pass select and
jointhist kernels on one CUDA card.

    python3 tools/kernel_variants.py [--only hist|fused|onepass|jointhist] [--sass]

Each variant is the shipped source (``rgnir_torch/csrc/hist.cu``,
``fused.cu``, ``onepass.cu`` or ``jointhist.cu``) with a few exact text
substitutions: a constant (blocks per SM, threads, histogram copies,
stages) or the body of one helper (how a byte or a bin is counted). A substitution whose text is no
longer in the source raises, so the list cannot drift from the kernels
silently. The variants build side by side with ``nvcc`` into ``build/kernel_variants/``, one
process each, and run through the package's own wrappers, so a time here
means what ``chip_smoke.py``'s kernel table means (``tools/card_timing.py``'s
``Timer``): the median of 20 launches, L2 flushed before each, the stream
held so that only device time counts.

Every hist and fused variant runs on two inputs at 8 x 1024^2 x 3:
uniform random bytes and the smooth field (long runs of
equal values, a saturated and a black region), in turns with the shipped
kernel; the one-pass select's on the (a1) path's rows of those two and
of a constant frame (``tests/torch_card.py``'s ``onepass_inputs``);
jointhist's on two 2048 x 32768 x 3 bands (``jointhist_bands``) with the main path's two
pairs (``--only jointhist``, not part of the default run). A variant that is a
design candidate is held against the plain version first; one marked
``diagnostic`` leaves work out on purpose (no shared atomics, no render
stores, no round-0 bin work) to show what the shipped kernel spends there,
and its output is not checked. ``--sass`` also writes the shipped fused
kernel's SASS (three kinds, renders, histogram) and prints its
instruction count per loop step. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

KINDS = ("NDVI", "GNDVI", "NDWI")
SHAPE = (8, 1024, 1024)

# --- the variants: name -> (diagnostic, [(old text, new text), ...]) ----------

HIST_COUNT = """#pragma unroll
  for (int j = j0; j < 16; j += 3) {
    atomicAdd(h + ((w[j >> 2] >> (8 * (j & 3))) & 255u), 1);
  }
"""

HIST_RUN_LENGTH = (HIST_COUNT, """  uint32_t cur = (w[j0 >> 2] >> (8 * (j0 & 3))) & 255u;
  int run = 1;
#pragma unroll
  for (int j = j0 + 3; j < 16; j += 3) {
    const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 255u;
    if (b == cur) {
      ++run;
    } else {
      atomicAdd(h + cur, run);
      cur = b;
      run = 1;
    }
  }
  atomicAdd(h + cur, run);
""")

HIST_MATCH = (HIST_COUNT, """#pragma unroll
  for (int j = j0; j < 16; j += 3) {
    int* bin = h + ((w[j >> 2] >> (8 * (j & 3))) & 255u);
    const unsigned peers = __match_any_sync(
        0xffffffffu, static_cast<unsigned>(__cvta_generic_to_shared(bin)));
    if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(bin, __popc(peers));
  }
""")

HIST_NO_COUNT = (HIST_COUNT, """  if ((w[0] ^ w[1] ^ w[2] ^ w[3]) == 0x9e3779b9u) atomicAdd(h + j0, 1);
""")


def hist_blocks(n):
    return ("constexpr int kBlocksPerSM = 4;", f"constexpr int kBlocksPerSM = {n};")


HIST_CLEAR = "  for (int i = threadIdx.x; i < 768; i += kThreads) sh[i] = 0;"
HIST_FLUSH = "    if (sh[bin]) atomicAdd(dst + bin, sh[bin]);"
HIST_LANE_COPIES = [
    ("  __shared__ int sh[3 * 256];", "  __shared__ int sh[8 * 3 * 256];"),
    ("  int* h = sh;", "  int* h = sh + (lane & 7);"),
    (HIST_CLEAR, "  for (int i = threadIdx.x; i < 8 * 768; i += kThreads) sh[i] = 0;"),
    ("  int* hc0 = h + 256 * ph;", "  int* hc0 = h + 2048 * ph;"),
    ("  int* hc1 = h + 256 * (ph == 2 ? 0 : ph + 1);",
     "  int* hc1 = h + 2048 * (ph == 2 ? 0 : ph + 1);"),
    ("  int* hc2 = h + 256 * (ph == 0 ? 2 : ph - 1);",
     "  int* hc2 = h + 2048 * (ph == 0 ? 2 : ph - 1);"),
    ("    atomicAdd(h + ((w[j >> 2] >> (8 * (j & 3))) & 255u), 1);",
     "    atomicAdd(h + 8 * ((w[j >> 2] >> (8 * (j & 3))) & 255u), 1);"),
    ("      atomicAdd(&h[(j % 3) * 256 + base[j]], 1);",
     "      atomicAdd(&h[8 * ((j % 3) * 256 + base[j])], 1);"),
    (HIST_FLUSH, """    int s = 0;
    for (int c = 0; c < 8; ++c) s += sh[8 * bin + ((c + bin) & 7)];
    if (s) atomicAdd(dst + bin, s);"""),
]
HIST_WARP_COPIES = [
    ("  __shared__ int sh[3 * 256];", "  __shared__ int sh[kWarps * 3 * 256];"),
    ("  int* h = sh;", "  int* h = sh + 768 * warp;"),
    (HIST_CLEAR, "  for (int i = threadIdx.x; i < kWarps * 768; i += kThreads) sh[i] = 0;"),
    (HIST_FLUSH, """    int s = 0;
    for (int wi = 0; wi < kWarps; ++wi) s += sh[768 * wi + bin];
    if (s) atomicAdd(dst + bin, s);"""),
]
HIST_THREADS_512 = ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")

HIST_VARIANTS = {
    "blocks/SM 2": (False, [hist_blocks(2)]),
    "blocks/SM 3": (False, [hist_blocks(3)]),
    "blocks/SM 6": (False, [hist_blocks(6)]),
    "blocks/SM 8": (False, [hist_blocks(8)]),
    "512 threads, blocks/SM 2": (False, [HIST_THREADS_512, hist_blocks(2)]),
    "a histogram per warp (8 x 3 KB)": (False, HIST_WARP_COPIES),
    "a histogram per warp, blocks/SM 8": (False, HIST_WARP_COPIES + [hist_blocks(8)]),
    "8 copies by lane, shared by the block's warps": (False, HIST_LANE_COPIES),
    "an add of a run-time 1 (no hardware aggregation of equal lanes)": (False, [
        ("    atomicAdd(h + ((w[j >> 2] >> (8 * (j & 3))) & 255u), 1);",
         "    atomicAdd(h + ((w[j >> 2] >> (8 * (j & 3))) & 255u), static_cast<int>(gridDim.z));")]),
    "equal neighbours of a lane combined": (False, [HIST_RUN_LENGTH]),
    "equal neighbours combined, blocks/SM 8": (False, [HIST_RUN_LENGTH, hist_blocks(8)]),
    "__match_any_sync per byte": (False, [HIST_MATCH]),
    "no shared atomics": (True, [HIST_NO_COUNT]),
    "no loads and no atomics (clear, flush and launch only)": (True, [
        ("  const long long items = (frame_bytes - head) / kItemBytes;",
         "  const long long items = 0;"),
        ("  if (blockIdx.x == 0) {\n    const long long tail",
         "  if (blockIdx.x == gridDim.x) {\n    const long long tail")]),
}

FUSED_ADD50 = "          atomicAdd(&s_h50[k * kBins + min(bin, kBins - 1)], 1);"
FUSED_ADDR0 = "        if (count_r0) atomicAdd(&s_r0[k * kBytes + byte], 1);"


def fused_copies(c50, cr0, by):
    """c50 / cr0 copies of each bin (8 / 2 in the generic body, whose shared
    memory must stay under 48 KB), the copy picked by the lane or the warp."""
    c50, cr0 = f"(NK ? {c50} : 8)", f"(NK ? {cr0} : 2)"
    return [
        ("  __shared__ int s_h50[kHist ? KK * kBins : 1];",
         f"  __shared__ int s_h50[kHist ? KK * kBins * {c50} : 1];"),
        ("  __shared__ int s_r0[KK * kBytes];", f"  __shared__ int s_r0[KK * kBytes * {cr0}];"),
        ("    for (int i = tid; i < nk * kBins; i += kThreads) s_h50[i] = 0;",
         f"    for (int i = tid; i < nk * kBins * {c50}; i += kThreads) s_h50[i] = 0;"),
        ("  for (int i = tid; i < nk * kBytes; i += kThreads) s_r0[i] = 0;",
         f"  for (int i = tid; i < nk * kBytes * {cr0}; i += kThreads) s_r0[i] = 0;"),
        (FUSED_ADD50,
         f"          atomicAdd(&s_h50[(k * kBins + min(bin, kBins - 1)) * {c50} + ({by} & ({c50} - 1))], 1);"),
        (FUSED_ADDR0,
         f"        if (count_r0) atomicAdd(&s_r0[(k * kBytes + byte) * {cr0} + ({by} & ({cr0} - 1))], 1);"),
        ("      if (s_h50[i]) atomicAdd(hist50 + b * p.kstride * kBins + i, s_h50[i]);",
         f"""      int s = 0;
      for (int c = 0; c < {c50}; ++c) s += s_h50[i * {c50} + ((c + lane) & ({c50} - 1))];
      if (s) atomicAdd(hist50 + b * p.kstride * kBins + i, s);"""),
        ("    const int s = s_r0[at] + ((i & 255) == 255 ? s_r0[at + 1] : 0);",
         f"""    int s = 0;
    for (int c = 0; c < {cr0} * ((i & 255) == 255 ? 2 : 1); ++c) s += s_r0[at * {cr0} + c];"""),
    ]


FUSED_MATCH = [
    (FUSED_ADD50, """          {
            int* word = &s_h50[k * kBins + min(bin, kBins - 1)];
            const unsigned peers = __match_any_sync(
                __activemask(), static_cast<unsigned>(__cvta_generic_to_shared(word)));
            if (lane == __ffs(peers) - 1) atomicAdd(word, __popc(peers));
          }"""),
    (FUSED_ADDR0, """        if (count_r0) {
          int* word = &s_r0[k * kBytes + byte];
          const unsigned peers = __match_any_sync(
              __activemask(), static_cast<unsigned>(__cvta_generic_to_shared(word)));
          if (lane == __ffs(peers) - 1) atomicAdd(word, __popc(peers));
        }"""),
]
FUSED_NO_ATOMICS = [
    (FUSED_ADD50, "          if (bin == 77) atomicAdd(&s_h50[0], 1);"),
    (FUSED_ADDR0, "        if (count_r0 && byte == 777) atomicAdd(&s_r0[0], 1);"),
]
FUSED_NO_RGB_STORES = [("""            dst[0] = __byte_perm(col[0], col[1], 0x4210);
            dst[1] = __byte_perm(col[1], col[2], 0x5421);
            dst[2] = __byte_perm(col[2], col[3], 0x6542);""",
                        """            if ((col[0] ^ col[1] ^ col[2] ^ col[3]) == 0x9e3779b9u) {
              dst[0] = __byte_perm(col[0], col[1], 0x4210);
              dst[1] = __byte_perm(col[1], col[2], 0x5421);
              dst[2] = __byte_perm(col[2], col[3], 0x6542);
            }""")]
FUSED_NO_IDX_STORES = [(
    "          *reinterpret_cast<float4*>(irow) = make_float4(q[0], q[1], q[2], q[3]);",
    "          if (q[0] + q[1] == 7.0f) *reinterpret_cast<float4*>(irow) = "
    "make_float4(q[0], q[1], q[2], q[3]);")]
FUSED_LIBRARY_DIVISION = [(
    "        const float v = div_in_range(num, __fadd_rn(den, 1e-10f));",
    "        const float v = fminf(fmaxf(__fdiv_rn(num, __fadd_rn(den, 1e-10f)), -1.0f), 1.0f);")]
FUSED_NO_PREFETCH = [("""      if (gn < g1) {
        n0 = __ldg(words + 3 * gn);
        n1 = __ldg(words + 3 * gn + 1);
        n2 = __ldg(words + 3 * gn + 2);
      }
      const uint32_t cur[3] = {c0, c1, c2};""", """      const uint32_t cur[3] = {c0, c1, c2};"""),
                     ("""      c0 = n0;
      c1 = n1;
      c2 = n2;
      g = gn;""", """      if (gn < g1) {
        n0 = __ldg(words + 3 * gn);
        n1 = __ldg(words + 3 * gn + 1);
        n2 = __ldg(words + 3 * gn + 2);
      }
      c0 = n0;
      c1 = n1;
      c2 = n2;
      g = gn;""")]


FUSED_BIN = """          int bin = min(__float_as_int(__fadd_rd(__fmul_rn(u, 25.0f), kTwo23)) - kTwo23Bits,
                        kBins - 1);
          bin += (v >= s_edges[bin + 1] ? 1 : 0) - (v < s_edges[bin] ? 1 : 0);
"""
FUSED_BIN_BRANCH = [(FUSED_BIN, """          const float t = __fmul_rn(u, 25.0f);
          const float fl = __fadd_rd(t, kTwo23);
          const float frac = __fsub_rn(t, __fsub_rn(fl, kTwo23));
          int bin = __float_as_int(fl) - kTwo23Bits;
          if (!(fabsf(__fsub_rn(frac, 0.5f)) < 0.499f)) {
            bin = max(0, min(bin, kBins - 1));
            while (bin < kBins - 1 && v >= s_edges[bin + 1]) ++bin;
            while (bin > 0 && v < s_edges[bin]) --bin;
          }
""")]
FUSED_BIN_AFFINE_ONLY = [(FUSED_BIN, """          int bin = min(__float_as_int(__fadd_rd(__fmul_rn(u, 25.0f), kTwo23)) - kTwo23Bits,
                        kBins - 1);
""")]
FUSED_NO_DIVISION = [(
    "        const float v = div_in_range(num, __fadd_rn(den, 1e-10f));",
    "        const float v = __fmul_rn(num, __fmul_rn(__fadd_rn(den, 1e-10f), 7.6e-6f));")]
FUSED_NO_WB_TABLE = [("      e[j] = s_wb[(j % 3) * 256 + x[j]];",
                      "      e[j] = x[j] | kTwo23Bits;")]
FUSED_NO_STATS = [("""        t_sum[k] += v;
        t_min[k] = fminf(t_min[k], v);
        t_max[k] = fmaxf(t_max[k], v);
        t_above[k] += __float_as_uint(__fsub_rn(thr, v)) >> 31;  // v > thr
""", """        t_sum[k] = v + thr;
""")]
FUSED_NO_LUT = [("        if (kRenders) col[i] = ok[i] ? s_lut[k * kBytes + byte] : 0u;",
                 "        if (kRenders) col[i] = byte * 0x010101;")]


FUSED_COALESCED_WORDS = [
    ("        uint32_t* dst = reinterpret_cast<uint32_t*>(wb_f + 3 * px);\n#pragma unroll\n"
     "        for (int i = 0; i < 3; ++i) {\n          dst[i] =",
     "        uint32_t* dst = reinterpret_cast<uint32_t*>(wb_f + 3 * px) - 2 * lane;\n#pragma unroll\n"
     "        for (int i = 0; i < 3; ++i) {\n          dst[32 * i] ="),
    ("""            uint32_t* dst = reinterpret_cast<uint32_t*>(crow);
            dst[0] = __byte_perm(col[0], col[1], 0x4210);
            dst[1] = __byte_perm(col[1], col[2], 0x5421);
            dst[2] = __byte_perm(col[2], col[3], 0x6542);""",
     """            uint32_t* dst = reinterpret_cast<uint32_t*>(crow) - 2 * lane;
            dst[0] = __byte_perm(col[0], col[1], 0x4210);
            dst[32] = __byte_perm(col[1], col[2], 0x5421);
            dst[64] = __byte_perm(col[2], col[3], 0x6542);"""),
]


FUSED_STREAMING_STORES = [
    ("          dst[i] = __byte_perm(__byte_perm(e[4 * i], e[4 * i + 1], 0x0040),\n"
     "                               __byte_perm(e[4 * i + 2], e[4 * i + 3], 0x0040), 0x5410);",
     "          __stcs(dst + i, __byte_perm(__byte_perm(e[4 * i], e[4 * i + 1], 0x0040),\n"
     "                               __byte_perm(e[4 * i + 2], e[4 * i + 3], 0x0040), 0x5410));"),
    ("          *reinterpret_cast<float4*>(irow) = make_float4(q[0], q[1], q[2], q[3]);",
     "          __stcs(reinterpret_cast<float4*>(irow), make_float4(q[0], q[1], q[2], q[3]));"),
    ("""            dst[0] = __byte_perm(col[0], col[1], 0x4210);
            dst[1] = __byte_perm(col[1], col[2], 0x5421);
            dst[2] = __byte_perm(col[2], col[3], 0x6542);""",
     """            __stcs(dst + 0, __byte_perm(col[0], col[1], 0x4210));
            __stcs(dst + 1, __byte_perm(col[1], col[2], 0x5421));
            __stcs(dst + 2, __byte_perm(col[2], col[3], 0x6542));"""),
]


FUSED_CONTIGUOUS = [
    ("  const uint32_t stride = gridDim.x * kThreads;", "  const uint32_t stride = kThreads;"),
    ("    uint32_t g = g0 + blockIdx.x * kThreads + tid;",
     "    const uint32_t chunk =\n"
     "        ((g1 - g0 + gridDim.x - 1) / gridDim.x + kThreads - 1) / kThreads * kThreads;\n"
     "    const uint32_t last = min(g1, g0 + (blockIdx.x + 1) * chunk);\n"
     "    uint32_t g = g0 + blockIdx.x * chunk + tid;"),
    ("    if (g < g1) {\n      c0 = __ldg(words + 3 * g);",
     "    if (g < last) {\n      c0 = __ldg(words + 3 * g);"),
    ("    while (g < g1) {", "    while (g < last) {"),
    ("      if (gn < g1) {", "      if (gn < last) {"),
]


FUSED_RENDER_16B = [("""            dst[0] = __byte_perm(col[0], col[1], 0x4210);
            dst[1] = __byte_perm(col[1], col[2], 0x5421);
            dst[2] = __byte_perm(col[2], col[3], 0x6542);""",
                     """            (void)dst;
            const uint32_t slot = ((px - first) >> 2) % (3 * (groups >> 2));
            reinterpret_cast<uint4*>(rgb_f + 3 * k * kind_stride)[slot] = make_uint4(
                __byte_perm(col[0], col[1], 0x4210), __byte_perm(col[1], col[2], 0x5421),
                __byte_perm(col[2], col[3], 0x6542), col[3]);""")]


def fused_threads(threads, blocks):
    return [("constexpr int kThreads = 512;", f"constexpr int kThreads = {threads};"),
            fused_blocks(blocks)]


def fused_blocks(n):
    return ("constexpr int kBlocksPerSM = 2;", f"constexpr int kBlocksPerSM = {n};")


FUSED_VARIANTS = {
    "256 threads, blocks/SM 3 (up to 85 registers)": (False, fused_threads(256, 3)),
    "256 threads, blocks/SM 4 (up to 64 registers, as shipped)": (False, fused_threads(256, 4)),
    "256 threads, blocks/SM 5 (up to 48 registers)": (False, fused_threads(256, 5)),
    "256 threads, blocks/SM 6 (up to 40 registers)": (False, fused_threads(256, 6)),
    "128 threads, blocks/SM 8": (False, fused_threads(128, 8)),
    "1024 threads, blocks/SM 1": (False, fused_threads(1024, 1)),
    "streaming stores (st.global.cs)": (False, FUSED_STREAMING_STORES),
    "a contiguous run of groups per block (no grid stride)": (False, FUSED_CONTIGUOUS),
    "a contiguous run per block, 256 threads, blocks/SM 4": (
        False, FUSED_CONTIGUOUS + fused_threads(256, 4)),
    "histogram copies by lane (16, 8)": (False, fused_copies(16, 8, "lane")),
    "histogram copies by warp (8, 8)": (False, fused_copies(8, 8, "warp")),
    "__match_any_sync aggregation": (False, FUSED_MATCH),
    "__fdiv_rn and the clip": (False, FUSED_LIBRARY_DIVISION),
    "next step's loads after this step's arithmetic": (False, FUSED_NO_PREFETCH),
    "50-bin count with a branch (edges only where the guess is near a border)": (
        False, FUSED_BIN_BRANCH),
    "no shared atomics": (True, FUSED_NO_ATOMICS),
    "50-bin count from the affine guess alone": (True, FUSED_BIN_AFFINE_ONLY),
    "no division": (True, FUSED_NO_DIVISION),
    "no white-balance table lookups": (True, FUSED_NO_WB_TABLE),
    "no LUT lookups": (True, FUSED_NO_LUT),
    "no sum, min, max and coverage count": (True, FUSED_NO_STATS),
    "no division, lookups, stats or atomics": (
        True, FUSED_NO_DIVISION + FUSED_NO_WB_TABLE + FUSED_NO_LUT + FUSED_NO_STATS
        + FUSED_NO_ATOMICS + FUSED_BIN_AFFINE_ONLY),
    "a warp's wb and render words stored in coalesced order (permuted output)": (
        True, FUSED_COALESCED_WORDS),
    "render words as one 16-byte store per lane (a third more bytes, wrong layout)": (
        True, FUSED_RENDER_16B),
    "no index stores": (True, FUSED_NO_IDX_STORES),
    "no render stores": (True, FUSED_NO_RGB_STORES),
    "no render and no index stores": (True, FUSED_NO_RGB_STORES + FUSED_NO_IDX_STORES),
}


# a diagnostic: the sweep without the round-0 bin's runs, run table and
# table atomics, to show what the shipped kernel spends there
ONEPASS_NO_BIN = [("        if ((key[j] >> 16) == sel0) in_bin(",
                   "        if ((key[j] >> 16) == sel0 && e[j] == 12345.f) in_bin(")]

ONEPASS_VARIANTS = {
    "no round-0 bin work (no counts, no minima)": (True, ONEPASS_NO_BIN),
}


# --- jointhist: the cluster kernel's knobs and its data paths --------------------

JH_COUNT = "        count_unit<C>(w, sel, hx, bins_at);"
JH_ADD = "    if (v < 0x8000u) add_local(bins + 4u * v);"
JH_UNIT = """    const uint32_t v = (__byte_perm(x, y, sel + 0x11u * ((k * C) & 3)) & 0xffffu) ^ hx;
    if (v < 0x8000u) add_local(bins + 4u * v);
  }"""
# a run of equal keys among a lane's 16 pixels: one add of its length
JH_UNIT_RUNS = """    const uint32_t v = (__byte_perm(x, y, sel + 0x11u * ((k * C) & 3)) & 0xffffu) ^ hx;
    if (v == cur) {
      ++run;
    } else {
      if (cur < 0x8000u) asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(bins + 4u * cur), "r"(run) : "memory");
      cur = v;
      run = 1;
    }
  }
  if (cur < 0x8000u) asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(bins + 4u * cur), "r"(run) : "memory");"""
# (the count loop is not warp-uniform: the reductions take the active lanes)
JH_WARP_UNIFORM = [(JH_ADD, """    const unsigned lanes = __activemask();
    if (__reduce_min_sync(lanes, v) == __reduce_max_sync(lanes, v)) {
      if ((threadIdx.x & 31) == __ffs(lanes) - 1 && v < 0x8000u)
        asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(bins + 4u * v), "r"(__popc(lanes)) : "memory");
    } else if (v < 0x8000u) {
      add_local(bins + 4u * v);
    }""")]

# a pair's bins split by the low bit of a (rows of b interleaved between
# the two blocks) in place of the top bit
JH_LOW_BIT = [
    ("  const uint32_t hx = (rank & 1u) << 15;", "  const uint32_t hx = rank & 1u;"),
    (JH_UNIT, """    const uint32_t key = __byte_perm(x, y, sel + 0x11u * ((k * C) & 3));
    if (((key >> 8) & 1u) == hx) add_local(bins + 4u * (((key >> 1) & 0x7f00u) | (key & 0xffu)));
  }"""),
    ("""    const uint32_t v = (__byte_perm(x, 0, sel) & 0xffffu) ^ hx;
    if (v < 0x8000u) add_local(bins_at + 4u * v);""",
     """    const uint32_t key = __byte_perm(x, 0, sel);
    if (((key >> 8) & 1u) == hx) add_local(bins_at + 4u * (((key >> 1) & 0x7f00u) | (key & 0xffu)));"""),
    ("""    int* dst = out + static_cast<size_t>(blockIdx.y * (cs / 2) + pair) * (2 * kSlice) +
               (rank & 1u) * kSlice;""",
     """    int* dst = out + static_cast<size_t>(blockIdx.y * (cs / 2) + pair) * (2 * kSlice);"""),
    ("      if (v) atomicAdd(dst + j, v);",
     "      if (v) atomicAdd(dst + ((2 * (j >> 8) + (rank & 1u)) << 8) + (j & 255u), v);"),
]


def jh(const, value):
    old = {"threads": "constexpr int kThreads = 512;",
           "stages": "constexpr int kStages = 2;",
           "stage": "constexpr int kStageBytes = 49152;",
           "min": "constexpr long long kMinPixelsPerCluster = 1LL << 18;"}[const]
    return (old, old.rsplit("=", 1)[0] + f"= {value};")


JH_CLUSTERS = "static_cast<long long>(active / rows)"

JOINTHIST_VARIANTS = {
    "4 stages of 24 KB": (False, [jh("stages", 4), jh("stage", 24576)]),
    "1024 threads": (False, [jh("threads", 1024)]),
    "256 threads": (False, [jh("threads", 256)]),
    "a lane's runs of equal keys added once": (False, [
        (JH_UNIT, JH_UNIT_RUNS),
        ("                                           uint32_t bins) {\n#pragma unroll",
         "                                           uint32_t bins) {\n  uint32_t cur = 0xffffffffu, run = 0;\n#pragma unroll")]),
    "a warp of one key added once (reductions)": (False, JH_WARP_UNIFORM),
    "bins split by the low bit of a": (False, JH_LOW_BIT),
    "bins split by the low bit of a, a second wave": (
        False, JH_LOW_BIT + [(JH_CLUSTERS, "static_cast<long long>(2 * active / rows)")]),
    "twice the resident clusters (a second wave)": (
        False, [(JH_CLUSTERS, "static_cast<long long>(2 * active / rows)")]),
    "no adds (multicast, waits, barriers and keys)": (
        True, [(JH_ADD, "    if (v == sel + 0x10000u) add_local(bins + 4u * v);")]),
    "no count (multicast, waits and barriers)": (
        True, [(JH_COUNT, "        if ((w[0] ^ w[1] ^ w[2] ^ w[3]) == sel + 0x9e3779b9u) "
                          "add_local(bins_at);")]),
}


# --- building and loading ---------------------------------------------------------

def patched(source: str, subs) -> str:
    for old, new in subs:
        if source.count(old) != 1:
            raise RuntimeError(f"variant text not found exactly once:\n{old}")
        source = source.replace(old, new)
    return source


def build_variants(kernel: str, variants, out_dir: str):
    """Build every variant of ``kernel`` at once; returns name -> library path."""
    from rgnir_torch.kernels import _build

    source = (_build.CSRC / f"{kernel}.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    procs, paths = {}, {}
    for i, (name, (_, subs)) in enumerate(variants.items()):
        d = os.path.join(out_dir, f"{kernel}_{i}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{kernel}.cu"), "w") as f:
            f.write(patched(source, subs))
        with open(os.path.join(d, "common.cuh"), "w") as f:
            f.write(common)
        paths[name] = os.path.join(d, f"lib{kernel}.so")
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", paths[name],
             os.path.join(d, f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors = "\n".join(ln for ln in log.splitlines() if "error" in ln.lower())
            raise RuntimeError(f"variant {name!r} of {kernel} did not build:\n"
                               f"{errors[:3000] or log[-3000:]}")
    return paths


def load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.rgnir_error_string.argtypes = [ctypes.c_int]
    lib.rgnir_error_string.restype = ctypes.c_char_p
    return lib


def sass_report(out_dir: str) -> None:
    """The shipped fused kernel's SASS for three kinds, renders and
    histogram, and its instruction count per step of the pixel loop."""
    from rgnir_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(_build.library_path("fused"))],
                          capture_output=True, text=True, check=True).stdout
    body = text.split("fused_kernelILi3ELb1ELb1E", 1)[1].split("Function :", 1)[0]
    with open(os.path.join(out_dir, "fused_3_renders_hist.sass"), "w") as f:
        f.write(body)
    lines = [m for m in re.finditer(r"/\*([0-9a-f]{4,5})\*/\s+(.*?);", body)]
    addr = {int(m.group(1), 16): n for n, m in enumerate(lines)}
    # the pixel loop: the backward branch that spans the most instructions
    best = (0, 0, 0)
    for n, m in enumerate(lines):
        t = re.search(r"BRA.*?0x([0-9a-f]+)", m.group(2))
        if t and int(t.group(1), 16) in addr and addr[int(t.group(1), 16)] < n:
            best = max(best, (n - addr[int(t.group(1), 16)] + 1, addr[int(t.group(1), 16)], n))
    span, lo, hi = best
    ops = [lines[i].group(2).split()[0] if not lines[i].group(2).startswith("@")
           else lines[i].group(2).split()[1] for i in range(lo, hi + 1)]
    count = {}
    for op in ops:
        count[op.split(".")[0]] = count.get(op.split(".")[0], 0) + 1
    top = sorted(count.items(), key=lambda kv: -kv[1])[:14]
    print(f"fused<3, renders, hist> SASS: {len(lines)} instructions, the pixel loop "
          f"{span} per step of 4 pixels ({span / 4:.1f} per pixel, branches not "
          f"taken included): " + ", ".join(f"{k} {v}" for k, v in top), flush=True)


# --- timing --------------------------------------------------------------------------

def onepass_variants(torch, ct, tc, out_dir) -> int:
    """The one-pass select's diagnostic on the one-pass inputs at
    the (a1) path's rows (uniform, smooth and constant), in turns with the
    shipped kernel."""
    from rgnir_torch.kernels import _build
    from rgnir_torch.kernels import select as ks

    t0 = time.perf_counter()
    _build.build(("hist", "fused", "onepass"))
    paths = build_variants("onepass", ONEPASS_VARIANTS, out_dir)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    timer = ct.Timer()
    rows = tc.onepass_inputs(SHAPE)
    args = {label: tc.onepass_setup(r)[1:] for label, r in rows.items()}
    shipped = _build.library("onepass")
    print(f"\nq24_onepass: ms on uniform / smooth / constant rows {tuple(rows['uniform'].shape)}; "
          f"shipped kernel timed before and after each variant", flush=True)
    for name in ONEPASS_VARIANTS:
        lib = load(paths[name])
        cells = []
        try:
            for label, r in rows.items():
                fn = (lambda r=r, a=args[label]: ks.q24_onepass(r, *a))
                _build._LIBS["onepass"] = shipped
                before = timer.kernel(fn)
                _build._LIBS["onepass"] = lib
                ms = timer.kernel(fn)
                _build._LIBS["onepass"] = shipped
                after = timer.kernel(fn)
                cells.append(f"{label} {ms:.4f} [shipped {before:.4f}, {after:.4f}]")
        finally:
            _build._LIBS["onepass"] = shipped
        print(f"  {name} (diagnostic, unchecked): " + "; ".join(cells), flush=True)
    return 0


def jointhist_variants(torch, ct, tc, out_dir) -> int:
    """The jointhist kernel's variants on the kernel table's two timed bands
    (uniform bytes and the smooth field, 2048 x 32768 x 3, the main
    path's two pairs), in turns with the shipped kernel. A design
    candidate is first held exactly against the plain version on both
    bands and on 1,000,003 pixels with 8 pairs (two launch rows and the
    tail)."""
    from rgnir_torch.kernels import _build
    from rgnir_torch.kernels import jointhist as kj

    t0 = time.perf_counter()
    _build.build(("jointhist",))
    paths = build_variants("jointhist", JOINTHIST_VARIANTS, out_dir)
    print(f"build: {time.perf_counter() - t0:.1f} s; shipped: {ct.ptxas_report('jointhist')}",
          flush=True)
    timer = ct.Timer()
    bands = tc.jointhist_bands()
    odd = bands["uniform"][:tc.JOINT_ODD_N]
    pairs = tc.JOINT_PAIRS[2]
    acc = torch.zeros(len(pairs), 256, 256, dtype=torch.int32, device="cuda")

    def check(flat, prs):
        out = torch.zeros(len(prs), 256, 256, dtype=torch.int32, device="cuda")
        kj.joint_histograms(flat, prs, out)
        tc.check_equal(f"jointhist {tuple(flat.shape)} {prs}", out,
                       kj.joint_histograms_plain(flat, prs, torch.zeros_like(out)))

    shipped = _build.library("jointhist")
    print(f"\njointhist: ms on uniform / smooth bands {tuple(bands['uniform'].shape)}, pairs "
          f"{pairs}; shipped kernel timed before and after each variant", flush=True)
    for name, (diagnostic, _) in JOINTHIST_VARIANTS.items():
        lib = load(paths[name])
        cells = []
        try:
            if not diagnostic:
                _build._LIBS["jointhist"] = lib
                for flat in bands.values():
                    check(flat, pairs)
                check(odd, tc.JOINT_PAIRS[8])
            for label, band in bands.items():
                fn = (lambda band=band: kj.joint_histograms(band, pairs, acc))
                _build._LIBS["jointhist"] = shipped
                before = timer.kernel(fn)
                _build._LIBS["jointhist"] = lib
                ms = timer.kernel(fn)
                _build._LIBS["jointhist"] = shipped
                after = timer.kernel(fn)
                cells.append(f"{label} {ms:.4f} [shipped {before:.4f}, {after:.4f}]")
        finally:
            _build._LIBS["jointhist"] = shipped
        tag = "diagnostic, unchecked" if diagnostic else "matches plain"
        print(f"  {name} ({tag}): " + "; ".join(cells), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("hist", "fused", "onepass", "jointhist"), default=None)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import card_timing as ct
    import torch_card as tc
    from rgnir_torch.config import IndexKind
    from rgnir_torch.kernels import _build
    from rgnir_torch.kernels import fused as kf
    from rgnir_torch.kernels import hist as kh

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = os.path.join(ROOT, "build", "kernel_variants")
    os.makedirs(out_dir, exist_ok=True)
    if args.only == "onepass":
        return onepass_variants(torch, ct, tc, out_dir)
    if args.only == "jointhist":
        return jointhist_variants(torch, ct, tc, out_dir)
    t0 = time.perf_counter()
    _build.build(("hist", "fused"))
    todo = [k for k in ("hist", "fused") if args.only in (None, k)]
    table = {"hist": HIST_VARIANTS, "fused": FUSED_VARIANTS}
    paths = {k: build_variants(k, table[k], out_dir) for k in todo}
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    timer = ct.Timer()
    kinds = tuple(IndexKind.parse(k) for k in KINDS)
    round0 = (True, True, False)
    inputs = {"uniform": tc.uniform_frames(SHAPE),
              "smooth": torch.as_tensor(tc.smooth_field(SHAPE), device="cuda")}
    bounds = {}
    for label, img in inputs.items():
        lo, hi, *_ = tc.check_hist_fused(f"shipped {label}", img, kinds, round0)
        bounds[label] = (lo, hi)

    # What the card's memory gives plain PyTorch kernels on as many bytes as
    # the fused kernel moves (25.2 MB read, 201.3 MB written at three kinds).
    nbytes = SHAPE[0] * SHAPE[1] * SHAPE[2] * 27
    buf = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    fill_ms = timer.kernel(lambda: buf.view(torch.int32).fill_(7))
    copy_ms = timer.kernel(lambda: buf[: nbytes // 2].copy_(src))
    print(f"\nmemory yardsticks, {nbytes} bytes: fill_ (all writes) {fill_ms:.4f} ms, "
          f"{nbytes / fill_ms / 1e9:.2f} TB/s; copy_ (half read, half written) "
          f"{copy_ms:.4f} ms, {nbytes / copy_ms / 1e9:.2f} TB/s", flush=True)
    del buf, src

    def run(kernel, img, label, headline=False):
        if kernel == "hist":
            return lambda: kh.channel_histograms(img)
        lo, hi = bounds[label]
        if headline:
            return lambda: kf.fused_analyze(img, lo, hi, kinds[:1], True, False, (True,))
        return lambda: kf.fused_analyze(img, lo, hi, kinds, True, True, round0)

    for kernel in todo:
        shipped = _build.library(kernel)
        print(f"\n{kernel}: ms on uniform / smooth bytes at {SHAPE}; shipped kernel "
              f"timed before and after each variant", flush=True)
        for name, (diagnostic, _) in table[kernel].items():
            lib = load(paths[kernel][name])
            cells = []
            try:
                for label, img in inputs.items():
                    _build._LIBS[kernel] = lib
                    if not diagnostic:
                        tc.check_hist_fused(f"{name} {label}", img, kinds, round0)
                    fn = run(kernel, img, label)
                    _build._LIBS[kernel] = shipped
                    before = timer.kernel(fn)
                    _build._LIBS[kernel] = lib
                    ms = timer.kernel(fn)
                    extra = ""
                    if kernel == "fused":
                        extra = f" (headline {timer.kernel(run(kernel, img, label, True)):.4f})"
                    _build._LIBS[kernel] = shipped
                    after = timer.kernel(fn)
                    cells.append(f"{label} {ms:.4f}{extra} [shipped {before:.4f}, {after:.4f}]")
            finally:
                _build._LIBS[kernel] = shipped
            tag = "diagnostic, unchecked" if diagnostic else "matches plain"
            print(f"  {name} ({tag}): " + "; ".join(cells), flush=True)
    if args.sass:
        sass_report(out_dir)
    if args.only is None:
        return onepass_variants(torch, ct, tc, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

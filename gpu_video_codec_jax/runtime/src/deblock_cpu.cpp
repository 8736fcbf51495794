// Native CPU runtime for gpu_video_codec_jax.
//
// Role in the framework: the host-side execution backend -- the equivalent of
// the reference's OpenMP CPU path (hevc_deblocking_filter_cpu.h:134-993,
// driven by ExecuteCpu, main.cu:36-83) -- plus fast layout transforms for the
// streaming pipeline (plane <-> tile-planes packing).
//
// This is a from-scratch implementation of the same edge-filter semantics the
// JAX/Pallas paths implement, organized around this framework's own
// tile-geometry abstraction (a single coordinate map per edge phase) rather
// than the reference's 32-pointer-per-segment enumeration.  Semantics match
// the golden model bit-for-bit, including the documented quirk decisions:
// out-of-bounds boundary-strength reads are defined as 0 (Q2), padding is
// zero-initialized (Q6), the right-horizontal P/Q column mismatch (Q3) and
// the intra-tile phase order (Q7) are preserved.
//
// The segment filters live in deblock_core.h (shared with the AVX-512
// translation unit); this file holds the plane sweep, the ISA dispatch, and
// the plain C ABI consumed via ctypes (runtime/native.py).
//
// ISA tiers (all bit-identical; cross-checked by tests/test_native.py):
//   scalar   -- portable fallback (non-x86_64)
//   sse4.1   -- one segment per vector (4 int32 row lanes)
//   avx512   -- four tiles per vector (16 int32 lanes), runtime cpuid-gated;
//               see deblock_cpu_avx512.cpp.  Opt out with GVCT_NATIVE_ISA=sse.

#include <cstdlib>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "deblock_core.h"

using gvct::PlaneView;
using gvct::bs_flat;
using gvct::filter_tile;
using gvct::get_beta;
using gvct::get_tc;
using gvct::kBlock;

#if defined(__x86_64__)
// Implemented in deblock_cpu_avx512.cpp (compiled with AVX-512 flags; only
// ever called after the cpuid check below passes AND the TU reports it
// compiled the real kernels -- gvct_avx512_compiled() returns 0 from the
// stub, so dispatch can never exceed compiled capability).
extern "C" int gvct_avx512_compiled();
extern "C" void gvct_tile_row_avx512(
    uint8_t *plane, int stride, int by, int nx,
    const uint8_t *vert_bs, long long n_vert,
    const uint8_t *hor_bs, long long n_hor,
    long long sv, long long sh, int gate_ny, int gate_nx,
    int beta, int tc, int chroma);
#endif

namespace {

// ISA selection, re-evaluated per frame call (cheap; lets tests flip
// GVCT_NATIVE_ISA between calls in one process).
int select_isa() {
  const char *e = std::getenv("GVCT_NATIVE_ISA");
#if defined(__x86_64__)
  if (e != nullptr && std::strcmp(e, "sse") == 0) return 1;
  if (__builtin_cpu_supports("avx512bw") && __builtin_cpu_supports("avx512vl") &&
      __builtin_cpu_supports("avx512vbmi") && gvct_avx512_compiled())
    return 2;
  return 1;
#else
  (void)e;
  return 0;
#endif
}

// Sweep one extended plane.  gate_ny/gate_nx: tile counts used by the
// segment-existence gates (for chroma these are the LUMA counts -- quirk Q2).
void deblock_plane(uint8_t *plane, int hext, int wext, int lookup_w,
                   const uint8_t *vert_bs, long long n_vert,
                   const uint8_t *hor_bs, long long n_hor,
                   int gate_ny, int gate_nx, int beta, int tc, bool chroma,
                   int num_threads, int isa) {
  const int ny = hext / kBlock, nx = wext / kBlock;
  const long long sv = lookup_w / kBlock + 1, sh = lookup_w / kBlock;
  const PlaneView pl{plane, wext};
#if defined(__x86_64__)
  const bool use_avx512 = (isa >= 2) && nx >= 4;
#else
  const bool use_avx512 = false;
  (void)isa;
#endif
#ifdef _OPENMP
  // num_threads clause instead of omp_set_num_threads: the latter is a
  // sticky process-global, so "0 = library default" would actually mean
  // "whatever the previous caller set"
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel for schedule(static) num_threads(nt)
#else
  (void)num_threads;
#endif
  // Row-major sweep, parallel over tile ROWS: every tile writes only inside
  // its own 8x8 extent, so any partition is race-free; row slabs give each
  // thread contiguous memory (the reference's column partition, cpu.h:145,
  // makes every thread stride through the whole plane and scales negatively
  // on small frames).
  for (int by = 0; by < ny; ++by) {
#if defined(__x86_64__)
    if (use_avx512) {
      gvct_tile_row_avx512(plane, wext, by, nx, vert_bs, n_vert, hor_bs, n_hor,
                           sv, sh, gate_ny, gate_nx, beta, tc, chroma ? 1 : 0);
      continue;
    }
#endif
    for (int bx = 0; bx < nx; ++bx) {
      const int bs_v1 = by > 0 ? bs_flat(vert_bs, n_vert, (long long)(by - 1) * sv + bx) : 0;
      const int bs_v2 = by < gate_ny - 1 ? bs_flat(vert_bs, n_vert, (long long)by * sv + bx) : 0;
      const int bs_h1 = bx > 0 ? bs_flat(hor_bs, n_hor, (long long)by * sh + bx - 1) : 0;
      const int bs_h2 = bx < gate_nx - 1 ? bs_flat(hor_bs, n_hor, (long long)by * sh + bx) : 0;
      // intra-tile phase order fixed (quirk Q7): upper-vert, lower-vert,
      // left-hor, right-hor; each phase statically specialized
      if (chroma) filter_tile<true>(pl, by, bx, bs_v1, bs_v2, bs_h1, bs_h2, beta, tc);
      else        filter_tile<false>(pl, by, bx, bs_v1, bs_v2, bs_h1, bs_h2, beta, tc);
    }
  }
}

}  // namespace

extern "C" {

int gvct_version() { return 12; }

int gvct_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Active SIMD tier for provenance (bench rows / tests): 0 scalar, 1 sse4.1,
// 2 avx512.  Honors the GVCT_NATIVE_ISA override like the filter itself.
int gvct_active_isa() { return select_isa(); }

// In-place deblock of extended planes.
//  y: (h+8)x(w+8);  u, v: chroma extended planes (ch_ext x cw_ext, derived).
//  BS arrays are the flat reference-layout arrays (utils/bs.py).
//  Returns 0 on success.
int gvct_deblock_frame(uint8_t *y, uint8_t *u, uint8_t *v,
                       int width, int height,
                       const uint8_t *vert_bs, long long n_vert,
                       const uint8_t *hor_bs, long long n_hor,
                       const uint8_t *cvert_bs, long long n_cvert,
                       const uint8_t *chor_bs, long long n_chor,
                       int qp, int luma_only, int num_threads) {
  if (width % kBlock || height % kBlock || qp < 0) return 1;
  const int beta = get_beta(qp), tc = get_tc(qp);
  const int isa = select_isa();
  const int hext = height + kBlock, wext = width + kBlock;
  const int luma_ny = height / kBlock + 1, luma_nx = width / kBlock + 1;
  deblock_plane(y, hext, wext, width, vert_bs, n_vert, hor_bs, n_hor,
                luma_ny, luma_nx, beta, tc, /*chroma=*/false, num_threads, isa);
  if (!luma_only) {
    const int cw = width / 2, ch = height / 2;
    const int chext = ch + kBlock, cwext = cw + kBlock;
    // Quirk Q9: the reference's chroma sweep uses row stride
    // num_chroma_blocks_x*8 (cpu.h:469-471), not the plane's _new_chroma_width,
    // i.e. it filters the flat buffer reinterpreted as an
    // (8*ncby, 8*ncbx) image.  Passing the effective dims reproduces that
    // exactly (identical when cwext is already a multiple of 8).
    const int eff_h = (chext / kBlock) * kBlock;
    const int eff_w = (cwext / kBlock) * kBlock;
    deblock_plane(u, eff_h, eff_w, cw, cvert_bs, n_cvert, chor_bs, n_chor,
                  luma_ny, luma_nx, beta, tc, /*chroma=*/true, num_threads, isa);
    deblock_plane(v, eff_h, eff_w, cw, cvert_bs, n_cvert, chor_bs, n_chor,
                  luma_ny, luma_nx, beta, tc, /*chroma=*/true, num_threads, isa);
  }
  return 0;
}

// Layout transforms for the streaming pipeline: extended plane (hext x wext)
// <-> tile-planes (8, 8, By, Bx) with By = hext/8 (truncating), Bx = wext/8.
void gvct_pack_tiles(const uint8_t *plane, int hext, int wext, uint8_t *out) {
  const int ny = hext / kBlock, nx = wext / kBlock;
  for (int r = 0; r < kBlock; ++r)
    for (int c = 0; c < kBlock; ++c) {
      uint8_t *dst = out + ((long long)r * kBlock + c) * ny * nx;
      for (int by = 0; by < ny; ++by) {
        const uint8_t *src = plane + (long long)(by * kBlock + r) * wext + c;
        for (int bx = 0; bx < nx; ++bx) dst[(long long)by * nx + bx] = src[(long long)bx * kBlock];
      }
    }
}

void gvct_unpack_tiles(const uint8_t *tiles, int hext, int wext, uint8_t *plane) {
  const int ny = hext / kBlock, nx = wext / kBlock;
  for (int r = 0; r < kBlock; ++r)
    for (int c = 0; c < kBlock; ++c) {
      const uint8_t *src = tiles + ((long long)r * kBlock + c) * ny * nx;
      for (int by = 0; by < ny; ++by) {
        uint8_t *dst = plane + (long long)(by * kBlock + r) * wext + c;
        for (int bx = 0; bx < nx; ++bx) dst[(long long)bx * kBlock] = src[(long long)by * nx + bx];
      }
    }
}

}  // extern "C"

// AVX-512 batched tile-row sweep for the native CPU runtime.
//
// Design: FOUR tiles per vector.  One zmm of 16 int32 lanes holds the same
// quantity for 4 adjacent 8x8 tiles along bx -- lane 4t+r = filter row r of
// tile t.  Each 128-bit lane of the zmm is therefore exactly one segment,
// which makes the per-segment decision broadcasts (rows 0 and 3 of each
// segment feed conds 1-6, cpu.h:1359-1429 semantics) single in-lane
// shuffles (_mm512_shuffle_epi32).  Strong/normal selection is branchless
// with k-masks -- the same formulation as the JAX path (ops/filters.py)
// -- so four segments with mixed decisions cost one pass.
//
// Tiles are fully independent (every phase reads and writes only inside its
// own 8x8 extent; see ops/deblock.py geometry), so running phase k for four
// tiles before phase k+1 is byte-identical to the reference's per-tile Q7
// order.  Every store is BYTE-MASKED to the quad's active tiles
// (QUAD_BYTES[m4]): gated-out tiles are never written at all -- not even
// with identical bytes -- so the quad kernels stay race-free under any
// tile-granular parallel partition, not just the current one-thread-per-
// tile-row OpenMP split in deblock_cpu.cpp (round-4 advisor finding).
//
// Gathers/scatters: a quad's working set per phase is <= 4 rows x 32 cols =
// 128 bytes = two zmms, so VBMI's two-source byte permute
// (_mm512_permutex2var_epi8) gathers any p/q column vector with one
// instruction, and merges filtered bytes back with two.  Horizontal phases
// read per-row (one 32-byte load + one byte permute per p[j]/q[j]) and write
// back with masked byte stores.
//
// This TU is compiled with AVX-512 flags; it is only ever entered after
// deblock_cpu.cpp's runtime cpuid check (avx512bw+vl+vbmi) passes.
// Bit-exactness vs the SSE/scalar/golden paths is enforced by
// tests/test_native.py (cross-ISA byte compares).

#include "deblock_core.h"

#if defined(__x86_64__) && defined(__AVX512BW__) && defined(__AVX512VL__) && \
    defined(__AVX512VBMI__)

#include <immintrin.h>

namespace {

using gvct::PlaneView;
using gvct::bs_flat;
using gvct::filter_tile;
using gvct::kBlock;

struct B64 { alignas(64) uint8_t b[64]; };
struct B32 { alignas(32) uint8_t b[32]; };

// ---- gather/scatter index constants (all byte indices are compile-time) ----

// Vertical phases: quad working set = rows rbase..rbase+3 x cols c0..c0+31,
// loaded as A = rows 0,1 / B = rows 2,3 (64 bytes each).  Linear byte index
// L = r*32 + 8t + c maps directly to permutex2var semantics (bit 6 of the
// index selects B, and L >= 64 <=> r >= 2).
constexpr B64 make_vgather(int col) {
  B64 o{};
  for (int i = 0; i < 16; ++i) o.b[i] = (uint8_t)((i % 4) * 32 + (i / 4) * 8 + col);
  return o;
}
// p[j] is tile column 3-j, q[j] is column 4+j (ops/deblock.py geometry).
constexpr B64 VG_P[4] = {make_vgather(3), make_vgather(2), make_vgather(1), make_vgather(0)};
constexpr B64 VG_Q[4] = {make_vgather(4), make_vgather(5), make_vgather(6), make_vgather(7)};

// Merge filtered column bytes back into the A/B row images.  F holds packed
// 16-byte groups: group jj at bytes 16jj..16jj+15, byte 4t+r = lane 4t+r.
// Luma P side touches cols 3,2,1 (= p[0],p[1],p[2] -> groups 0,1,2);
// Q side cols 4,5,6 (= q[0],q[1],q[2]).  rowoff = 0 for A, 2 for B.
constexpr B64 make_merge_luma_p(int rowoff) {
  B64 o{};
  for (int L = 0; L < 64; ++L) {
    const int r = L / 32 + rowoff, cc = L % 32, t = cc / 8, c = cc % 8;
    o.b[L] = (c >= 1 && c <= 3) ? (uint8_t)(64 + 16 * (3 - c) + 4 * t + r) : (uint8_t)L;
  }
  return o;
}
constexpr B64 make_merge_luma_q(int rowoff) {
  B64 o{};
  for (int L = 0; L < 64; ++L) {
    const int r = L / 32 + rowoff, cc = L % 32, t = cc / 8, c = cc % 8;
    o.b[L] = (c >= 4 && c <= 6) ? (uint8_t)(64 + 16 * (c - 4) + 4 * t + r) : (uint8_t)L;
  }
  return o;
}
// Chroma touches only cols 3 (p0 -> group 0) and 4 (q0 -> group 1).
constexpr B64 make_merge_chroma(int rowoff) {
  B64 o{};
  for (int L = 0; L < 64; ++L) {
    const int r = L / 32 + rowoff, cc = L % 32, t = cc / 8, c = cc % 8;
    if (c == 3)      o.b[L] = (uint8_t)(64 + 4 * t + r);
    else if (c == 4) o.b[L] = (uint8_t)(64 + 16 + 4 * t + r);
    else             o.b[L] = (uint8_t)L;
  }
  return o;
}
constexpr B64 MA_P = make_merge_luma_p(0), MB_P = make_merge_luma_p(2);
constexpr B64 MA_Q = make_merge_luma_q(0), MB_Q = make_merge_luma_q(2);
constexpr B64 MA_C = make_merge_chroma(0), MB_C = make_merge_chroma(2);

// Horizontal phases: lane 4t+r = byte 8t + cb + r of ONE row (cb = 4 for the
// right-hor P side, quirk Q3).
constexpr B32 make_hgather(int cb) {
  B32 o{};
  for (int i = 0; i < 16; ++i) o.b[i] = (uint8_t)((i / 4) * 8 + cb + (i % 4));
  return o;
}
// Inverse: expand 16 packed bytes to their row positions for a masked store.
constexpr B32 make_hscatter(int cb) {
  B32 o{};
  for (int p = 0; p < 32; ++p) {
    const int c = p % 8;
    o.b[p] = (c >= cb && c < cb + 4) ? (uint8_t)((p / 8) * 4 + (c - cb)) : 0;
  }
  return o;
}
constexpr B32 HG[2] = {make_hgather(0), make_hgather(4)};
constexpr B32 HS[2] = {make_hscatter(0), make_hscatter(4)};
constexpr __mmask32 HMASK[2] = {0x0F0F0F0F, 0xF0F0F0F0u};

// 4-bit per-tile gate -> 16-lane mask (4 lanes per tile).
constexpr uint16_t SEG_LANES[16] = {
    0x0000, 0x000F, 0x00F0, 0x00FF, 0x0F00, 0x0F0F, 0x0FF0, 0x0FFF,
    0xF000, 0xF00F, 0xF0F0, 0xF0FF, 0xFF00, 0xFF0F, 0xFFF0, 0xFFFF};

// 4-bit per-tile gate -> 32-byte store mask (8 row bytes per tile): stores
// never touch gated-out tiles, keeping the quad kernels reentrant at tile
// granularity (active tiles still rewrite their own untouched columns with
// identical bytes, which is safe under any per-tile ownership).
constexpr uint32_t QUAD_BYTES[16] = {
    0x00000000u, 0x000000FFu, 0x0000FF00u, 0x0000FFFFu,
    0x00FF0000u, 0x00FF00FFu, 0x00FFFF00u, 0x00FFFFFFu,
    0xFF000000u, 0xFF0000FFu, 0xFF00FF00u, 0xFF00FFFFu,
    0xFFFF0000u, 0xFFFF00FFu, 0xFFFFFF00u, 0xFFFFFFFFu};

// ---- vector helpers (int32 lanes; Q8 semantics: arithmetic >>) ----

inline __m512i clip1z(__m512i d, __m512i c) {
  return _mm512_min_epi32(_mm512_max_epi32(_mm512_sub_epi32(_mm512_setzero_si512(), c), d), c);
}
inline __m512i clip2z(__m512i v) {
  return _mm512_min_epi32(_mm512_max_epi32(_mm512_setzero_si512(), v),
                          _mm512_set1_epi32(255));
}
// Broadcast segment row 0 / row 3 to all 4 lanes of its segment: each
// segment IS one 128-bit lane, so these are in-lane shuffles.
inline __m512i bc0(__m512i v) { return _mm512_shuffle_epi32(v, (_MM_PERM_ENUM)0x00); }
inline __m512i bc3(__m512i v) { return _mm512_shuffle_epi32(v, (_MM_PERM_ENUM)0xFF); }

inline __m512i gather_col(__m512i A, __m512i B, const B64 &idx) {
  const __m512i g = _mm512_permutex2var_epi8(A, _mm512_load_si512((const void *)idx.b), B);
  return _mm512_cvtepu8_epi32(_mm512_castsi512_si128(g));
}
inline __m512i gather_row(const uint8_t *row, const B32 &idx) {
  const __m256i r = _mm256_loadu_si256((const __m256i *)row);
  const __m256i g = _mm256_permutexvar_epi8(_mm256_load_si256((const __m256i *)idx.b), r);
  return _mm512_cvtepu8_epi32(_mm256_castsi256_si128(g));
}
inline void scatter_row(uint8_t *row, __m512i v, int side, __mmask32 act) {
  const __m128i packed = _mm512_cvtepi32_epi8(v);  // exact: values in [0,255]
  const __m256i expanded = _mm256_permutexvar_epi8(
      _mm256_load_si256((const __m256i *)HS[side].b), _mm256_zextsi128_si256(packed));
  _mm256_mask_storeu_epi8(row, HMASK[side] & act, expanded);
}

#define ADDZ _mm512_add_epi32
#define SUBZ _mm512_sub_epi32
#define SLLZ _mm512_slli_epi32
#define SRAZ _mm512_srai_epi32
#define LTZ  _mm512_cmplt_epi32_mask
#define ABSZ _mm512_abs_epi32

// 16-lane luma filter: 4 segments, decision cascade cpu.h:1359-1429 with
// per-segment k-masks.  p[0..2]/q[0..2] are blended in place (originals kept
// for gated-out / unfiltered lanes).  Returns false when no lane filters.
inline bool luma_filter16(__m512i p[4], __m512i q[4], int beta, int tc,
                          __mmask16 active) {
  const __m512i p0 = p[0], p1 = p[1], p2 = p[2], p3 = p[3];
  const __m512i q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];

  const __m512i dpr = ABSZ(ADDZ(SUBZ(p2, SLLZ(p1, 1)), p0));
  const __m512i dqr = ABSZ(ADDZ(SUBZ(q2, SLLZ(q1, 1)), q0));
  const __m512i s = ADDZ(dpr, dqr);
  const __m512i s0 = bc0(s), s3 = bc3(s);
  // condition (1): dp0+dp3+dq0+dq3 < beta
  const __mmask16 cond1 =
      LTZ(ADDZ(s0, s3), _mm512_set1_epi32(beta)) & active;
  if (!cond1) return false;

  const __m512i b8 = _mm512_set1_epi32(beta / 8);
  const __mmask16 cond2 = LTZ(s0, b8) & LTZ(s3, b8);
  const __m512i t3v = ADDZ(ABSZ(SUBZ(p3, p0)), ABSZ(SUBZ(q0, q3)));
  const __mmask16 cond3 = LTZ(bc0(t3v), b8) & LTZ(bc3(t3v), b8);
  const __m512i dpq = ABSZ(SUBZ(p0, q0));
  const __m512i tc52 = _mm512_set1_epi32(5 * tc / 2);
  const __mmask16 cond4 = LTZ(bc0(dpq), tc52) & LTZ(bc3(dpq), tc52);
  const __mmask16 strong = cond1 & cond2 & cond3 & cond4;
  const __mmask16 normal = cond1 & ~strong;

  if (strong) {
    const __m512i v4 = _mm512_set1_epi32(4), two = _mm512_set1_epi32(2);
    const __m512i c = _mm512_set1_epi32(2 * tc);
    // (x2 + 2*x1 - 6*x0 + 2*y0 + y1 + 4) >> 3
    const __m512i d0p = clip1z(SRAZ(ADDZ(ADDZ(ADDZ(p2, SLLZ(p1, 1)),
        SUBZ(ADDZ(SLLZ(q0, 1), q1), ADDZ(SLLZ(p0, 2), SLLZ(p0, 1)))), v4), 3), c);
    const __m512i d0q = clip1z(SRAZ(ADDZ(ADDZ(ADDZ(q2, SLLZ(q1, 1)),
        SUBZ(ADDZ(SLLZ(p0, 1), p1), ADDZ(SLLZ(q0, 2), SLLZ(q0, 1)))), v4), 3), c);
    // (x2 - 3*x1 + x0 + y0 + 2) >> 2
    const __m512i d1p = clip1z(SRAZ(ADDZ(ADDZ(SUBZ(p2, ADDZ(SLLZ(p1, 1), p1)),
        ADDZ(p0, q0)), two), 2), c);
    const __m512i d1q = clip1z(SRAZ(ADDZ(ADDZ(SUBZ(q2, ADDZ(SLLZ(q1, 1), q1)),
        ADDZ(q0, p0)), two), 2), c);
    // (2*x3 - 5*x2 + x1 + x0 + y0 + 4) >> 3
    const __m512i d2p = clip1z(SRAZ(ADDZ(ADDZ(SUBZ(SLLZ(p3, 1),
        ADDZ(SLLZ(p2, 2), p2)), ADDZ(p1, ADDZ(p0, q0))), v4), 3), c);
    const __m512i d2q = clip1z(SRAZ(ADDZ(ADDZ(SUBZ(SLLZ(q3, 1),
        ADDZ(SLLZ(q2, 2), q2)), ADDZ(q1, ADDZ(q0, p0))), v4), 3), c);
    p[0] = _mm512_mask_mov_epi32(p[0], strong, clip2z(ADDZ(p0, d0p)));
    p[1] = _mm512_mask_mov_epi32(p[1], strong, clip2z(ADDZ(p1, d1p)));
    p[2] = _mm512_mask_mov_epi32(p[2], strong, clip2z(ADDZ(p2, d2p)));
    q[0] = _mm512_mask_mov_epi32(q[0], strong, clip2z(ADDZ(q0, d0q)));
    q[1] = _mm512_mask_mov_epi32(q[1], strong, clip2z(ADDZ(q1, d1q)));
    q[2] = _mm512_mask_mov_epi32(q[2], strong, clip2z(ADDZ(q2, d2q)));
  }

  if (normal) {
    // delta0 = (9*(q0-p0) - 3*(q1-p1) + 8) >> 4, per-row gate |delta0|<10tc
    const __m512i a = SUBZ(q0, p0), b = SUBZ(q1, p1);
    const __m512i delta0 = SRAZ(ADDZ(SUBZ(ADDZ(SLLZ(a, 3), a),
        ADDZ(SLLZ(b, 1), b)), _mm512_set1_epi32(8)), 4);
    const __mmask16 rowmask =
        LTZ(ABSZ(delta0), _mm512_set1_epi32(10 * tc)) & normal;
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i D = clip1z(delta0, _mm512_set1_epi32(2 * tc));
    const __m512i c2 = _mm512_set1_epi32(tc / 2);
    const __m512i dp1 = clip1z(SRAZ(ADDZ(SUBZ(SRAZ(ADDZ(ADDZ(p2, p0), one), 1), p1), D), 1), c2);
    const __m512i dq1 = clip1z(SRAZ(SUBZ(SUBZ(SRAZ(ADDZ(ADDZ(q2, q0), one), 1), q1), D), 1), c2);
    // per-SEGMENT second-pixel gates (conds 5/6)
    const __m512i b316 = _mm512_set1_epi32(3 * beta / 16);
    const __mmask16 cond5 = LTZ(ADDZ(bc0(dpr), bc3(dpr)), b316);
    const __mmask16 cond6 = LTZ(ADDZ(bc0(dqr), bc3(dqr)), b316);
    p[0] = _mm512_mask_mov_epi32(p[0], rowmask, clip2z(ADDZ(p0, D)));
    q[0] = _mm512_mask_mov_epi32(q[0], rowmask, clip2z(SUBZ(q0, D)));
    p[1] = _mm512_mask_mov_epi32(p[1], rowmask & cond5, clip2z(ADDZ(p1, dp1)));
    q[1] = _mm512_mask_mov_epi32(q[1], rowmask & cond6, clip2z(ADDZ(q1, dq1)));
  }
  return true;
}

// 16-lane chroma filter: p0/q0 only, P/Q delta asymmetry (cpu.h:1453-1461).
inline void chroma_filter16(__m512i &p0, __m512i p1, __m512i &q0, __m512i q1,
                            int tc, __mmask16 active) {
  const __m512i v4 = _mm512_set1_epi32(4), c = _mm512_set1_epi32(tc);
  const __m512i dp = clip1z(SRAZ(ADDZ(ADDZ(SLLZ(SUBZ(p0, q0), 2), SUBZ(p1, q1)), v4), 3), c);
  const __m512i dq = clip1z(SRAZ(ADDZ(ADDZ(SLLZ(SUBZ(q0, p0), 2), SUBZ(q1, p1)), v4), 3), c);
  p0 = _mm512_mask_mov_epi32(p0, active, clip2z(ADDZ(p0, dp)));
  q0 = _mm512_mask_mov_epi32(q0, active, clip2z(SUBZ(q0, dq)));
}

#undef ADDZ
#undef SUBZ
#undef SLLZ
#undef SRAZ
#undef LTZ
#undef ABSZ

// ---- per-phase quad kernels ----

// Vertical luma phase (0 or 1 via rbase): 4 rows x 32 cols -> A/B images.
void luma_vert_quad(const PlaneView &pl, int rbase, int c0, unsigned m4,
                    int beta, int tc) {
  const __m256i rw0 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 0, c0));
  const __m256i rw1 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 1, c0));
  const __m256i rw2 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 2, c0));
  const __m256i rw3 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 3, c0));
  __m512i A = _mm512_inserti64x4(_mm512_castsi256_si512(rw0), rw1, 1);
  __m512i B = _mm512_inserti64x4(_mm512_castsi256_si512(rw2), rw3, 1);
  __m512i p[4], q[4];
  for (int j = 0; j < 4; ++j) {
    p[j] = gather_col(A, B, VG_P[j]);
    q[j] = gather_col(A, B, VG_Q[j]);
  }
  if (!luma_filter16(p, q, beta, tc, SEG_LANES[m4 & 15])) return;
  __m512i FP = _mm512_castsi128_si512(_mm512_cvtepi32_epi8(p[0]));
  FP = _mm512_inserti32x4(FP, _mm512_cvtepi32_epi8(p[1]), 1);
  FP = _mm512_inserti32x4(FP, _mm512_cvtepi32_epi8(p[2]), 2);
  __m512i FQ = _mm512_castsi128_si512(_mm512_cvtepi32_epi8(q[0]));
  FQ = _mm512_inserti32x4(FQ, _mm512_cvtepi32_epi8(q[1]), 1);
  FQ = _mm512_inserti32x4(FQ, _mm512_cvtepi32_epi8(q[2]), 2);
  A = _mm512_permutex2var_epi8(A, _mm512_load_si512((const void *)MA_P.b), FP);
  A = _mm512_permutex2var_epi8(A, _mm512_load_si512((const void *)MA_Q.b), FQ);
  B = _mm512_permutex2var_epi8(B, _mm512_load_si512((const void *)MB_P.b), FP);
  B = _mm512_permutex2var_epi8(B, _mm512_load_si512((const void *)MB_Q.b), FQ);
  const __mmask32 wm = QUAD_BYTES[m4 & 15];
  _mm256_mask_storeu_epi8(&pl.at(rbase + 0, c0), wm, _mm512_extracti64x4_epi64(A, 0));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 1, c0), wm, _mm512_extracti64x4_epi64(A, 1));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 2, c0), wm, _mm512_extracti64x4_epi64(B, 0));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 3, c0), wm, _mm512_extracti64x4_epi64(B, 1));
}

// Horizontal luma phase (2 left / 3 right via `side`): per-row gathers;
// side=1 reads/writes the P grid at cols 4..7 (quirk Q3).
void luma_hor_quad(const PlaneView &pl, int r0, int c0, int side, unsigned m4,
                   int beta, int tc) {
  __m512i p[4], q[4];
  for (int j = 0; j < 4; ++j) {
    p[j] = gather_row(&pl.at(r0 + 3 - j, c0), HG[side]);
    q[j] = gather_row(&pl.at(r0 + 4 + j, c0), HG[0]);
  }
  if (!luma_filter16(p, q, beta, tc, SEG_LANES[m4 & 15])) return;
  const __mmask32 act = QUAD_BYTES[m4 & 15];
  for (int j = 0; j < 3; ++j) {
    scatter_row(&pl.at(r0 + 3 - j, c0), p[j], side, act);
    scatter_row(&pl.at(r0 + 4 + j, c0), q[j], 0, act);
  }
}

void chroma_vert_quad(const PlaneView &pl, int rbase, int c0, unsigned m4, int tc) {
  const __m256i rw0 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 0, c0));
  const __m256i rw1 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 1, c0));
  const __m256i rw2 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 2, c0));
  const __m256i rw3 = _mm256_loadu_si256((const __m256i *)&pl.at(rbase + 3, c0));
  __m512i A = _mm512_inserti64x4(_mm512_castsi256_si512(rw0), rw1, 1);
  __m512i B = _mm512_inserti64x4(_mm512_castsi256_si512(rw2), rw3, 1);
  __m512i p0 = gather_col(A, B, VG_P[0]);
  const __m512i p1 = gather_col(A, B, VG_P[1]);
  __m512i q0 = gather_col(A, B, VG_Q[0]);
  const __m512i q1 = gather_col(A, B, VG_Q[1]);
  chroma_filter16(p0, p1, q0, q1, tc, SEG_LANES[m4 & 15]);
  __m512i F = _mm512_castsi128_si512(_mm512_cvtepi32_epi8(p0));
  F = _mm512_inserti32x4(F, _mm512_cvtepi32_epi8(q0), 1);
  A = _mm512_permutex2var_epi8(A, _mm512_load_si512((const void *)MA_C.b), F);
  B = _mm512_permutex2var_epi8(B, _mm512_load_si512((const void *)MB_C.b), F);
  const __mmask32 wm = QUAD_BYTES[m4 & 15];
  _mm256_mask_storeu_epi8(&pl.at(rbase + 0, c0), wm, _mm512_extracti64x4_epi64(A, 0));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 1, c0), wm, _mm512_extracti64x4_epi64(A, 1));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 2, c0), wm, _mm512_extracti64x4_epi64(B, 0));
  _mm256_mask_storeu_epi8(&pl.at(rbase + 3, c0), wm, _mm512_extracti64x4_epi64(B, 1));
}

void chroma_hor_quad(const PlaneView &pl, int r0, int c0, int side, unsigned m4,
                     int tc) {
  __m512i p0 = gather_row(&pl.at(r0 + 3, c0), HG[side]);
  const __m512i p1 = gather_row(&pl.at(r0 + 2, c0), HG[side]);
  __m512i q0 = gather_row(&pl.at(r0 + 4, c0), HG[0]);
  const __m512i q1 = gather_row(&pl.at(r0 + 5, c0), HG[0]);
  chroma_filter16(p0, p1, q0, q1, tc, SEG_LANES[m4 & 15]);
  const __mmask32 act = QUAD_BYTES[m4 & 15];
  scatter_row(&pl.at(r0 + 3, c0), p0, side, act);
  scatter_row(&pl.at(r0 + 4, c0), q0, 0, act);
}

}  // namespace

// Compiled-capability flag consumed by deblock_cpu.cpp's select_isa: if this
// TU is ever built WITHOUT the AVX-512 macros (non-Makefile build, exotic
// compiler), the stub below returns 0 and dispatch can never route frames
// into a silent no-op (round-4 advisor finding).
extern "C" int gvct_avx512_compiled() { return 1; }

extern "C" void gvct_tile_row_avx512(
    uint8_t *plane, int stride, int by, int nx,
    const uint8_t *vert_bs, long long n_vert,
    const uint8_t *hor_bs, long long n_hor,
    long long sv, long long sh, int gate_ny, int gate_nx,
    int beta, int tc, int chroma) {
  const PlaneView pl{plane, stride};
  int bx = 0;
  for (; bx + 4 <= nx; bx += 4) {
    // per-tile edge gates (Q2 OOB->0 + boundary gates), as 4-bit quad masks
    unsigned mv1 = 0, mv2 = 0, mh1 = 0, mh2 = 0;
    for (int t = 0; t < 4; ++t) {
      const int b = bx + t;
      const int bs_v1 = by > 0 ? bs_flat(vert_bs, n_vert, (long long)(by - 1) * sv + b) : 0;
      const int bs_v2 = by < gate_ny - 1 ? bs_flat(vert_bs, n_vert, (long long)by * sv + b) : 0;
      const int bs_h1 = b > 0 ? bs_flat(hor_bs, n_hor, (long long)by * sh + b - 1) : 0;
      const int bs_h2 = b < gate_nx - 1 ? bs_flat(hor_bs, n_hor, (long long)by * sh + b) : 0;
      if (chroma ? bs_v1 == 2 : bs_v1 > 0) mv1 |= 1u << t;
      if (chroma ? bs_v2 == 2 : bs_v2 > 0) mv2 |= 1u << t;
      if (chroma ? bs_h1 == 2 : bs_h1 > 0) mh1 |= 1u << t;
      if (chroma ? bs_h2 == 2 : bs_h2 > 0) mh2 |= 1u << t;
    }
    if (!(mv1 | mv2 | mh1 | mh2)) continue;
    const int r0 = by * kBlock, c0 = bx * kBlock;
    // Q7 phase order; tiles within a quad are independent, so batching a
    // phase across the quad is byte-identical to per-tile order.
    if (chroma) {
      if (mv1) chroma_vert_quad(pl, r0 + 0, c0, mv1, tc);
      if (mv2) chroma_vert_quad(pl, r0 + 4, c0, mv2, tc);
      if (mh1) chroma_hor_quad(pl, r0, c0, 0, mh1, tc);
      if (mh2) chroma_hor_quad(pl, r0, c0, 1, mh2, tc);
    } else {
      if (mv1) luma_vert_quad(pl, r0 + 0, c0, mv1, beta, tc);
      if (mv2) luma_vert_quad(pl, r0 + 4, c0, mv2, beta, tc);
      if (mh1) luma_hor_quad(pl, r0, c0, 0, mh1, beta, tc);
      if (mh2) luma_hor_quad(pl, r0, c0, 1, mh2, beta, tc);
    }
  }
  // tail tiles (nx % 4): the shared per-tile path
  for (; bx < nx; ++bx) {
    const int bs_v1 = by > 0 ? bs_flat(vert_bs, n_vert, (long long)(by - 1) * sv + bx) : 0;
    const int bs_v2 = by < gate_ny - 1 ? bs_flat(vert_bs, n_vert, (long long)by * sv + bx) : 0;
    const int bs_h1 = bx > 0 ? bs_flat(hor_bs, n_hor, (long long)by * sh + bx - 1) : 0;
    const int bs_h2 = bx < gate_nx - 1 ? bs_flat(hor_bs, n_hor, (long long)by * sh + bx) : 0;
    if (chroma) filter_tile<true>(pl, by, bx, bs_v1, bs_v2, bs_h1, bs_h2, beta, tc);
    else        filter_tile<false>(pl, by, bx, bs_v1, bs_v2, bs_h1, bs_h2, beta, tc);
  }
}

#else  // non-x86_64 or AVX-512 flags missing: never-called stub

// 0 = not compiled: select_isa ANDs this in, so the stub below can never be
// reached even on an AVX-512-capable host.
extern "C" int gvct_avx512_compiled() { return 0; }

extern "C" void gvct_tile_row_avx512(
    uint8_t *, int, int, int, const uint8_t *, long long, const uint8_t *,
    long long, long long, long long, int, int, int, int, int) {}

#endif

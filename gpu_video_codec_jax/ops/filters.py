"""Vectorized, branchless HEVC deblocking edge filters.

This is the spec layer: the per-4-row-segment filter math of the reference
(cpu.h:1074-1488), re-expressed as masked elementwise integer arithmetic over
arbitrary batches of segments.  The same functions run:

* under `jax.jit` on whole-frame tile-plane batches (ops/deblock.py),
* inside the fused GPU kernel (ops/pallas_kernel.py) on blocks of tiles held
  in registers,
* and (via jax on CPU) in tests against the scalar golden model.

Conventions
-----------
A luma segment is 4 filter rows x 8 pixels across the edge:
    p[r][j] = j-th pixel on the P side of row r (j = distance from the edge),
    q[r][j] = j-th pixel on the Q side.
The core functions (`*_planes`) take nested lists of per-(row, distance)
batch arrays -- shape (*B) each (e.g. the (By, Bx) tile grid, or one
kernel program's block of tiles) -- and return the same structure.
Operating on separate planes rather than one stacked (4, 4, *B) array
avoids materializing stack/unstack relayouts inside the kernel; the row
dimension is fully unrolled.
Array-shaped wrappers (`luma_edge_filter`, `chroma_edge_filter`) exist for
convenience and tests.

All arithmetic is signed 32-bit (or the caller's `dtype` -- see
`luma_edge_filter` for the int16 bit-exactness argument) with arithmetic
right shift, matching the reference's `int` math (cpu.h:1154, 1253; quirk Q8).
The reference's `if` cascades become masks; outputs equal inputs wherever a
gate is off, which is exactly the reference's in-place no-write behavior.
"""

from __future__ import annotations

import jax.numpy as jnp

from .tables import MAX_PIXEL


def _clip1(delta, c):
    """Clamp to [-c, c] (cpu.h:1117-1120). c >= 0 always holds here."""
    return jnp.clip(delta, -c, c)


def _clip2(value):
    """Clamp to [0, 255] (cpu.h:1123-1126 with max_v = (1<<8)-1, cpu.h:1202)."""
    return jnp.clip(value, 0, MAX_PIXEL)


def _asr(x, n: int):
    """Arithmetic shift right; jnp >> on int32 is arithmetic for signed dtypes."""
    return x >> n


def _iabs(x):
    """|x| (magnitudes here never approach the dtype minimum, so exact)."""
    return jnp.abs(x)


def _thr(value, dtype):
    """Scalar threshold -> 0-d `dtype` array usable in vector compares.

    Threshold derivations (//, *) happen in int32 *before* this call;
    int16 holds every threshold value (max 10*tc = 200) exactly.
    """
    return jnp.asarray(value, jnp.int32).astype(dtype)


def _second_deriv(a):
    """|x2 - 2*x1 + x0| for one side-row a = [x0, x1, x2, ...]."""
    return _iabs(a[2] - 2 * a[1] + a[0])


def luma_edge_filter_planes(p, q, bs_mask, beta, tc, dtype=jnp.int32):
    """Luma edge dispatch on nested-list planes (cpu.h:1359-1429).

    p, q: 4x4 nested lists [row][dist] of `dtype` batch arrays (*B each).
    bs_mask: bool (*B) (True where `BS > 0`, cpu.h:164).  beta, tc: int32
    scalars.  Returns (new_p, new_q) nested lists; distance-3 entries are
    the input arrays unchanged.
    """
    # ---- shared second-derivative magnitudes (rows 0 and 3) --------------
    # used by cond1 (cpu.h:1086), cond2 (cpu.h:1099) and cond5/6 (cpu.h:1245)
    dp0, dp3 = _second_deriv(p[0]), _second_deriv(p[3])
    dq0, dq3 = _second_deriv(q[0]), _second_deriv(q[3])

    # pair sums shared between cond1 and cond2 (associativity is exact here:
    # magnitudes stay far below the dtype range)
    pq0, pq3 = dp0 + dq0, dp3 + dq3
    cond1 = (pq0 + pq3) < _thr(beta, dtype)

    beta8 = _thr(beta // 8, dtype)
    cond2 = (pq0 < beta8) & (pq3 < beta8)                            # cpu.h:1099-1100
    cond3 = ((_iabs(p[0][3] - p[0][0]) + _iabs(q[0][0] - q[0][3])) < beta8) & (
        (_iabs(p[3][3] - p[3][0]) + _iabs(q[3][0] - q[3][3])) < beta8
    )                                                                 # cpu.h:1104-1105
    tc52 = _thr((5 * tc) // 2, dtype)
    cond4 = (_iabs(p[0][0] - q[0][0]) < tc52) & (_iabs(p[3][0] - q[3][0]) < tc52)  # cpu.h:1109

    gate = bs_mask & cond1
    use_strong = gate & (cond2 & cond3 & cond4)   # cpu.h:1394
    use_normal = gate & ~(cond2 & cond3 & cond4)  # cpu.h:1413

    c = _thr(2 * tc, dtype)          # cpu.h:1191, 1235
    c2 = _thr(tc // 2, dtype)        # cpu.h:1236
    beta316 = _thr((3 * beta) // 16, dtype)
    tc10 = _thr(10 * tc, dtype)
    cond5 = (dp0 + dp3) < beta316    # cpu.h:1245
    cond6 = (dq0 + dq3) < beta316    # cpu.h:1249

    new_p = [[None] * 4 for _ in range(4)]
    new_q = [[None] * 4 for _ in range(4)]
    for r in range(4):
        p0, p1, p2, p3 = p[r]
        q0, q1, q2, q3 = q[r]

        # strong filter deltas (cpu.h:1152-1199), rewritten in VALUE form
        # around shared three-term sums t = p1+p0+q0 and u = q1+q0+p0: the
        # reference's delta numerators carry -6p0/-3p1/-5p2 style terms whose
        # non-power-of-2 multiplies are extra ALU ops; using
        # (A - 2^k*B) >> k == (A >> k) - B (exact for arithmetic shift, any
        # A) every multiply folds into shifts/adds of the shared sums.  Each
        # form below equals the cited reference numerator bit-for-bit.
        tpq = p0 + q0
        t = p1 + tpq                 # p1 + p0 + q0
        u = q1 + tpq                 # q1 + q0 + p0
        # cpu.h:1153: (p2 + 2p1 - 6p0 + 2q0 + q1 + 4)>>3 == ((2t + p2 + q1 + 4)>>3) - p0
        s0p = _clip1(_asr(2 * t + p2 + q1 + 4, 3) - p0, c)
        # cpu.h:1160: (p2 - 3p1 + p0 + q0 + 2)>>2 == ((t + p2 + 2)>>2) - p1
        s1p = _clip1(_asr(t + p2 + 2, 2) - p1, c)
        # cpu.h:1167: (2p3 - 5p2 + p1 + p0 + q0 + 4)>>3 == ((2p3 + 2p2 + p2 + t + 4)>>3) - p2
        s2p = _clip1(_asr(2 * (p3 + p2) + p2 + t + 4, 3) - p2, c)
        s0q = _clip1(_asr(2 * u + q2 + p1 + 4, 3) - q0, c)
        s1q = _clip1(_asr(u + q2 + 2, 2) - q1, c)
        s2q = _clip1(_asr(2 * (q3 + q2) + q2 + u + 4, 3) - q2, c)

        # normal filter (cpu.h:1252-1275): per-row |delta0| gate.
        # 9x == 8x + x and 3x == 2x + x: shifts/adds instead of multiplies
        d0 = q0 - p0
        d1 = q1 - p1
        delta0 = _asr(8 * d0 + d0 - (2 * d1 + d1) + 8, 4)
        row_gate = _iabs(delta0) < tc10
        big_d = _clip1(delta0, c)
        dp1 = _clip1(_asr(_asr(p2 + p0 + 1, 1) - p1 + big_d, 1), c2)
        dq1 = _clip1(_asr(_asr(q2 + q0 + 1, 1) - q1 - big_d, 1), c2)

        nrow = use_normal & row_gate
        # select the DELTA (0 where no filter applies), then one add + one
        # clip2 per output: clip2(x + 0) == x for valid pixels (inputs are
        # uint8-range by construction), so this equals the reference's
        # per-branch clip2 writes bit-for-bit with ~1/3 fewer select ops
        zero = _thr(0, dtype)
        new_p[r][0] = _clip2(p0 + jnp.where(use_strong, s0p,
                                            jnp.where(nrow, big_d, zero)))
        new_p[r][1] = _clip2(p1 + jnp.where(use_strong, s1p,
                                            jnp.where(nrow & cond5, dp1, zero)))
        new_p[r][2] = _clip2(p2 + jnp.where(use_strong, s2p, zero))
        new_p[r][3] = p3
        new_q[r][0] = _clip2(q0 + jnp.where(use_strong, s0q,
                                            jnp.where(nrow, -big_d, zero)))
        new_q[r][1] = _clip2(q1 + jnp.where(use_strong, s1q,
                                            jnp.where(nrow & cond6, dq1, zero)))
        new_q[r][2] = _clip2(q2 + jnp.where(use_strong, s2q, zero))
        new_q[r][3] = q3
    return new_p, new_q


def chroma_edge_filter_planes(p, q, bs_mask, tc, dtype=jnp.int32):
    """Chroma edge filter on nested-list planes (cpu.h:1431-1488).

    p, q: 4x2 nested lists [row][dist] of `dtype` batch arrays.  bs_mask:
    bool (*B) (True where BS == 2, cpu.h:463 -- chroma gates on equality,
    unlike luma's `> 0`).  Only distance-0 entries change.  The P/Q delta
    asymmetry of the reference (delta_q computed with operands swapped then
    *subtracted*, cpu.h:1453-1461, 1475-1476) is replicated exactly.
    """
    tc_v = _thr(tc, dtype)
    zero = _thr(0, dtype)
    new_p = [[None, p[r][1]] for r in range(4)]
    new_q = [[None, q[r][1]] for r in range(4)]
    for r in range(4):
        p0, p1 = p[r]
        q0, q1 = q[r]
        dp = _clip1(_asr(4 * (p0 - q0) + p1 - q1 + 4, 3), tc_v)  # cpu.h:1453, 1464
        dq = _clip1(_asr(4 * (q0 - p0) + q1 - p1 + 4, 3), tc_v)  # cpu.h:1458, 1469
        # delta-select form: clip2(x + 0) == x for valid pixels (cpu.h:1475-1476)
        new_p[r][0] = _clip2(p0 + jnp.where(bs_mask, dp, zero))
        new_q[r][0] = _clip2(q0 - jnp.where(bs_mask, dq, zero))
    return new_p, new_q


# ---------------------------------------------------------------------------
# Array-shaped wrappers (tests / external callers)
# ---------------------------------------------------------------------------

def luma_segment_decisions(p, q, beta, tc, dtype=jnp.int32):
    """Per-segment filter decisions from rows 0 and 3 (cpu.h:1074-1114).

    p, q: (4, 4, *B) arrays.  Returns (cond1, strong).
    """
    pl = [[p[r, j].astype(dtype) for j in range(4)] for r in range(4)]
    ql = [[q[r, j].astype(dtype) for j in range(4)] for r in range(4)]
    dp0, dp3 = _second_deriv(pl[0]), _second_deriv(pl[3])
    dq0, dq3 = _second_deriv(ql[0]), _second_deriv(ql[3])
    cond1 = (dp0 + dp3 + dq0 + dq3) < _thr(beta, dtype)
    beta8 = _thr(beta // 8, dtype)
    cond2 = ((dp0 + dq0) < beta8) & ((dp3 + dq3) < beta8)
    cond3 = ((_iabs(pl[0][3] - pl[0][0]) + _iabs(ql[0][0] - ql[0][3])) < beta8) & (
        (_iabs(pl[3][3] - pl[3][0]) + _iabs(ql[3][0] - ql[3][3])) < beta8
    )
    tc52 = _thr((5 * tc) // 2, dtype)
    cond4 = (_iabs(pl[0][0] - ql[0][0]) < tc52) & (_iabs(pl[3][0] - ql[3][0]) < tc52)
    return cond1, cond2 & cond3 & cond4


def luma_edge_filter(p, q, bs_mask, beta, tc, dtype=jnp.int32):
    """Array wrapper over luma_edge_filter_planes.

    p, q: integer (4 rows, 4 dists, *B); bs_mask: bool (*B); beta/tc int32
    scalars (python ints or traced).
    dtype: compute dtype.  int32 matches the reference's C++ `int` math; an
    int16 path is bit-identical (every intermediate fits: the largest
    magnitudes are the strong-filter numerators, |.| <= 6*255 + 2*255 + 255
    + 4 < 2**12, and 9*(q0-p0) - 3*(q1-p1) + 8, |.| <= 12*255 + 8 < 2**12);
    int32 is the default everywhere.
    Returns (new_p, new_q), same shapes; distance-3 pixels never change.
    """
    pl = [[p[r, j].astype(dtype) for j in range(4)] for r in range(4)]
    ql = [[q[r, j].astype(dtype) for j in range(4)] for r in range(4)]
    np_, nq_ = luma_edge_filter_planes(pl, ql, bs_mask, beta, tc, dtype=dtype)
    new_p = jnp.stack([jnp.stack(row) for row in np_])
    new_q = jnp.stack([jnp.stack(row) for row in nq_])
    return new_p, new_q


def chroma_edge_filter(p, q, bs_mask, tc, dtype=jnp.int32):
    """Array wrapper over chroma_edge_filter_planes.

    p, q: integer (4 rows, 2 dists, *B); bs_mask: bool (*B, True where
    BS == 2); tc: int32 scalar.  Only distance-0 pixels change.
    """
    pl = [[p[r, j].astype(dtype) for j in range(2)] for r in range(4)]
    ql = [[q[r, j].astype(dtype) for j in range(2)] for r in range(4)]
    np_, nq_ = chroma_edge_filter_planes(pl, ql, bs_mask, tc, dtype=dtype)
    new_p = jnp.stack([jnp.stack(row) for row in np_])
    new_q = jnp.stack([jnp.stack(row) for row in nq_])
    return new_p, new_q

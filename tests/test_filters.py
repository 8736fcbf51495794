"""Vectorized segment filters vs the scalar golden model on random segments.

Covers every gate combination statistically: random pixels hit strong/normal
decisions, per-row |delta0| gates, cond5/cond6 side gates, and BS-off
segments, across the full QP range including the no-op band (QP < 16/18)
and the >51 clamp.
"""

import numpy as np
import pytest

import golden
from gpu_video_codec_jax.ops.filters import (
    chroma_edge_filter, luma_edge_filter, luma_segment_decisions,
)
from gpu_video_codec_jax.ops.tables import get_beta, get_tc

QPS = [0, 15, 16, 17, 18, 20, 27, 35, 43, 51, 60]


def _random_segments(rng, n, nj, smooth=False):
    # batch shape (n, 1): the filter layer requires rank >= 2 batches
    # (thresholds broadcast as (1, 1) vectors -- see filters._thr)
    if smooth:
        base = rng.integers(0, 256, (1, 1, n, 1))
        noise = rng.integers(-4, 5, (4, nj, n, 1))
        p = np.clip(base + noise, 0, 255)
        q = np.clip(base + rng.integers(-4, 5, (4, nj, n, 1)), 0, 255)
    else:
        p = rng.integers(0, 256, (4, nj, n, 1))
        q = rng.integers(0, 256, (4, nj, n, 1))
    return p.astype(np.int32), q.astype(np.int32)


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("smooth", [False, True])
def test_luma_filter_matches_golden(rng, qp, smooth):
    beta, tc = get_beta(qp), get_tc(qp)
    n = 256
    p, q = _random_segments(rng, n, 4, smooth)
    mask = rng.integers(0, 2, (n, 1)).astype(bool)

    vp, vq = luma_edge_filter(p, q, mask, beta, tc)
    vp, vq = np.asarray(vp), np.asarray(vq)

    for i in range(n):
        pi = [[int(p[r, j, i, 0]) for j in range(4)] for r in range(4)]
        qi = [[int(q[r, j, i, 0]) for j in range(4)] for r in range(4)]
        if mask[i, 0]:
            gp, gq = golden.luma_filter_segment(pi, qi, beta, tc)
        else:
            gp, gq = pi, qi
        assert vp[:, :, i, 0].tolist() == gp, f"P mismatch seg {i} qp={qp}"
        assert vq[:, :, i, 0].tolist() == gq, f"Q mismatch seg {i} qp={qp}"


@pytest.mark.parametrize("qp", QPS)
@pytest.mark.parametrize("smooth", [False, True])
def test_chroma_filter_matches_golden(rng, qp, smooth):
    tc = get_tc(qp)
    n = 256
    p, q = _random_segments(rng, n, 2, smooth)
    mask = rng.integers(0, 2, (n, 1)).astype(bool)

    vp, vq = chroma_edge_filter(p, q, mask, tc)
    vp, vq = np.asarray(vp), np.asarray(vq)

    for i in range(n):
        pi = [[int(p[r, j, i, 0]) for j in range(2)] for r in range(4)]
        qi = [[int(q[r, j, i, 0]) for j in range(2)] for r in range(4)]
        if mask[i, 0]:
            gp, gq = golden.chroma_filter_segment(pi, qi, tc)
        else:
            gp, gq = pi, qi
        assert vp[:, :, i, 0].tolist() == gp, f"chroma P mismatch seg {i} qp={qp}"
        assert vq[:, :, i, 0].tolist() == gq, f"chroma Q mismatch seg {i} qp={qp}"


@pytest.mark.parametrize("qp", [0, 17, 27, 35, 51])
@pytest.mark.parametrize("smooth", [False, True])
def test_luma_segment_decisions_match_golden(rng, qp, smooth):
    """The public decision wrapper (cond1 / strong-select, cpu.h:1074-1114)
    must agree with the scalar oracle's check_local_adaptivity +
    is_strong_filter on random segments -- including the convention that
    `strong` is only meaningful where cond1 holds (the oracle evaluates
    is_strong_filter only after cond1 passes, cpu.h:1370-1373)."""
    beta, tc = get_beta(qp), get_tc(qp)
    n = 256
    p, q = _random_segments(rng, n, 4, smooth)
    cond1, strong = luma_segment_decisions(p, q, beta, tc)
    cond1, strong = np.asarray(cond1), np.asarray(strong)
    for i in range(n):
        pi = [[int(p[r, j, i, 0]) for j in range(4)] for r in range(4)]
        qi = [[int(q[r, j, i, 0]) for j in range(4)] for r in range(4)]
        g1 = golden.check_local_adaptivity(pi, qi, beta)
        assert bool(cond1[i, 0]) == g1, f"cond1 mismatch seg {i} qp={qp}"
        if g1:  # oracle's dispatch order: strong only evaluated under cond1
            gs = golden.is_strong_filter(pi, qi, beta, tc)
            assert bool(strong[i, 0]) == gs, f"strong mismatch seg {i} qp={qp}"


def test_strong_filter_hand_case():
    """Flat step edge with QP 35 must take the strong path; verify one row by hand.

    p rows all [100,100,100,100], q rows all [108,108,108,108], beta=32, tc=4.
    cond1: 0 < 32 ok. cond2: 0 < 32//8=4 ok. cond3: 0 < 4 ok.
    cond4: |100-108| = 8 < (5*4)//2 = 10 ok -> strong.
    d0p = (100+200-600+216+108+4)>>3 = 28>>3 = 3, clip(+-8) -> 3 -> p0 = 103
    d1p = (100-300+100+108+2)>>2 = 10>>2 = 2 -> p1 = 102
    d2p = (200-500+100+100+108+4)>>3 = 12>>3 = 1 -> p2 = 101
    symmetric q deltas: d0q = (108+216-648+200+100+4)>>3 = -20>>3 = -3 -> q0 = 105
    d1q = (108-324+108+100+2)>>2 = -6>>2 = -2 -> q1 = 106
    d2q = (216-540+108+108+100+4)>>3 = -4>>3 = -1 -> q2 = 107
    """
    p = np.full((4, 4, 1, 1), 100, np.int32)
    q = np.full((4, 4, 1, 1), 108, np.int32)
    vp, vq = luma_edge_filter(p, q, np.array([[True]]), get_beta(35), get_tc(35))
    assert np.asarray(vp)[0, :, 0, 0].tolist() == [103, 102, 101, 100]
    assert np.asarray(vq)[0, :, 0, 0].tolist() == [105, 106, 107, 108]


def test_normal_filter_hand_case():
    """Segment that fails cond4 (large step) but passes cond1 -> normal filter.

    QP 37: beta=36, tc=4 -> 5*tc//2 = 10; pick p = 100 flat, q = 114 flat so
    cond4 fails (14 >= 10) while cond1 (0 < 36) holds -> normal filter.
    delta0 = (9*14 - 3*14 + 8)>>4 = 92>>4 = 5 < 10*tc = 40; D = clip(5, 8) = 5
    -> p0 = 105, q0 = 109.  cond5/6: 0 < (3*36)//16 = 6 ok; c2 = 2.
    dp1 = (((100+100+1)>>1) - 100 + 5)>>1 = 2, clip(+-2) = 2 -> p1 = 102
    dq1 = (((114+114+1)>>1) - 114 - 5)>>1 = -5>>1 = -3 -> clip = -2 -> q1 = 112
    """
    p = np.full((4, 4, 1, 1), 100, np.int32)
    q = np.full((4, 4, 1, 1), 114, np.int32)
    vp, vq = luma_edge_filter(p, q, np.array([[True]]), get_beta(37), get_tc(37))
    assert np.asarray(vp)[0, :, 0, 0].tolist() == [105, 102, 100, 100]
    assert np.asarray(vq)[0, :, 0, 0].tolist() == [109, 112, 114, 114]


def test_chroma_hand_case():
    """p=100 flat, q=120 flat, tc=4: dp = ((100-120)*4 + 0 + 4)>>3 = -76>>3 = -10
    -> clip(+-4) = -4 -> p0 = 96; dq = ((120-100)*4 + 0 + 4)>>3 = 84>>3 = 10
    -> clip = 4 -> q0 = 120 - 4 = 116."""
    p = np.full((4, 2, 1, 1), 100, np.int32)
    q = np.full((4, 2, 1, 1), 120, np.int32)
    vp, vq = chroma_edge_filter(p, q, np.array([[True]]), 4)
    assert np.asarray(vp)[0, :, 0, 0].tolist() == [96, 100]
    assert np.asarray(vq)[0, :, 0, 0].tolist() == [116, 120]

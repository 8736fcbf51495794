"""Boundary-strength subsystem: reference-exact init pattern, flat-index
segment lookups (incl. quirks Q2/Q4), and the injection API."""

import numpy as np
import pytest

from gpu_video_codec_jax.utils.bs import (
    BoundaryStrength,
    chroma_segment_maps,
    luma_segment_maps,
    segment_bs_maps,
)


def test_init_sizes_and_pattern():
    W, H = 64, 48
    bs = BoundaryStrength.intra_default(W, H)
    # sizes per cpu.h:86-87, 104-105
    assert bs.vert.size == (W // 8 + 1) * (H // 8)
    assert bs.hor.size == (H // 8 + 1) * (W // 8)
    assert bs.chroma_vert.size == (W // 16 + 1) * (H // 16)
    assert bs.chroma_hor.size == (H // 16 + 1) * (W // 16)
    # init: 2 everywhere except every (stride)-th flat index (cpu.h:92-99)
    for arr, stride in (
        (bs.vert, W // 8 + 1),
        (bs.hor, H // 8 + 1),  # Q4: hor zero-stripe stride is H/8+1, not W/8
        (bs.chroma_vert, W // 16 + 1),
        (bs.chroma_hor, H // 16 + 1),
    ):
        expect = np.full(arr.size, 2, np.uint8)
        expect[::stride] = 0
        assert np.array_equal(arr, expect)


def test_luma_segment_maps_scalar_crosscheck():
    W, H = 64, 48
    rng = np.random.default_rng(7)
    bs = BoundaryStrength.intra_default(W, H)
    bs.set_luma(
        rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.hor.size, dtype=np.uint8),
    )
    ny, nx = H // 8 + 1, W // 8 + 1
    ver1, ver2, hor1, hor2 = luma_segment_maps(bs)
    sv, sh = W // 8 + 1, W // 8
    for by in range(ny):
        for bx in range(nx):
            # reference index arithmetic, cpu.h:160-163, 223-227, 287-291, 368-372
            assert ver1[by, bx] == (bs.vert[(by - 1) * sv + bx] if by > 0 else 0)
            assert ver2[by, bx] == (bs.vert[by * sv + bx] if by < ny - 1 else 0)
            assert hor1[by, bx] == (bs.hor[by * sh + bx - 1] if bx > 0 else 0)
            assert hor2[by, bx] == (bs.hor[by * sh + bx] if bx < nx - 1 else 0)


def test_chroma_q2_oob_reads_are_zero():
    """Q2: chroma ver2 at the last chroma tile row indexes past the end of the
    chroma vert BS array (luma-count gate passes); those reads must be 0."""
    W, H = 64, 48
    bs = BoundaryStrength.intra_default(W, H)
    cny, cnx = H // 16 + 1, W // 16 + 1
    ver1, ver2, hor1, hor2 = chroma_segment_maps(bs)
    assert ver2.shape == (cny, cnx)
    # last chroma tile row: flat idx = (cH/8)*(cW/8+1)+bx >= size for all bx
    assert np.all(ver2[-1, :] == 0)
    # interior rows follow the flat arithmetic and are nonzero somewhere
    assert np.any(ver2[:-1, :] == 2)
    # hor2 at the last column reads *in-bounds* flat entries for by < cH/8
    # (deterministic wrong-row values, reproduced exactly) and OOB (-> 0)
    # only at the bottom-right tile
    assert hor2[-1, -1] == 0


def test_injection_size_check():
    bs = BoundaryStrength.intra_default(64, 48)
    with pytest.raises(ValueError):
        bs.set_luma(np.zeros(3, np.uint8), np.zeros(bs.hor.size, np.uint8))
    v = np.ones(bs.vert.size, np.uint8)
    h = np.ones(bs.hor.size, np.uint8)
    bs.set_luma(v, h)
    assert np.array_equal(bs.vert, v)


def test_segment_maps_oob_never_raises():
    flat_v = np.array([2, 0, 1], np.uint8)
    flat_h = np.array([2], np.uint8)
    maps = segment_bs_maps(flat_v, flat_h, 8, 5, 5, 99, 99)
    for m in maps:
        assert m.shape == (5, 5)
        assert m.dtype == np.uint8


def test_minimal_8px_frame_does_not_crash():
    """width == height == 8: chroma BS arrays are zero-size; every chroma
    lookup is OOB and must read as 0 across all paths (regression: the
    vectorized lookup used to IndexError on empty arrays)."""
    import numpy as np

    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.models.pipeline import DeblockPipeline
    from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane

    rng = np.random.default_rng(3)
    frame = FramePlanes(
        extend_plane(rng.integers(0, 256, (8, 8), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (4, 4), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (4, 4), dtype=np.uint8)),
        8, 8,
    )
    bs = BoundaryStrength.intra_default(8, 8)
    assert bs.chroma_vert.size == 0 and bs.chroma_hor.size == 0
    gold = deblock_frame_golden(frame, bs, 35)
    out = DeblockPipeline(8, 8, 35, backend="jnp")(frame)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(gold, name), getattr(out, name)), name
    # chroma must be untouched (all BS reads OOB -> 0)
    assert np.array_equal(gold.u, frame.u)


def test_device_side_map_derivation_matches_host(rng):
    """segment_bs_maps_device (jnp, in-graph derivation) == host numpy maps."""
    import numpy as np

    from gpu_video_codec_jax.utils.bs import (
        chroma_segment_maps, luma_segment_maps, segment_bs_maps_device,
    )

    W, H = 64, 48
    bs = BoundaryStrength.intra_default(W, H)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    ny, nx = H // 8 + 1, W // 8 + 1
    host = luma_segment_maps(bs)
    dev = segment_bs_maps_device(bs.vert, bs.hor, W, ny, nx, ny, nx)
    for a, b in zip(host, dev):
        assert np.array_equal(a, np.asarray(b))
    cny, cnx = H // 16 + 1, W // 16 + 1
    host_c = chroma_segment_maps(bs)
    dev_c = segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, W // 2,
                                   cny, cnx, ny, nx)
    for a, b in zip(host_c, dev_c):
        assert np.array_equal(a, np.asarray(b))

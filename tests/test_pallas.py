"""Fused deblock kernel vs the XLA tile-plane path and the golden oracle.

On CPU the kernel runs in the Pallas interpreter (same kernel code, same
core filter functions); the compiled kernel is exercised by the `gpu`
tests below on a card, and by chip_smoke.py.
"""

import numpy as np
import pytest

from bench.bench_lib import synthetic_frame
from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane


def _random_frame(rng, w, h):
    return FramePlanes(
        extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        w, h,
    )


@pytest.mark.parametrize("qp", [17, 35, 51])
def test_pallas_matches_golden_random(rng, qp):
    w, h = 64, 48
    frame = _random_frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(frame, bs, qp)
    out = DeblockPipeline(w, h, qp, backend="pallas")(frame)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(gold, name), getattr(out, name)), name


def test_pallas_matches_jnp_on_cif(testdata_dir):
    import os

    from gpu_video_codec_jax.utils.yuv import read_yv12

    frame = read_yv12(os.path.join(testdata_dir, "image1_352x288_yv12.yuv"), 352, 288)
    bs = BoundaryStrength.intra_default(352, 288)
    a = DeblockPipeline(352, 288, 35, backend="jnp", bs=bs)(frame)
    b = DeblockPipeline(352, 288, 35, backend="pallas", bs=bs)(frame)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_pallas_tail_blocks(rng):
    """Tile grids far from block multiples must round-trip exactly
    (the masked tail lanes may not leak into real output)."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.pallas_kernel import deblock_tiles_pallas
    from gpu_video_codec_jax.utils.bs import BoundaryStrength, luma_segment_maps
    from gpu_video_codec_jax.utils.tiles import plane_to_tiles

    w, h = 24, 16  # tile grid 3x4 -- far below one program's block
    frame = _random_frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    maps = luma_segment_maps(bs)
    tiles = jnp.asarray(plane_to_tiles(frame.y))
    ref = np.asarray(deblock_tiles(tiles, *[jnp.asarray(m) for m in maps], 32, 4))
    out = np.asarray(
        deblock_tiles_pallas(tiles, *[jnp.asarray(m) for m in maps], 32, 4)
    )
    assert np.array_equal(ref, out)


@pytest.mark.parametrize("qp", [18, 35, 51])
def test_int16_compute_bitexact(rng, qp):
    """int16 compute dtype must be bit-identical to int32 (the reference's
    C++ `int` semantics) -- every intermediate fits."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.tables import get_beta, get_tc
    from gpu_video_codec_jax.utils.bs import BoundaryStrength, luma_segment_maps, chroma_segment_maps
    from gpu_video_codec_jax.utils.tiles import plane_to_tiles

    w, h = 64, 48
    frame = _random_frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    beta, tc = get_beta(qp), get_tc(qp)
    for plane, maps, chroma in (
        (frame.y, luma_segment_maps(bs), False),
        (frame.u, chroma_segment_maps(bs), True),
    ):
        tiles = jnp.asarray(np.asarray(plane_to_tiles(plane)))
        ms = [jnp.asarray(m) for m in maps]
        a = np.asarray(deblock_tiles(tiles, *ms, beta, tc, chroma=chroma, dtype=jnp.int32))
        b = np.asarray(deblock_tiles(tiles, *ms, beta, tc, chroma=chroma, dtype=jnp.int16))
        assert np.array_equal(a, b), (qp, chroma)


# A geometry whose tile grids leave tails: luma 26x16 = 416 tiles (3 full
# 128-tile programs + 32), fused U+V 2x(14x13) = 364 tiles (1 full 256-tile
# program + 108).  The smooth synthetic frame makes the filters fire.
_TAIL_W, _TAIL_H = 200, 120


def _tail_case(plane):
    from gpu_video_codec_jax.utils.bs import chroma_segment_maps, luma_segment_maps
    from gpu_video_codec_jax.utils.tiles import plane_to_tiles, split_covered

    frame = synthetic_frame(_TAIL_W, _TAIL_H, seed=3)
    bs = BoundaryStrength.intra_default(_TAIL_W, _TAIL_H)
    if plane == "luma":
        return frame, bs, plane_to_tiles(frame.y), luma_segment_maps(bs)
    ut = plane_to_tiles(split_covered(frame.u)[0])
    vt = plane_to_tiles(split_covered(frame.v)[0])
    maps = [np.concatenate([m, m], axis=0) for m in chroma_segment_maps(bs)]
    return frame, bs, np.concatenate([ut, vt], axis=2), maps


@pytest.mark.parametrize("qp", [0, 16, 35, 51])
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_kernel_interpret_matches_xla_and_golden(plane, qp):
    """The kernel in interpret mode equals deblock_tiles on a grid with
    tails, and the planes it filters equal the golden model's."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.pallas_kernel import (
        deblock_chroma_ext_pallas, deblock_tiles_pallas, interpret_mode,
    )
    from gpu_video_codec_jax.ops.tables import get_beta, get_tc
    from gpu_video_codec_jax.utils.bs import chroma_segment_maps
    from gpu_video_codec_jax.utils.tiles import tiles_to_plane

    assert interpret_mode()  # the CPU backend runs the interpreter
    frame, bs, tiles, maps = _tail_case(plane)
    assert tiles.shape[-2] * tiles.shape[-1] % 128 != 0  # a tail exists
    chroma = plane == "chroma"
    t, ms = jnp.asarray(tiles), [jnp.asarray(m) for m in maps]
    beta, tc = get_beta(qp), get_tc(qp)
    got = np.asarray(deblock_tiles_pallas(t, *ms, beta, tc, chroma=chroma))
    assert np.array_equal(got, np.asarray(deblock_tiles(t, *ms, beta, tc,
                                                        chroma=chroma)))
    assert np.array_equal(got, tiles) == (qp < 18)  # no-op band below QP 18

    gold = deblock_frame_golden(frame, bs, qp)
    if chroma:
        u, v = deblock_chroma_ext_pallas(
            jnp.asarray(frame.u), jnp.asarray(frame.v),
            [jnp.asarray(m) for m in chroma_segment_maps(bs)], beta, tc)
        assert np.array_equal(np.asarray(u), gold.u)
        assert np.array_equal(np.asarray(v), gold.v)
    else:
        assert np.array_equal(np.asarray(tiles_to_plane(jnp.asarray(got))), gold.y)


@pytest.mark.parametrize("shared", [True, False])
def test_kernel_batched_bs_maps(rng, shared):
    """A leading frame axis with one shared BS map (leading dim 1) or one
    map per frame equals deblock_tiles frame by frame."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.pallas_kernel import deblock_tiles_pallas
    from gpu_video_codec_jax.utils.tiles import plane_to_tiles

    frames = [synthetic_frame(64, 48, seed=i) for i in range(3)]
    tiles = jnp.asarray(np.stack([plane_to_tiles(f.y) for f in frames]))
    nb, by, bx = 3, tiles.shape[-2], tiles.shape[-1]
    maps = [jnp.asarray(rng.integers(0, 3, (1 if shared else nb, by, bx),
                                     dtype=np.uint8)) for _ in range(4)]
    got = np.asarray(deblock_tiles_pallas(tiles, *maps, 50, 8))
    for i in range(nb):
        mi = [m[0 if shared else i] for m in maps]
        want = np.asarray(deblock_tiles(tiles[i], *mi, 50, 8))
        assert np.array_equal(got[i], want), i


def test_kernel_batched_bs_map_shape_rejected():
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.pallas_kernel import deblock_tiles_pallas

    tiles = jnp.zeros((3, 8, 8, 2, 2), jnp.uint8)
    maps = [jnp.zeros((2, 2, 2), jnp.uint8)] * 4
    with pytest.raises(ValueError, match="leading dim of 1"):
        deblock_tiles_pallas(tiles, *maps, 50, 8)


@pytest.mark.parametrize("platform,expect", [
    ("cpu", True), ("gpu", False), ("rocm", ValueError), ("metal", ValueError),
])
def test_interpret_mode_rule(platform, expect):
    """Interpreted on cpu, compiled on gpu, an error naming any other."""
    from gpu_video_codec_jax.ops.pallas_kernel import interpret_mode

    if expect is ValueError:
        with pytest.raises(ValueError, match=repr(platform)):
            interpret_mode(platform)
    else:
        assert interpret_mode(platform) is expect


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_compiled_kernel_matches_xla(gpu, plane):
    """On a card: the Triton-compiled kernel equals deblock_tiles."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.pallas_kernel import (
        deblock_tiles_pallas, interpret_mode,
    )

    assert not interpret_mode()
    _, _, tiles, maps = _tail_case(plane)
    t, ms = jnp.asarray(tiles), [jnp.asarray(m) for m in maps]
    chroma = plane == "chroma"
    assert bool(jnp.array_equal(
        deblock_tiles_pallas(t, *ms, 64, 20, chroma=chroma),
        deblock_tiles(t, *ms, 64, 20, chroma=chroma)))

"""Bit-exact integration tests: jitted tile-plane pipeline vs the scalar
golden oracle, on the bundled reference frames (BASELINE configs 1-2) and on
random frames with random QP and injected BS (property tests)."""

import os

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane, read_yv12


def _assert_frames_equal(a: FramePlanes, b: FramePlanes, what=""):
    for name in ("y", "u", "v"):
        ga, gb = getattr(a, name), getattr(b, name)
        if not np.array_equal(ga, gb):
            n = int(np.sum(ga != gb))
            idx = np.argwhere(ga != gb)[:5]
            raise AssertionError(f"{what} plane {name}: {n} mismatching px, first at {idx.tolist()}")


def _random_frame(rng, w, h):
    return FramePlanes(
        extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        w, h,
    )


def test_config1_cif_luma_bitexact(testdata_dir):
    """BASELINE config 1: luma vert+horiz deblock, mother-daughter CIF, Qp 35
    (the reference main()'s committed workload, main.cu:128-133)."""
    frame = read_yv12(os.path.join(testdata_dir, "mother-daughter_352x288_yv12.yuv"), 352, 288)
    bs = BoundaryStrength.intra_default(352, 288)
    gold = deblock_frame_golden(frame, bs, 35, luma_only=True)
    pipe = DeblockPipeline(352, 288, 35, luma_only=True, backend="jnp")
    out = pipe(frame)
    _assert_frames_equal(gold, out, "config1")
    # the filter must actually have changed something at QP 35
    assert not np.array_equal(out.y, frame.y)


def test_config2_4cif_full_bitexact(testdata_dir):
    """BASELINE config 2: full luma+chroma deblock, image2 768x576."""
    frame = read_yv12(os.path.join(testdata_dir, "image2_768x576.yuv"), 768, 576)
    bs = BoundaryStrength.intra_default(768, 576)
    gold = deblock_frame_golden(frame, bs, 35)
    pipe = DeblockPipeline(768, 576, 35, backend="jnp")
    out = pipe(frame)
    _assert_frames_equal(gold, out, "config2")
    assert not np.array_equal(out.u, frame.u)


@pytest.mark.parametrize("qp", [10, 17, 22, 35, 51])
def test_random_frames_random_bs(rng, qp):
    """Property test: random 64x48 frames, random injected BS (incl. BS==1
    which filters luma but not chroma), full QP sweep incl. the no-op band."""
    w, h = 64, 48
    frame = _random_frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(
        rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.hor.size, dtype=np.uint8),
    )
    bs.set_chroma(
        rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8),
    )
    gold = deblock_frame_golden(frame, bs, qp)
    out = DeblockPipeline(w, h, qp, bs=bs)(frame)
    _assert_frames_equal(gold, out, f"qp={qp}")
    if qp == 10:
        # no-op band: beta == 0 => nothing may change
        _assert_frames_equal(frame, out, "qp=10 noop")


def test_smooth_frame_exercises_strong_path(rng):
    """Smooth gradients + QP 51 push segments down the strong-filter path."""
    w, h = 64, 64
    ramp = np.clip(
        np.arange(h)[:, None] * 2 + np.arange(w)[None, :] + rng.integers(-2, 3, (h, w)), 0, 255
    ).astype(np.uint8)
    cramp = ramp[: h // 2, : w // 2]
    frame = FramePlanes(extend_plane(ramp), extend_plane(cramp), extend_plane(cramp.T.copy()), w, h)
    bs = BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(frame, bs, 51)
    out = DeblockPipeline(w, h, 51)(frame)
    _assert_frames_equal(gold, out, "smooth qp=51")


def test_tile_independence(rng):
    """The layout invariant the whole design rests on: filtering the frame
    whole must equal filtering any tile-aligned horizontal slab independently
    (tiles never read outside themselves)."""
    import jax
    import jax.numpy as jnp

    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.utils.bs import luma_segment_maps
    from gpu_video_codec_jax.utils.tiles import plane_to_tiles, tiles_to_plane

    run = jax.jit(lambda t, m: deblock_tiles(t, *m, 32, 4))

    w, h = 64, 48
    frame = _random_frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    maps = luma_segment_maps(bs)
    tiles = np.asarray(plane_to_tiles(frame.y))

    whole = np.asarray(run(jnp.asarray(tiles), tuple(jnp.asarray(m) for m in maps)))

    # process tile-row slabs separately and restitch
    parts = []
    ny = tiles.shape[2]
    for lo, hi in [(0, 2), (2, 5), (5, ny)]:
        sl = run(jnp.asarray(tiles[:, :, lo:hi]), tuple(jnp.asarray(m[lo:hi]) for m in maps))
        parts.append(np.asarray(sl))
    stitched = np.concatenate(parts, axis=2)
    assert np.array_equal(whole, stitched)
    # sanity: result differs from input
    assert not np.array_equal(tiles_to_plane(whole), frame.y)

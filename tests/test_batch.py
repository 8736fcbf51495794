"""Batched one-step pipeline (config 3): frames folded into one tile grid."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane


def _frame(rng, w, h):
    return FramePlanes(
        extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        w, h,
    )


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_batch_matches_per_frame_golden(rng, backend):
    w, h = 64, 48
    frames = [_frame(rng, w, h) for _ in range(3)]
    bs = BoundaryStrength.intra_default(w, h)
    pipe = DeblockPipeline(w, h, 35, backend=backend)
    outs = pipe.batch(frames)
    assert len(outs) == 3
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(gold, name), getattr(o, name)), (backend, name)


def test_batch_odd_chroma(rng):
    """Batch fold with non-8-aligned chroma extents (1080p-class)."""
    w, h = 88, 72
    frames = [_frame(rng, w, h) for _ in range(2)]
    bs = BoundaryStrength.intra_default(w, h)
    outs = DeblockPipeline(w, h, 35, backend="jnp").batch(frames)
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(gold, name), getattr(o, name)), name


def test_batch_rejects_host_backends(rng):
    pipe = DeblockPipeline(64, 48, 35, backend="golden")
    with pytest.raises(ValueError):
        pipe.batch([_frame(rng, 64, 48)])


def test_batch_empty():
    assert DeblockPipeline(64, 48, 35).batch([]) == []


def test_batch_luma_only(rng):
    w, h = 64, 48
    frames = [_frame(rng, w, h) for _ in range(2)]
    bs = BoundaryStrength.intra_default(w, h)
    outs = DeblockPipeline(w, h, 35, backend="jnp", luma_only=True).batch(frames)
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35, luma_only=True)
        assert np.array_equal(gold.y, o.y)
        assert np.array_equal(f.u, o.u) and np.array_equal(f.v, o.v)

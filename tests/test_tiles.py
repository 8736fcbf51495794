import numpy as np
import pytest

from gpu_video_codec_jax.utils.tiles import plane_to_tiles, tiles_to_plane


def test_roundtrip(rng):
    plane = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    t = plane_to_tiles(plane)
    assert t.shape == (8, 8, 5, 8)
    assert np.array_equal(tiles_to_plane(t), plane)


def test_address_mapping(rng):
    """T[r, c, by, bx] must equal plane[8*by + r, 8*bx + c]."""
    plane = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    t = plane_to_tiles(plane)
    for by in range(3):
        for bx in range(4):
            for r in range(8):
                for c in range(8):
                    assert t[r, c, by, bx] == plane[8 * by + r, 8 * bx + c]


def test_leading_batch_dims(rng):
    planes = rng.integers(0, 256, (2, 3, 16, 24), dtype=np.uint8)
    t = plane_to_tiles(planes)
    assert t.shape == (2, 3, 8, 8, 2, 3)
    assert np.array_equal(tiles_to_plane(t), planes)
    assert np.array_equal(t[1, 2], plane_to_tiles(planes[1, 2]))


@pytest.fixture(params=["u8", "s8", "bf16"])
def mxu_dtype(request):
    """All MXU relayout dot dtypes must be bit-identical to the
    reshape+transpose engine (u8 = shift-free default, s8 = shifted
    round-2 engine, bf16 = fallback)."""
    return request.param


class TestMxuRelayout:
    """The MXU one-hot relayout engine (utils/tiles._plane_to_tiles_mxu)
    must be bit-identical to the reshape+transpose engine -- it is the
    alternative (GVCT_RELAYOUT=mxu) for every device graph's layout
    boundary."""

    @pytest.fixture(autouse=True)
    def _dtype(self, mxu_dtype, monkeypatch):
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", mxu_dtype)

    def _force(self, monkeypatch):
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")

    def test_forward_matches_transpose(self, rng, monkeypatch):
        import jax.numpy as jnp

        plane = rng.integers(0, 256, (40, 64), dtype=np.uint8)
        ref = plane_to_tiles(plane)  # numpy engine
        self._force(monkeypatch)
        got = plane_to_tiles(jnp.asarray(plane))
        assert got.dtype == jnp.uint8
        assert np.array_equal(np.asarray(got), ref)

    def test_inverse_matches_transpose(self, rng, monkeypatch):
        import jax.numpy as jnp

        plane = rng.integers(0, 256, (40, 64), dtype=np.uint8)
        t = plane_to_tiles(plane)
        self._force(monkeypatch)
        got = tiles_to_plane(jnp.asarray(t))
        assert np.array_equal(np.asarray(got), plane)

    def test_leading_dims(self, rng, monkeypatch):
        import jax.numpy as jnp

        planes = rng.integers(0, 256, (2, 3, 16, 24), dtype=np.uint8)
        ref = plane_to_tiles(planes)
        self._force(monkeypatch)
        t = plane_to_tiles(jnp.asarray(planes))
        assert np.array_equal(np.asarray(t), ref)
        assert np.array_equal(np.asarray(tiles_to_plane(t)), planes)

    def test_under_jit(self, rng, monkeypatch):
        import jax
        import jax.numpy as jnp

        plane = rng.integers(0, 256, (24, 32), dtype=np.uint8)
        self._force(monkeypatch)
        got = jax.jit(lambda x: tiles_to_plane(plane_to_tiles(x)))(jnp.asarray(plane))
        assert np.array_equal(np.asarray(got), plane)

    def test_full_pipeline_bitexact_with_mxu_relayout(self, rng, monkeypatch):
        """Whole packed graph with the MXU relayout == golden oracle."""
        from gpu_video_codec_jax.models.golden import deblock_frame_golden
        from gpu_video_codec_jax.models.streaming import StreamingDeblocker
        from gpu_video_codec_jax.utils.bs import BoundaryStrength
        from gpu_video_codec_jax.utils.yuv import (
            planes_from_yv12_bytes, yv12_bytes_from_planes,
        )

        self._force(monkeypatch)
        w, h = 64, 48
        raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
        s = StreamingDeblocker(w, h, qp=35, backend="jnp")
        out = next(iter(s.run([raw])))
        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), 35)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


class TestInteriorFused:
    """interior_to_tiles / tiles_to_interior must equal pad+relayout /
    relayout+slice on BOTH engines (they fold Q6 padding and the interior
    write-back into the relayout)."""

    def test_numpy_engine(self, rng):
        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 40, 56, 4
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = plane_to_tiles(np.pad(x, p))
        t = interior_to_tiles(x, p)
        assert np.array_equal(t, ref)
        assert np.array_equal(tiles_to_interior(t, p, h, w), x)

    def test_mxu_engine(self, rng, monkeypatch, mxu_dtype):
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 40, 56, 4
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = plane_to_tiles(np.pad(x, p))
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", mxu_dtype)
        t = interior_to_tiles(jnp.asarray(x), p)
        assert np.array_equal(np.asarray(t), ref)
        back = tiles_to_interior(t, p, h, w)
        assert np.array_equal(np.asarray(back), x)

    def test_mxu_engine_grid_padded(self, rng, monkeypatch, mxu_dtype):
        """Grid pre-padding (no-op tile rows/cols) folds into the relayout
        on both dot dtypes; padding tiles must come out exactly zero."""
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 40, 56, 4
        by, bx = (h + 2 * p) // 8, (w + 2 * p) // 8
        byg, bxg = by + 3, bx + 5
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = np.zeros((8, 8, byg, bxg), np.uint8)
        ref[..., :by, :bx] = plane_to_tiles(np.pad(x, p))
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", mxu_dtype)
        t = interior_to_tiles(jnp.asarray(x), p, by_grid=byg, bx_grid=bxg)
        assert np.array_equal(np.asarray(t), ref)
        assert np.array_equal(np.asarray(tiles_to_interior(t, p, h, w)), x)

    def test_mxu_engine_after_filtering_writeback(self, rng, monkeypatch, mxu_dtype):
        """tiles whose border tiles wrote into the padding still read back
        the correct interior (padding columns are dropped by the inverse)."""
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import tiles_to_interior

        h, w, p = 16, 24, 4
        ext = rng.integers(0, 256, (h + 2 * p, w + 2 * p), dtype=np.uint8)
        t = plane_to_tiles(ext)
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", mxu_dtype)
        got = tiles_to_interior(jnp.asarray(t), p, h, w)
        assert np.array_equal(np.asarray(got), ext[p : p + h, p : p + w])


class TestSplitRelayout:
    """Block-diagonal split engine (large-width policy, forced via
    GVCT_RELAYOUT_SPLIT): must be bit-identical to the full-width perm and
    the transpose engine, incl. grid padding and leading batch dims."""

    @pytest.fixture(autouse=True, params=["u8", "s8"])
    def _force(self, request, monkeypatch):
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")
        monkeypatch.setenv("GVCT_RELAYOUT_SPLIT", "2")
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", request.param)

    def test_roundtrip_matches_transpose(self, rng):
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 40, 56, 4  # wext 64, bxg 8, k=2 -> s=32
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = plane_to_tiles(np.pad(x, p))
        t = interior_to_tiles(jnp.asarray(x), p)
        assert np.array_equal(np.asarray(t), ref)
        assert np.array_equal(np.asarray(tiles_to_interior(t, p, h, w)), x)

    def test_grid_padded_and_batched(self, rng):
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 24, 56, 4
        by, bx = (h + 2 * p) // 8, (w + 2 * p) // 8
        byg, bxg = by + 2, bx + 4  # bxg=12, k=2 -> s=48
        xs = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        ref = np.zeros((3, 8, 8, byg, bxg), np.uint8)
        for i in range(3):
            ref[i, ..., :by, :bx] = plane_to_tiles(np.pad(xs[i], p))
        t = interior_to_tiles(jnp.asarray(xs), p, by_grid=byg, bx_grid=bxg)
        assert np.array_equal(np.asarray(t), ref)
        back = tiles_to_interior(t, p, h, w)
        assert np.array_equal(np.asarray(back), xs)

    def test_full_pipeline_bitexact_with_split(self, rng, monkeypatch):
        """Whole packed pallas graph with the split engine == golden."""
        from gpu_video_codec_jax.models.golden import deblock_frame_golden
        from gpu_video_codec_jax.models.streaming import StreamingDeblocker
        from gpu_video_codec_jax.utils.bs import BoundaryStrength
        from gpu_video_codec_jax.utils.yuv import (
            planes_from_yv12_bytes, yv12_bytes_from_planes,
        )

        w, h = 64, 48
        raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
        s = StreamingDeblocker(w, h, qp=35, backend="pallas")
        out = next(iter(s.run([raw])))
        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), 35)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


class TestFactoredRelayout:
    """Factored (middle-dim identity contraction) engine: the default for
    grid widths >= 4096, forced here via GVCT_RELAYOUT_FACT=1.  Must be
    bit-identical to the transpose engine, incl. grid padding, leading batch
    dims, and the full packed pallas graph vs golden."""

    @pytest.fixture(autouse=True, params=["u8", "s8"])
    def _force(self, request, monkeypatch):
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")
        monkeypatch.setenv("GVCT_RELAYOUT_FACT", "1")
        monkeypatch.setenv("GVCT_RELAYOUT_DTYPE", request.param)

    def test_roundtrip_matches_transpose(self, rng):
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 40, 56, 4
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = plane_to_tiles(np.pad(x, p))
        t = interior_to_tiles(jnp.asarray(x), p)
        assert np.array_equal(np.asarray(t), ref)
        assert np.array_equal(np.asarray(tiles_to_interior(t, p, h, w)), x)

    def test_wide_geometry_auto_policy(self, rng, monkeypatch):
        """At grid width >= 4096 the AUTO policy (no env) picks factored;
        verify it against the transpose engine at a wide, short plane."""
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            _fact_enabled, interior_to_tiles, tiles_to_interior,
        )

        monkeypatch.delenv("GVCT_RELAYOUT_FACT", raising=False)
        assert _fact_enabled(4096) and not _fact_enabled(2048)
        h, w, p = 16, 4088, 4  # wext 4096 -> auto-factored
        x = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = plane_to_tiles(np.pad(x, p))
        t = interior_to_tiles(jnp.asarray(x), p)
        assert np.array_equal(np.asarray(t), ref)
        assert np.array_equal(np.asarray(tiles_to_interior(t, p, h, w)), x)

    def test_grid_padded_and_batched(self, rng):
        import jax.numpy as jnp

        from gpu_video_codec_jax.utils.tiles import (
            interior_to_tiles, tiles_to_interior,
        )

        h, w, p = 24, 56, 4
        by, bx = (h + 2 * p) // 8, (w + 2 * p) // 8
        byg, bxg = by + 2, bx + 4
        xs = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        ref = np.zeros((3, 8, 8, byg, bxg), np.uint8)
        for i in range(3):
            ref[i, ..., :by, :bx] = plane_to_tiles(np.pad(xs[i], p))
        t = interior_to_tiles(jnp.asarray(xs), p, by_grid=byg, bx_grid=bxg)
        assert np.array_equal(np.asarray(t), ref)
        back = tiles_to_interior(t, p, h, w)
        assert np.array_equal(np.asarray(back), xs)

    def test_full_pipeline_bitexact_with_factored(self, rng):
        """Whole packed pallas graph with the factored engine == golden."""
        from gpu_video_codec_jax.models.golden import deblock_frame_golden
        from gpu_video_codec_jax.models.streaming import StreamingDeblocker
        from gpu_video_codec_jax.utils.bs import BoundaryStrength
        from gpu_video_codec_jax.utils.yuv import (
            planes_from_yv12_bytes, yv12_bytes_from_planes,
        )

        w, h = 64, 48
        raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
        s = StreamingDeblocker(w, h, qp=35, backend="pallas")
        out = next(iter(s.run([raw])))
        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), 35)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))

"""Streaming pipeline correctness: distinct frames in flight must come out
filtered, in order, with no cross-frame mixing."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.streaming import StreamingDeblocker
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import (
    FramePlanes,
    extend_plane,
    planes_from_yv12_bytes,
    yv12_bytes_from_planes,
)


def _raw_frame(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_order_and_exactness(rng, depth):
    w, h, qp = 64, 48, 35
    raws = [_raw_frame(rng, w, h) for _ in range(6)]
    s = StreamingDeblocker(w, h, qp, backend="jnp", depth=depth)
    outs = list(s.run(raws))
    assert len(outs) == len(raws)
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, outs):
        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, bs, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_stream_luma_only(rng):
    w, h = 64, 48
    raw = _raw_frame(rng, w, h)
    s = StreamingDeblocker(w, h, 35, backend="jnp", luma_only=True)
    (out,) = list(s.run([raw]))
    # chroma section must be untouched
    assert np.array_equal(out[w * h :], raw[w * h :])
    assert not np.array_equal(out[: w * h], raw[: w * h])


def test_stream_odd_chroma_geometry(rng):
    """1080p-class geometry (chroma extended dims % 8 != 0) through the
    packed device-side path."""
    w, h, qp = 88, 72, 35
    raw = _raw_frame(rng, w, h)
    s = StreamingDeblocker(w, h, qp, backend="jnp")
    (out,) = list(s.run([raw]))
    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), qp)
    assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_stream_rejects_wrong_size(rng):
    s = StreamingDeblocker(64, 48, 35, backend="jnp")
    with pytest.raises(ValueError):
        next(s.run([np.zeros(10, np.uint8)]))


def test_measurement_accepts_bytes(rng):
    """throughput()/time_breakdown() accept bytes like run() does."""
    w, h = 64, 48
    raw = bytes(_raw_frame(rng, w, h))
    s = StreamingDeblocker(w, h, 35, backend="jnp")
    tb = s.time_breakdown(raw, n=2)
    assert tb["kernel_s"] > 0
    tp = s.throughput(raw, n_frames=2, repeats=1)
    assert tp["fps"] > 0


def test_streaming_rejects_bad_dims():
    with pytest.raises(ValueError):
        StreamingDeblocker(100, 50, 35, backend="jnp")


def test_update_boundary_strength_midstream(rng):
    """Swapping BS mid-stream changes behavior without recompiling geometry."""
    w, h, qp = 64, 48, 35
    raw = _raw_frame(rng, w, h)
    s = StreamingDeblocker(w, h, qp, backend="jnp")
    (filtered,) = list(s.run([raw]))
    assert not np.array_equal(filtered, raw)
    # all-zero BS -> no-op
    bs0 = BoundaryStrength.intra_default(w, h)
    bs0.set_luma(np.zeros(bs0.vert.size, np.uint8), np.zeros(bs0.hor.size, np.uint8))
    bs0.set_chroma(np.zeros(bs0.chroma_vert.size, np.uint8),
                   np.zeros(bs0.chroma_hor.size, np.uint8))
    s.update_boundary_strength(bs0)
    (out0,) = list(s.run([raw]))
    assert np.array_equal(out0, raw)
    with pytest.raises(ValueError):
        s.update_boundary_strength(BoundaryStrength.intra_default(32, 32))


def test_run_frames_wrapper(rng):
    """FramePlanes-in/FramePlanes-out convenience path."""
    from gpu_video_codec_jax.utils.yuv import extend_plane

    w, h = 64, 48
    frames = [
        FramePlanes(
            extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
            extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
            extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
            w, h,
        )
        for _ in range(2)
    ]
    s = StreamingDeblocker(w, h, 35, backend="jnp")
    outs = list(s.run_frames(frames))
    bs = BoundaryStrength.intra_default(w, h)
    for f, o in zip(frames, outs):
        gold = deblock_frame_golden(f, bs, 35)
        # interiors must match (padding of `o` is freshly zero by construction)
        from gpu_video_codec_jax.utils.yuv import interior
        for name in ("y", "u", "v"):
            ga = getattr(gold, name)
            oa = getattr(o, name)
            hh, ww = ga.shape[0] - 8, ga.shape[1] - 8
            assert np.array_equal(interior(ga, hh, ww), interior(oa, hh, ww)), name


def test_streaming_luma_only_pallas(rng):
    """Pallas packed path with luma_only: chroma passes through untouched,
    luma equals the golden luma-only filter."""
    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import (
        planes_from_yv12_bytes, yv12_bytes_from_planes,
    )

    w, h = 64, 48
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    s = StreamingDeblocker(w, h, 35, backend="pallas", luma_only=True)
    (out,) = list(s.run([raw]))
    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), 35,
                                luma_only=True)
    assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))
    assert np.array_equal(out[w * h :], raw[w * h :])  # chroma untouched


class TestPlanesContract:
    """step_planes/put_planes: the plane-granularity device contract (the
    analogue of the reference's separate _gpu_Y/U/V buffers,
    gpu.cu:1248-1250) must be bit-identical to the packed YV12 path on
    every backend, geometry class, and luma_only."""

    @pytest.mark.parametrize("backend", ["jnp", "pallas"])
    def test_matches_golden_and_packed(self, rng, backend):
        w, h, qp = 64, 48, 35
        raw = _raw_frame(rng, w, h)
        s = StreamingDeblocker(w, h, qp, backend=backend)
        y, uv = s.step_planes(*s.put_planes(raw))
        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), qp)
        packed = np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
        assert np.array_equal(np.asarray(y).ravel(), packed[: w * h])
        assert np.array_equal(np.asarray(uv).ravel(), packed[w * h :])

    def test_sheared_chroma_geometry(self, rng):
        """w % 16 == 8 (Q9 sheared chroma) through the planes contract."""
        w, h, qp = 88, 72, 35
        raw = _raw_frame(rng, w, h)
        s = StreamingDeblocker(w, h, qp, backend="pallas")
        y, uv = s.step_planes(*s.put_planes(raw))
        (out,) = list(StreamingDeblocker(w, h, qp, backend="jnp").run([raw]))
        assert np.array_equal(np.asarray(y).ravel(), out[: w * h])
        assert np.array_equal(np.asarray(uv).ravel(), out[w * h :])

    def test_luma_only_passthrough(self, rng):
        w, h = 64, 48
        raw = _raw_frame(rng, w, h)
        s = StreamingDeblocker(w, h, 35, backend="pallas", luma_only=True)
        yd, uvd = s.put_planes(raw)
        y, uv = s.step_planes(yd, uvd)
        assert np.array_equal(np.asarray(uv).ravel(), raw[w * h :])
        assert not np.array_equal(np.asarray(y).ravel(), raw[: w * h])

    def test_chained_steps_match_packed_chain(self, rng):
        """Chaining step_planes outputs == chaining packed _step outputs."""
        import jax

        w, h, qp = 64, 48, 35
        raw = _raw_frame(rng, w, h)
        s = StreamingDeblocker(w, h, qp, backend="pallas")
        y, uv = s.put_planes(raw)
        for _ in range(3):
            y, uv = s.step_planes(y, uv)
        buf = s._put(raw)
        for _ in range(3):
            buf = s._step(buf)
        ref = np.asarray(jax.device_get(buf)).ravel()
        assert np.array_equal(np.asarray(y).ravel(), ref[: w * h])
        assert np.array_equal(np.asarray(uv).ravel(), ref[w * h :])


class TestPackedChromaFold:
    """GVCT_PACKED_CHROMA=fold: the packed step's chroma boundary runs
    through the fold relayout dots (utils/tiles.py) instead of the
    (h/2, w) <-> (2, ch, cw) retile copies.  Must be byte-identical to the
    default engine AND the golden oracle; sheared geometries must fall back
    to the retile path."""

    def _sd(self, monkeypatch, w, h, engine):
        monkeypatch.setenv("GVCT_PACKED_CHROMA", engine)
        monkeypatch.setenv("GVCT_RELAYOUT", "mxu")  # the fold rides the mxu engine
        return StreamingDeblocker(w, h, 35, backend="pallas")

    @pytest.mark.parametrize("geom", [(64, 48), (96, 72)])
    def test_fold_bit_identical(self, rng, monkeypatch, geom):
        import jax

        w, h = geom
        raw = _raw_frame(rng, w, h)
        s_fold = self._sd(monkeypatch, w, h, "fold")
        assert s_fold._chroma_fold
        out_fold = np.asarray(jax.device_get(s_fold._step(s_fold._put(raw))))
        s_base = self._sd(monkeypatch, w, h, "retile")
        assert not s_base._chroma_fold
        out_base = np.asarray(jax.device_get(s_base._step(s_base._put(raw))))
        assert np.array_equal(out_fold, out_base)
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(raw, w, h),
            BoundaryStrength.intra_default(w, h), 35)
        assert out_fold.ravel().tobytes() == yv12_bytes_from_planes(gold)

    def test_sheared_geometry_falls_back(self, rng, monkeypatch):
        # w % 16 == 8: extended chroma width not 8-aligned (Q9 sheared) --
        # the knob must quietly keep the retile path and stay exact
        import jax

        w, h = 56, 72
        s = self._sd(monkeypatch, w, h, "fold")
        assert not s._chroma_fold
        raw = _raw_frame(rng, w, h)
        out = np.asarray(jax.device_get(s._step(s._put(raw))))
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(raw, w, h),
            BoundaryStrength.intra_default(w, h), 35)
        assert out.ravel().tobytes() == yv12_bytes_from_planes(gold)

    def test_fold_chain_matches(self, rng, monkeypatch):
        import jax

        w, h = 64, 48
        raw = _raw_frame(rng, w, h)
        s_fold = self._sd(monkeypatch, w, h, "fold")
        out_n = np.asarray(jax.device_get(s_fold._chain(s_fold._put(raw), 2)))
        s_base = self._sd(monkeypatch, w, h, "retile")
        ref = np.asarray(jax.device_get(s_base._chain(s_base._put(raw), 2)))
        assert np.array_equal(out_n, ref)

    def test_fold_with_injected_bs(self, rng, monkeypatch):
        # randomized (non-default) BS must flow through the fold engine's
        # chroma maps exactly as through the retile engine's -- the layout
        # engines are BS-independent by construction; this pins it
        import jax

        w, h = 64, 48
        raw = _raw_frame(rng, w, h)
        bs = BoundaryStrength.intra_default(w, h)
        bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                    rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
        bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                      rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
        outs = []
        for engine in ("fold", "retile"):
            s = self._sd(monkeypatch, w, h, engine)
            assert s._chroma_fold == (engine == "fold")
            s.update_boundary_strength(bs)
            outs.append(np.asarray(jax.device_get(s._step(s._put(raw)))))
        assert np.array_equal(outs[0], outs[1])
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(raw, w, h), bs, 35)
        assert outs[0].ravel().tobytes() == yv12_bytes_from_planes(gold)

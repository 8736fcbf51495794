"""Multi-stream mesh deblocking (config 5) on the 8-device virtual mesh."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.parallel import MultiStreamDeblocker, make_mesh
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def test_multistream_matches_golden(rng):
    w, h, qp = 64, 48, 35
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 4, w, h, qp)
    streams = [[_raw(rng, w, h) for _ in range(3)] for _ in range(4)]
    bs = BoundaryStrength.intra_default(w, h)
    steps = list(ms.run(streams))
    assert len(steps) == 3 and all(len(s) == 4 for s in steps)
    for t, outs in enumerate(steps):
        for i, out in enumerate(outs):
            frame = planes_from_yv12_bytes(streams[i][t].tobytes(), w, h)
            gold = deblock_frame_golden(frame, bs, qp)
            assert np.array_equal(
                out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
            ), (t, i)


def test_multistream_overlap_depth(rng):
    """depth > 1 keeps several sharded batches in flight; outputs must still
    come back in batch order, bit-exact, incl. the drain tail when the
    stream ends with batches still queued."""
    w, h, qp = 64, 48, 35
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 2, w, h, qp, depth=3)
    n_steps = 5  # > depth, so both the steady state and the tail drain run
    streams = [[_raw(rng, w, h) for _ in range(n_steps)] for _ in range(2)]
    bs = BoundaryStrength.intra_default(w, h)
    steps = list(ms.run(streams))
    assert len(steps) == n_steps
    for t, outs in enumerate(steps):
        for i, out in enumerate(outs):
            gold = deblock_frame_golden(
                planes_from_yv12_bytes(streams[i][t].tobytes(), w, h), bs, qp)
            assert np.array_equal(
                out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
            ), (t, i)


def test_multistream_validation(rng):
    mesh = make_mesh(2, 4)
    with pytest.raises(ValueError):
        MultiStreamDeblocker(mesh, 3, 64, 48, 35)  # 3 % data-axis(2) != 0
    ms = MultiStreamDeblocker(mesh, 2, 64, 48, 35)
    with pytest.raises(ValueError):
        ms.step([_raw(rng, 64, 48)])  # wrong stream count
    with pytest.raises(ValueError):
        ms.step([np.zeros(5, np.uint8)] * 2)  # wrong frame size


def test_multistream_update_boundary_strength(rng):
    """Mid-stream BS swap (SetBoundaryStrenght parity, cpu.h:120-132) on the
    packed sharded path: steps after the swap must match the golden oracle
    under the NEW maps, with no recompile of the sharded graph."""
    w, h, qp = 64, 48, 35
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 2, w, h, qp)
    # smooth-ish frames so cond1 passes and the vertical edges really filter
    # (pure-noise frames rarely clear the local-adaptivity gate, which would
    # make the with/without-BS outputs trivially identical)
    raws = [(np.arange(3 * w * h // 2, dtype=np.int64) // w % 256
             + rng.integers(-3, 4, 3 * w * h // 2)).astype(np.uint8)
            for _ in range(2)]
    default_bs = BoundaryStrength.intra_default(w, h)
    out_default = ms.step(raws)

    custom = BoundaryStrength.intra_default(w, h)
    custom.vert[:] = 0  # kill all vertical luma edges
    ms.update_boundary_strength(custom)
    out_custom = ms.step(raws)
    assert not np.array_equal(out_default[0], out_custom[0])
    for raw, out in zip(raws, out_custom):
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(raw.tobytes(), w, h), custom, qp)
        assert np.array_equal(out, np.frombuffer(
            yv12_bytes_from_planes(gold), np.uint8))
    with pytest.raises(ValueError):
        ms.update_boundary_strength(BoundaryStrength.intra_default(w, h * 2))
    # geometry-matched default still reproduces the original outputs
    ms.update_boundary_strength(default_bs)
    assert all(np.array_equal(a, b)
               for a, b in zip(ms.step(raws), out_default))


def test_multistream_frames_fast_path(rng):
    """Frames-parallel fast path (pallas backend, non-sheared geometry,
    n_streams divisible by the device count): whole frames shard over the
    flattened 8-device grid and each device runs the fused-relayout
    single-chip packed formulation (mesh._deblock_packed_frames_local).
    Must be bit-exact vs the golden oracle on every frame."""
    w, h, qp = 64, 48, 35  # cw+16 = 48, 8-aligned -> non-sheared Q9
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 8, w, h, qp, backend="pallas")
    assert ms._frames_fast, "fast-path gate should engage for this config"
    raws = [_raw(rng, w, h) for _ in range(8)]
    outs = ms.step(raws)
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, outs):
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h), bs, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_multistream_fast_path_local_batch(rng):
    """Fast path with a LOCAL batch > 1 (more streams than devices: 1x1
    mesh, 4 streams -- the measured bench_multistream_1chip shape): the
    batched relayout dots / kernel leading-batch axis / in-place repack
    must stay bit-exact, including a mid-stream BS swap (maps are step
    arguments, no recompile)."""
    w, h, qp = 64, 48, 35
    mesh = make_mesh(1, 1)
    ms = MultiStreamDeblocker(mesh, 4, w, h, qp, backend="pallas")
    assert ms._frames_fast
    raws = [(np.arange(3 * w * h // 2, dtype=np.int64) // w % 256
             + rng.integers(-3, 4, 3 * w * h // 2)).astype(np.uint8)
            for _ in range(4)]
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, ms.step(raws)):
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h), bs, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))
    custom = BoundaryStrength.intra_default(w, h)
    custom.vert[:] = 0
    ms.update_boundary_strength(custom)
    for raw, out in zip(raws, ms.step(raws)):
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h), custom, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_multistream_fast_path_luma_only(rng):
    """luma_only engages the fast path with no chroma perms: luma filters
    bit-exact, chroma bytes pass through untouched."""
    w, h, qp = 64, 48, 35
    mesh = make_mesh(1, 1)
    ms = MultiStreamDeblocker(mesh, 2, w, h, qp, backend="pallas",
                              luma_only=True)
    assert ms._frames_fast
    raws = [_raw(rng, w, h) for _ in range(2)]
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, ms.step(raws)):
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(raw.tobytes(), w, h), bs, qp,
            luma_only=True)
        assert np.array_equal(out, np.frombuffer(
            yv12_bytes_from_planes(gold), np.uint8))
        assert np.array_equal(out[w * h:], raw[w * h:])  # chroma untouched


def test_multistream_pallas_sheared_falls_back(rng):
    """Sheared Q9 geometry (56x72: ext chroma width 44 not 8-aligned) must
    NOT take the fused fast path, and the fallback must stay bit-exact
    under the pallas backend."""
    w, h, qp = 56, 72, 35
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 8, w, h, qp, backend="pallas")
    assert not ms._frames_fast
    raws = [_raw(rng, w, h) for _ in range(8)]
    outs = ms.step(raws)
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, outs):
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h), bs, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_multistream_q9_geometry(rng):
    w, h, qp = 56, 72, 35
    mesh = make_mesh(2, 4)
    ms = MultiStreamDeblocker(mesh, 2, w, h, qp)
    raws = [_raw(rng, w, h) for _ in range(2)]
    outs = ms.step(raws)
    bs = BoundaryStrength.intra_default(w, h)
    for raw, out in zip(raws, outs):
        gold = deblock_frame_golden(planes_from_yv12_bytes(raw.tobytes(), w, h), bs, qp)
        assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))

"""Device-resident (layout-persistent) streaming: bit-exactness of the
ingest -> step -> readback path vs the standard pipeline, including chained
steps (tiles never leaving the canonical layout) and Q9 geometries."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.resident import ResidentDeblocker
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import (
    planes_from_yv12_bytes, yv12_bytes_from_planes,
)


def _raw(rng, w, h):
    return rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)


def _golden_packed(raw, w, h, qp, bs=None):
    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    bs = bs or BoundaryStrength.intra_default(w, h)
    out = deblock_frame_golden(frame, bs, qp)
    return np.frombuffer(yv12_bytes_from_planes(out), np.uint8)


# default suite: one regular + one Q9-sheared geometry; the rest are -m slow
# (each distinct geometry costs a full interpret-mode Pallas compile on CPU)
@pytest.mark.parametrize("w,h", [
    (64, 48), (40, 24),
    pytest.param(352, 288, marks=pytest.mark.slow),
    pytest.param(56, 72, marks=pytest.mark.slow),
])
def test_resident_matches_golden(rng, w, h):
    """One-shot resident path == golden oracle, incl. w % 16 == 8 geometries
    (40, 56) where the chroma sweep shears the flat view (quirk Q9)."""
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, qp=35)
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, 35))


def test_resident_chained_steps(rng):
    """N chained kernel-only steps on resident state == N golden passes over
    the EXTENDED planes.  (Not N full YV12 round trips: re-ingesting re-zeroes
    the extended padding (Q6), whereas resident state legitimately keeps the
    padding pixels that border tiles wrote -- the defined semantics for
    device-resident chaining, where only real frame boundaries re-enter
    through ingest.)"""
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, qp)
    bs = BoundaryStrength.intra_default(w, h)

    state = rd.ingest(raw)
    for _ in range(3):
        state = rd.step(state)
    resident_out = rd.readback(state)

    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    for _ in range(3):
        frame = deblock_frame_golden(frame, bs, qp)
    ref = np.frombuffer(yv12_bytes_from_planes(frame), np.uint8)
    assert np.array_equal(resident_out, ref)


def test_resident_run_steps_matches_step_loop(rng):
    """run_steps(tf, n) (n chained steps in ONE dispatch, the device-time
    measurement primitive) is bit-identical to n individual step() calls."""
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, qp)

    state = rd.ingest(raw)
    chained = rd.run_steps(state, 3)

    looped = state
    for _ in range(3):
        looped = rd.step(looped)
    assert np.array_equal(rd.readback(chained), rd.readback(looped))


def test_streaming_packed_chain_matches_step_loop(rng):
    """_deblock_yv12_packed_n (the packed graph's one-dispatch n-step chain)
    == n individual packed steps."""
    import jax

    from gpu_video_codec_jax.models.streaming import (
        StreamingDeblocker, _deblock_yv12_packed_n,
    )

    w, h = 64, 48
    raw = _raw(rng, w, h)
    s = StreamingDeblocker(w, h, qp=35, backend="jnp")
    dev = s._put(raw)

    chained = _deblock_yv12_packed_n(
        dev, s._lm, s._cm, s._beta, s._tc, n=3, w=w, h=h,
        luma_only=False, backend="jnp",
    )

    looped = dev
    for _ in range(3):
        looped = s._step(looped)
    assert np.array_equal(jax.device_get(chained), jax.device_get(looped))


def test_resident_luma_only(rng):
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, qp, luma_only=True)
    out = rd(raw)
    frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
    gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h),
                                qp, luma_only=True)
    assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))


def test_resident_injected_bs(rng):
    """Custom BS arrays flow through the padded segment maps unchanged."""
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                  rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))
    rd = ResidentDeblocker(w, h, qp, bs=bs)
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, qp, bs=bs))


def test_resident_ingest_device_buffer(rng):
    """ingest() accepts an already-device-resident packed buffer."""
    import jax

    w, h = 64, 48
    raw = _raw(rng, w, h)
    rd = ResidentDeblocker(w, h, qp=35)
    dev = jax.device_put(raw)
    assert np.array_equal(rd.readback(rd.step(rd.ingest(dev))), rd(raw))


def test_resident_rejects_bad_size(rng):
    rd = ResidentDeblocker(64, 48, qp=35)
    with pytest.raises(ValueError):
        rd.ingest(np.zeros(10, np.uint8))


@pytest.mark.parametrize("w,h", [
    (64, 48),
    pytest.param(56, 72, marks=pytest.mark.slow),  # Q9-sheared chroma
])
def test_resident_batched_frames(rng, w, h):
    """A frame batch runs through the kernels as one launch (batch = the
    outermost grid dimension, one shared BS map) and must equal per-frame
    processing bit-for-bit, incl. sheared Q9 geometries."""
    raws = [_raw(rng, w, h) for _ in range(3)]
    rd = ResidentDeblocker(w, h, qp=35)
    out = rd(raws)
    assert out.shape == (3, 3 * w * h // 2)
    for i, raw in enumerate(raws):
        assert np.array_equal(out[i], _golden_packed(raw, w, h, 35)), i


def test_resident_batched_array_input(rng):
    """(n, 3wh/2) ndarray input batches identically to a list of frames."""
    w, h = 64, 48
    raws = np.stack([_raw(rng, w, h) for _ in range(2)])
    rd = ResidentDeblocker(w, h, qp=35)
    assert np.array_equal(rd(raws), rd(list(raws)))


def test_resident_batched_chained_steps(rng):
    """Chained steps on a batched TileFrame == chained steps per frame."""
    w, h = 64, 48
    raws = [_raw(rng, w, h) for _ in range(2)]
    rd = ResidentDeblocker(w, h, qp=35)
    st = rd.ingest(raws)
    for _ in range(2):
        st = rd.step(st)
    batched = rd.readback(st)
    for i, raw in enumerate(raws):
        s = rd.ingest(raw)
        for _ in range(2):
            s = rd.step(s)
        assert np.array_equal(batched[i], rd.readback(s)), i


def test_resident_update_boundary_strength(rng):
    """update_boundary_strength swaps BS without recompiling and matches a
    fresh instance built with the same BS (SetBoundaryStrenght parity)."""
    w, h, qp = 64, 48, 35
    raw = _raw(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    rd = ResidentDeblocker(w, h, qp)           # default BS first
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, qp))
    rd.update_boundary_strength(bs)
    assert np.array_equal(rd(raw), _golden_packed(raw, w, h, qp, bs=bs))


@pytest.mark.slow
def test_resident_batched_fuzz_geometries(rng):
    """Fuzz: batched resident == per-frame golden across random geometries
    (both sheared and non-sheared chroma paths), QPs spanning the no-op band
    and the clamp."""
    for case in range(6):
        w = 8 * int(rng.integers(2, 30))
        h = 8 * int(rng.integers(2, 20))
        qp = int(rng.integers(0, 56))
        raws = [_raw(rng, w, h) for _ in range(3)]
        rd = ResidentDeblocker(w, h, qp)
        out = rd(raws)
        for i, raw in enumerate(raws):
            assert np.array_equal(out[i], _golden_packed(raw, w, h, qp)), (
                case, w, h, qp, i)


def test_resident_host_buf_planar_single_frame(rng):
    """A single frame passed as a 2-D planar (3h/2, w) buffer must be accepted
    (ADVICE r2: ndim>1 with total size == frame_bytes is a frame, not a
    batch)."""
    w, h = 64, 48
    rd = ResidentDeblocker(w, h, 35)
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    planar = raw.reshape(3 * h // 2, w)
    out_flat = rd(raw)
    out_planar = rd(planar)
    assert np.array_equal(out_flat, out_planar)
    # 3-D batch (n, 3h/2, w) also normalizes
    batch3d = np.stack([planar, planar])
    out_b = rd(batch3d)
    assert out_b.shape == (2, 3 * w * h // 2)
    assert np.array_equal(out_b[0], out_flat)


def test_resident_host_buf_batch_of_one(rng):
    """A 3-D batch of exactly one frame (1, 3h/2, w) must KEEP its batch axis
    (ADVICE r3: the old size==frame_bytes check ran first and flattened it,
    which made MeshResidentDeblocker reject a legitimate batch-of-one)."""
    w, h = 64, 48
    rd = ResidentDeblocker(w, h, 35)
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    one = raw.reshape(1, 3 * h // 2, w)
    buf = rd.host_buf(one)
    assert buf.shape == (1, 3 * w * h // 2)
    out = rd(one)
    assert out.shape == (1, 3 * w * h // 2)
    assert np.array_equal(out[0], rd(raw))


def test_resident_host_buf_rejects_scrambled_shapes(rng):
    """Multi-dim buffers whose size merely divides by frame_bytes but whose
    structure is not a frame batch (e.g. transposed (frame_bytes, n)) must
    raise, not be silently reinterpreted as scrambled frames (ADVICE r3)."""
    w, h = 64, 48
    fb = 3 * w * h // 2
    rd = ResidentDeblocker(w, h, 35)
    transposed = rng.integers(0, 256, (fb, 2), dtype=np.uint8)
    with pytest.raises(ValueError, match="batch"):
        rd.host_buf(transposed)
    # a leading batch axis with ANY trailing layout that multiplies to
    # frame_bytes is a batch (symmetric with the single-frame any-layout rule)
    odd = rng.integers(0, 256, (2, fb // 2, 2), dtype=np.uint8)
    assert rd.host_buf(odd).shape == (2, fb)
    # and a legitimate (n*3h/2, w) row stack is recognized
    stack = rng.integers(0, 256, (2 * 3 * h // 2, w), dtype=np.uint8)
    assert rd.host_buf(stack).shape == (2, fb)


def test_resident_operands_contract(rng):
    """StepOperands round-trip: operands -> install_operands keeps the
    pipeline bit-identical (the contract parallel/resident_mesh.py relies
    on), and block_shapes/luma_only expose the static step args."""
    w, h = 64, 48
    rd = ResidentDeblocker(w, h, 35)
    raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
    ref = rd(raw)
    import jax

    ops = rd.operands
    rd.install_operands(jax.tree.map(jax.device_put, ops))
    assert np.array_equal(rd(raw), ref)
    (lb, cb) = rd.block_shapes
    assert len(lb) == 2 and len(cb) == 2
    assert rd.luma_only is False

"""Reference-API migration shim (compat.ReadYuvFrame) end-to-end."""

import os

import numpy as np
import pytest

from gpu_video_codec_jax.compat import ReadYuvFrame
from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import read_yv12, yv12_bytes_from_planes


def test_reference_flow(tmp_path, testdata_dir):
    """The reference main()'s CPU flow, ported line for line
    (main.cu:128-133: mother-daughter CIF, Qp 35, filter, save)."""
    inp = os.path.join(testdata_dir, "mother-daughter_352x288_yv12.yuv")
    out = str(tmp_path / "out.yuv")

    frame = ReadYuvFrame(inp, 352, 288, Qp=35, backend="jnp")
    frame.DeblockingFilter(8)
    frame.Save(out)

    gold = deblock_frame_golden(
        read_yv12(inp, 352, 288), BoundaryStrength.intra_default(352, 288), 35
    )
    with open(out, "rb") as f:
        assert f.read() == yv12_bytes_from_planes(gold)


def test_set_boundary_strenght_both_forms(testdata_dir, rng):
    inp = os.path.join(testdata_dir, "image1_352x288_yv12.yuv")
    frame = ReadYuvFrame(inp, 352, 288, Qp=35, backend="jnp")
    nv, nh = frame._bs.vert.size, frame._bs.hor.size
    v = rng.integers(0, 3, nv, dtype=np.uint8)
    h = rng.integers(0, 3, nh, dtype=np.uint8)
    # C-style 4-arg form
    frame.SetBoundaryStrenght(v, nv, h, nh)
    assert np.array_equal(frame._bs.vert, v)
    # Python 2-arg form
    v2 = np.roll(v, 1)
    frame.SetBoundaryStrenght(v2, h)
    assert np.array_equal(frame._bs.vert, v2)
    # size mismatch raises, like the reference throw (cpu.h:122-123)
    with pytest.raises(ValueError):
        frame.SetBoundaryStrenght(v[:5], np.zeros(nh, np.uint8))


def test_ctor_validation(tmp_path):
    bad = tmp_path / "bad.yuv"
    bad.write_bytes(b"\0" * 100)
    with pytest.raises(ValueError):
        ReadYuvFrame(str(bad), 352, 288)


def test_execute_cpu_parity(tmp_path, testdata_dir):
    from gpu_video_codec_jax.compat import ExecuteCpu
    from gpu_video_codec_jax.runtime import native

    if not native.available():
        pytest.skip("no native toolchain")
    inp = os.path.join(testdata_dir, "mother-daughter_352x288_yv12.yuv")
    out = str(tmp_path / "out.yuv")
    timings = ExecuteCpu(inp, out, 352, 288, 35, thread_counts=(1, 2))
    assert set(timings) == {1, 2} and all(t > 0 for t in timings.values())
    gold = deblock_frame_golden(
        read_yv12(inp, 352, 288), BoundaryStrength.intra_default(352, 288), 35
    )
    with open(out, "rb") as f:
        assert f.read() == yv12_bytes_from_planes(gold)


def test_execute_gpu_parity(tmp_path, testdata_dir):
    from gpu_video_codec_jax.compat import ExecuteGpu

    inp = os.path.join(testdata_dir, "image1_352x288_yv12.yuv")
    out = str(tmp_path / "out.yuv")
    t = ExecuteGpu(inp, out, 352, 288, 35)
    # total_s is a measured synchronous put->filter->get wall loop (not a sum
    # of the separately-timed parts); all three brackets must be real positive
    # measurements.  No ordering assertion: on CPU the single-reps sync loop
    # and the best-of kernel loop see different scheduler noise.
    assert t["kernel_s"] > 0 and t["h2d_s"] > 0 and t["total_s"] > 0
    gold = deblock_frame_golden(
        read_yv12(inp, 352, 288), BoundaryStrength.intra_default(352, 288), 35
    )
    with open(out, "rb") as f:
        assert f.read() == yv12_bytes_from_planes(gold)


def test_get_gpu_device_info():
    from gpu_video_codec_jax.compat import GetGpuDeviceInfo

    info = GetGpuDeviceInfo()
    assert info["num_devices"] >= 1 and info["devices"]

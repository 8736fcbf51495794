"""Native C++ runtime vs the golden oracle (skipped when no toolchain)."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.runtime import native
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.tiles import plane_to_tiles
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane

pytestmark = pytest.mark.skipif(not native.available(), reason="no native toolchain")


def _frame(rng, w, h):
    return FramePlanes(
        extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)),
        w, h,
    )


@pytest.mark.parametrize("qp", [17, 35, 51])
def test_native_matches_golden(rng, qp):
    w, h = 64, 48
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(
        rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.hor.size, dtype=np.uint8),
    )
    gold = deblock_frame_golden(frame, bs, qp)
    out = native.deblock_frame_native(frame, bs, qp)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(gold, name), getattr(out, name)), name


def test_native_multithreaded_deterministic(rng):
    """OpenMP over tile columns must be race-free (tile independence)."""
    w, h = 96, 64
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    ref = native.deblock_frame_native(frame, bs, 35, num_threads=1)
    for threads in (2, 4, 8):
        out = native.deblock_frame_native(frame, bs, 35, num_threads=threads)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(ref, name), getattr(out, name)), (threads, name)


def test_native_odd_chroma(rng):
    """Chroma extended dims not divisible by 8 (1080p-class geometry)."""
    w, h = 88, 72
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(frame, bs, 35)
    out = native.deblock_frame_native(frame, bs, 35)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(gold, name), getattr(out, name)), name


def test_native_pack_unpack_roundtrip(rng):
    plane = rng.integers(0, 256, (40, 64), dtype=np.uint8)
    packed = native.pack_tiles_native(plane)
    assert np.array_equal(packed, np.asarray(plane_to_tiles(plane)))
    back = native.unpack_tiles_native(packed, 40, 64)
    assert np.array_equal(back, plane)


def test_native_luma_only(rng):
    w, h = 64, 48
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    out = native.deblock_frame_native(frame, bs, 35, luma_only=True)
    assert np.array_equal(out.u, frame.u) and np.array_equal(out.v, frame.v)
    gold = deblock_frame_golden(frame, bs, 35, luma_only=True)
    assert np.array_equal(out.y, gold.y)


def test_native_error_code(rng):
    """The C ABI returns nonzero for invalid geometry; the binding raises."""
    import pytest as _pytest

    frame = _frame(rng, 64, 48)
    bs = BoundaryStrength.intra_default(64, 48)
    bad = FramePlanes(frame.y, frame.u, frame.v, 50, 50)  # not %8
    with _pytest.raises(native.NativeRuntimeError):
        native.deblock_frame_native(bad, bs, 35)


def test_native_active_isa_reports_and_overrides(monkeypatch):
    """active_isa() names a valid tier; GVCT_NATIVE_ISA=sse forces SSE4.1
    (re-read per call, so one process can exercise both)."""
    isa = native.active_isa()
    assert isa in ("scalar", "sse4.1", "avx512")
    monkeypatch.setenv("GVCT_NATIVE_ISA", "sse")
    assert native.active_isa() in ("scalar", "sse4.1")


@pytest.mark.parametrize("w,h", [(8, 8), (16, 16), (24, 16), (64, 48),
                                 (88, 72), (104, 56), (112, 64), (352, 288)])
def test_native_cross_isa_bitexact(rng, monkeypatch, w, h):
    """The AVX-512 batched sweep (4 tiles/vector, deblock_cpu_avx512.cpp) must
    be byte-identical to the SSE4.1 per-tile path AND the golden oracle.

    Geometries cover every quad-tail residue (nx % 4 in 0..3, where
    nx = w/8 + 1), the nx < 4 small-plane fallback (w=8,16), the
    exactly-one-quad case (w=24), and the Q9 sheared-chroma case (w=88 ->
    chroma ext width 52, effective sweep width 48).  Skips silently
    degenerate on hosts without AVX-512: both runs then take the same tier
    and the test still validates against golden."""
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(
        rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.hor.size, dtype=np.uint8),
    )
    for qp in (0, 35, 51):
        gold = deblock_frame_golden(frame, bs, qp)
        monkeypatch.delenv("GVCT_NATIVE_ISA", raising=False)
        fast = native.deblock_frame_native(frame, bs, qp)
        monkeypatch.setenv("GVCT_NATIVE_ISA", "sse")
        base = native.deblock_frame_native(frame, bs, qp)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(gold, name), getattr(fast, name)), (qp, name)
            assert np.array_equal(getattr(base, name), getattr(fast, name)), (qp, name)


@pytest.mark.slow
def test_native_cross_isa_fullscale_1080p(rng, monkeypatch):
    """Production-scale (1920x1080) native validation: the AVX-512 quad sweep
    must match the SSE4.1 tier AND the golden oracle byte-for-byte at the Q9
    row-truncation geometry (chroma ext 548x968 -> effective 544x960) with
    hundreds of full quads per row -- the scale the small cross-ISA cases
    can't reach."""
    w, h = 1920, 1080
    frame = _frame(rng, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    bs.set_luma(
        rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
        rng.integers(0, 3, bs.hor.size, dtype=np.uint8),
    )
    monkeypatch.delenv("GVCT_NATIVE_ISA", raising=False)
    fast = native.deblock_frame_native(frame, bs, 35)
    monkeypatch.setenv("GVCT_NATIVE_ISA", "sse")
    base = native.deblock_frame_native(frame, bs, 35)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(base, name), getattr(fast, name)), name
    gold = deblock_frame_golden(frame, bs, 35)
    for name in ("y", "u", "v"):
        assert np.array_equal(getattr(gold, name), getattr(fast, name)), name


def test_native_dispatch_never_exceeds_compiled_capability():
    """Round-4 advisor finding: if the AVX-512 TU were ever built without
    its macros it becomes a no-op stub, and cpuid alone would still route
    whole tile rows through it (frames silently unfiltered).  select_isa
    now ANDs in the TU's compiled-capability flag."""
    if native.active_isa() == "avx512":
        assert native.avx512_compiled()


@pytest.mark.slow
def test_native_stub_build_never_dispatches_avx512(tmp_path):
    """Build the library WITHOUT AVX-512 flags (so the TU compiles its stub)
    and verify dispatch falls back to SSE4.1 on this AVX-512-capable host
    instead of routing frames into the no-op."""
    import ctypes
    import os
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "gpu_video_codec_jax", "runtime", "src")
    so = tmp_path / "libgvct_stub.so"
    subprocess.run(
        ["g++", "-O0", "-fPIC", "-fopenmp", "-std=c++17", "-msse4.1",
         "-shared", "-o", str(so),
         os.path.join(src, "deblock_cpu.cpp"),
         os.path.join(src, "deblock_cpu_avx512.cpp")],
        check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.gvct_avx512_compiled.restype = ctypes.c_int
    lib.gvct_active_isa.restype = ctypes.c_int
    assert lib.gvct_avx512_compiled() == 0
    assert lib.gvct_active_isa() != 2  # never exceeds compiled capability

"""Cross-backend fuzz: random geometries x QPs x BS patterns; golden, jnp,
pallas (interpreter) and native (if available) must agree byte-for-byte."""

import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.runtime import native
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane

GEOMETRIES = [(16, 16), (24, 40), (48, 64), (88, 72), (8, 64), (64, 8)]


# one case stays in the default suite as a canary; the full campaign (plus
# the much larger tools/validate_vs_reference.py --fuzz sweeps) is -m slow
@pytest.mark.parametrize(
    "case",
    [0] + [pytest.param(c, marks=pytest.mark.slow) for c in range(1, 8)],
)
def test_fuzz_cross_backend(case):
    rng = np.random.default_rng(1000 + case)
    w, h = GEOMETRIES[case % len(GEOMETRIES)]
    qp = int(rng.integers(0, 55))
    smooth = bool(rng.integers(0, 2))
    if smooth:
        base = rng.integers(40, 200)
        mk = lambda hh, ww: np.clip(
            base + rng.integers(-6, 7, (hh, ww)).cumsum(axis=1) % 17, 0, 255
        ).astype(np.uint8)
    else:
        mk = lambda hh, ww: rng.integers(0, 256, (hh, ww), dtype=np.uint8)
    frame = FramePlanes(
        extend_plane(mk(h, w)), extend_plane(mk(h // 2, w // 2)),
        extend_plane(mk(h // 2, w // 2)), w, h,
    )
    bs = BoundaryStrength.intra_default(w, h)
    if rng.integers(0, 2):
        bs.set_luma(rng.integers(0, 3, bs.vert.size, dtype=np.uint8),
                    rng.integers(0, 3, bs.hor.size, dtype=np.uint8))
    if rng.integers(0, 2) and bs.chroma_vert.size:
        bs.set_chroma(rng.integers(0, 3, bs.chroma_vert.size, dtype=np.uint8),
                      rng.integers(0, 3, bs.chroma_hor.size, dtype=np.uint8))

    gold = deblock_frame_golden(frame, bs, qp)
    backends = ["jnp", "pallas"] + (["native"] if native.available() else [])
    for backend in backends:
        out = DeblockPipeline(w, h, qp, backend=backend, bs=bs)(frame)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(gold, name), getattr(out, name)), (
                f"case={case} backend={backend} plane={name} qp={qp} {w}x{h}"
            )

"""Geometries whose chroma extended planes are not 8-multiples (e.g. 1080p-like).

The reference's truncating tile counts (cpu.h:450-451) leave a pure-padding
remainder outside the sweep; all paths must reproduce that and stay bit-exact.
Uses a scaled-down stand-in (88x72 -> chroma 44x36 -> extended 52x44, both
% 8 == 4) so the golden oracle stays fast.
"""

import numpy as np

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


def test_odd_chroma_extent_bitexact(rng):
    w, h = 88, 72
    frame = _frame(rng, w, h)
    assert frame.u.shape == (44, 52)  # neither ext dim a multiple of 8
    bs = BoundaryStrength.intra_default(w, h)
    gold = deblock_frame_golden(frame, bs, 35)
    for backend in ("jnp", "pallas"):
        out = DeblockPipeline(w, h, 35, backend=backend)(frame)
        for name in ("y", "u", "v"):
            assert np.array_equal(getattr(gold, name), getattr(out, name)), (backend, name)
    # quirk Q9: the reference sweeps the flat chroma buffer as an
    # (8*ncby, 8*ncbx) = (40, 48) image; the flat remainder -- which here
    # includes some real bottom chroma rows -- is untouched, exactly as the
    # reference leaves it (verified against the compiled reference binary by
    # tools/validate_vs_reference.py --fuzz)
    vh, vw = 40, 48
    assert np.array_equal(gold.u.ravel()[vh * vw :], frame.u.ravel()[vh * vw :])
    # and the sweep did change pixels inside the view
    assert not np.array_equal(gold.u.ravel()[: vh * vw], frame.u.ravel()[: vh * vw])

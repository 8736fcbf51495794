"""Host-fed streaming: packed YV12 buffers in, filtered buffers out, with
H2D copy overlapped under the kernels (`depth` frames in flight).

    JAX_PLATFORMS=cpu python examples/streaming.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.models.streaming import StreamingDeblocker
from gpu_video_codec_jax.utils.yuv import (
    planes_from_yv12_bytes, yv12_bytes_from_planes,
)

w, h, qp, n = 352, 288, 35, 4
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8) for _ in range(n)]

s = StreamingDeblocker(w, h, qp, backend="pallas", depth=2)
outs = list(s.run(frames))

gold = DeblockPipeline(w, h, qp, backend="golden")
for i, (raw, out) in enumerate(zip(frames, outs)):
    ref = gold(planes_from_yv12_bytes(raw.tobytes(), w, h))
    assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(ref), np.uint8)), i
print(f"streamed {n} frames with copy overlap; all bit-exact vs the oracle")

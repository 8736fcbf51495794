"""Multi-stream deblocking: N concurrent YV12 streams zipped into per-step
packed batches, one H2D DMA per step, filtered across the device mesh and
returned per stream (the scaling story for the reference's hypothetical
multi-stream usage; parallel/multistream.py).

With the stream count equal to the device count (as here) the
frames-parallel fast path engages: whole frames shard over the flattened
mesh and each chip runs the fused-relayout packed formulation on its
local batch -- zero steady-state collectives.

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/multi_stream.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.parallel import MultiStreamDeblocker, make_mesh
from gpu_video_codec_jax.utils.bs import BoundaryStrength
from gpu_video_codec_jax.utils.yuv import (
    planes_from_yv12_bytes, yv12_bytes_from_planes,
)

n_dev = len(jax.devices())
mesh = make_mesh(n_dev, 1)
w, h, qp = 64, 48, 35
n_streams, n_steps = n_dev, 3
rng = np.random.default_rng(0)

# N independent frame streams (cameras, transcode jobs, ...)
streams = [[rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
            for _ in range(n_steps)] for _ in range(n_streams)]

ms = MultiStreamDeblocker(mesh, n_streams, w, h, qp, backend="pallas")
path = "frames-parallel fast path" if ms._frames_fast else "slab fallback"

bs = BoundaryStrength.intra_default(w, h)
checked = 0
for t, outs in enumerate(ms.run(streams)):  # one frame per stream per step
    for i, out in enumerate(outs):
        gold = deblock_frame_golden(
            planes_from_yv12_bytes(streams[i][t].tobytes(), w, h), bs, qp)
        assert np.array_equal(
            out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
        ), f"stream {i} step {t} diverged from the golden oracle"
        checked += 1

print(f"multi-stream: {n_streams} streams x {n_steps} steps over a "
      f"{n_dev}-device mesh ({path}); all {checked} frames bit-exact vs "
      "the golden oracle")

"""Device-resident pipelines: frames stay on device in the canonical
tile-planes layout between stages, so each deblock step costs ONLY the
fused kernels (PERF.md has the time on an H100).  Also shows frame
batching -- N frames per kernel launch.

    JAX_PLATFORMS=cpu python examples/resident_chain.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.models.resident import ResidentDeblocker
from gpu_video_codec_jax.utils.yuv import (
    planes_from_yv12_bytes, yv12_bytes_from_planes,
)

w, h, qp = 352, 288, 35
rng = np.random.default_rng(0)
raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)

rd = ResidentDeblocker(w, h, qp)

# one-shot (ingest -> step -> readback), checked against the oracle
out = rd(raw)
gold = DeblockPipeline(w, h, qp, backend="golden")(
    planes_from_yv12_bytes(raw.tobytes(), w, h))
assert np.array_equal(out, np.frombuffer(yv12_bytes_from_planes(gold), np.uint8))

# a chain: the state never leaves the device between steps.  Insert your own
# tile-planes stages between the steps -- the layout contract is
# TileFrame(y=(8,8,By,Bx), uv=..., u_rem=..., v_rem=...), uint8.
state = rd.ingest(raw)
for _ in range(3):
    state = rd.step(state)          # kernels only, no layout work
chained = rd.readback(state)

# frame batches: one kernel launch for the whole batch
batch_out = rd([raw, raw, raw])
assert batch_out.shape == (3, raw.size)
assert np.array_equal(batch_out[0], out)
print("resident: one-shot bit-exact; 3-step chain ran kernel-only; "
      "3-frame batch in one launch")

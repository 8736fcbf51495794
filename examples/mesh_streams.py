"""Multi-chip device-resident streaming: a frame batch sharded over the
mesh's "data" axis, each chip running the batched fused kernels on its
local frames -- zero collectives (tiles never communicate).

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/mesh_streams.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from gpu_video_codec_jax.models.pipeline import DeblockPipeline
from gpu_video_codec_jax.parallel import MeshResidentDeblocker, make_mesh
from gpu_video_codec_jax.utils.yuv import (
    planes_from_yv12_bytes, yv12_bytes_from_planes,
)

n_dev = len(jax.devices())
mesh = make_mesh(n_dev, 1)
w, h, qp = 64, 48, 35
rng = np.random.default_rng(0)
frames = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
          for _ in range(2 * n_dev)]

mrd = MeshResidentDeblocker(mesh, w, h, qp)
state = mrd.ingest(frames)            # scatter: 2 frames per chip
state = mrd.step(state, n_steps=2)    # chained kernel-only passes, all chips
outs = mrd.readback(state)

gold = DeblockPipeline(w, h, qp, backend="golden")
ref1 = gold(planes_from_yv12_bytes(frames[0].tobytes(), w, h))
one = mrd(frames)  # single pass for the oracle check
assert np.array_equal(one[0], np.frombuffer(yv12_bytes_from_planes(ref1), np.uint8))
print(f"{len(frames)} frames over {n_dev} devices ({mesh.shape}); "
      "2-step chain ran sharded; single pass bit-exact vs the oracle")

"""Simplest API: filter one YV12 frame with any backend.

    JAX_PLATFORMS=cpu python examples/one_shot.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gpu_video_codec_jax as gvc
from gpu_video_codec_jax.models.pipeline import DeblockPipeline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUT = os.path.join(HERE, "testdata", "mother-daughter_352x288_yv12.yuv")

frame = gvc.read_yv12(INPUT, 352, 288)
out = DeblockPipeline(352, 288, qp=35, backend="pallas")(frame)
gvc.write_yv12("/tmp/one_shot_out.yuv", out)

gold = DeblockPipeline(352, 288, qp=35, backend="golden")(frame)
assert all(np.array_equal(getattr(out, k), getattr(gold, k)) for k in "yuv")
print(f"filtered {int(np.sum(out.y != frame.y))} luma px; "
      "bit-exact vs the golden oracle -> /tmp/one_shot_out.yuv")

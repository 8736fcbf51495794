"""gpu_video_codec_jax: a JAX/Pallas framework for HEVC in-loop deblocking
of raw YV12 video on NVIDIA GPUs, built from scratch with the capabilities
of the CUDA reference RomanKazantsev/gpu_video_codec.

Layers (see SURVEY.md for the reference layer map this mirrors):
  ops/      filter math (tables, branchless segment filters), whole-frame
            tile-plane deblock, the fused GPU kernel (Pallas, Triton route)
  models/   frame pipeline / execution backends (golden NumPy oracle, jnp/XLA,
            Pallas, native C++ CPU) and the end-to-end streaming pipeline
  parallel/ device-mesh sharding (frame-batch data parallelism + spatial
            tile-row-slab sharding) via jax.sharding / shard_map
  utils/    YV12 I/O, padded-plane layout, boundary-strength subsystem,
            tile-planes layout transform, configuration
  runtime/  native C++ host runtime (YV12 decode into padded planes, OpenMP
            CPU filter backend, tiled-layout packing) with ctypes bindings
"""

__version__ = "0.1.0"

from .ops.tables import get_beta, get_tc  # noqa: F401
from .utils.yuv import FramePlanes, read_yv12, write_yv12  # noqa: F401
from .utils.bs import BoundaryStrength  # noqa: F401

#!/usr/bin/env python
"""Headline benchmark: prints ONE JSON line.

Metric: filtered Mpix/s at 1080p YV12 through the packed full graph (raw
YV12 bytes in device memory -> filtered YV12 bytes in device memory),
device time from a profiler trace (utils/tracing.py), including every
layout pass the packed contract requires.  The record also carries the
planes, resident and device-fed brackets, the host-fed pipeline, the link
microbenchmark, the card's name and power limit, and the reference's
numbers (BASELINE.md) as the yardstick.

Runs in one process on a GPU.  On any other platform it exits non-zero
and names the platform: a missing card is an error, not a slower number.

    python bench.py
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main() -> int:
    from gpu_video_codec_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"bench.py measures on a GPU; JAX's platform is {platform!r}",
              file=sys.stderr)
        return 1
    from bench.bench_lib import headline

    print(json.dumps(headline()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Experiment: residual row-block reorder formulations.

Times the (Byg, 8, 8, Bxg) <-> (8, 8, Byg, Bxg) residual permutation around
the mxu relayout dots (utils/tiles.py):

  xla_u8       jnp.transpose on uint8 (the shipped form, with the u8
               convert held in the dot epilogue).
  xla_i32      transpose of the raw int32 dot output with the convert fused
               after (4x the bytes) -- why utils/tiles.py places the convert
               before the reorder.

    python -m tools.reorder_exp [--byg 136] [--bxg 256]   # device time
"""

from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from gpu_video_codec_jax.utils.tracing import profiled_device_us


def main(byg=136, bxg=256, iters=30):
    rng = np.random.default_rng(0)
    fwd_u8 = jnp.asarray(rng.integers(0, 256, (byg, 8, 8, bxg), dtype=np.uint8))
    fwd_i32 = fwd_u8.astype(jnp.int32)
    inv_u8 = jnp.asarray(rng.integers(0, 256, (8, 8, byg, bxg), dtype=np.uint8))

    cands = {
        "xla_fwd_u8": (jax.jit(lambda x: jnp.transpose(x, (1, 2, 0, 3))), fwd_u8),
        "xla_fwd_i32_cvt_after": (
            jax.jit(lambda x: jnp.transpose(x, (1, 2, 0, 3)).astype(jnp.uint8)),
            fwd_i32),
        "xla_inv_u8": (jax.jit(lambda x: jnp.transpose(x, (2, 0, 1, 3))), inv_u8),
    }
    results = {"geometry": f"byg={byg} bxg={bxg}"}
    for name, (fn, arg) in cands.items():
        jax.block_until_ready(fn(arg))
        prof = profiled_device_us(lambda: fn(arg), iters=iters)
        results[name] = round(prof[0], 2) if prof else "no-trace"
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--byg", type=int, default=136)
    ap.add_argument("--bxg", type=int, default=256)
    a = ap.parse_args()
    main(a.byg, a.bxg)

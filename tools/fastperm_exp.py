"""Experiment: factorized relayout dots (middle-dim identity contraction).

The full-width one-hot perm dot does O(Wext) MACs per output pixel
(4.28G MACs at 1080p luma).  But
once the plane is padded to the extended grid width, the intra-row
de-interleave IS a pure transpose of the (t, c) split:

    xp (rows, Bxg, 8)  --contract middle dim with I_{Bxg}-->  (rows, 8, Bxg)

because dot_general's output is (lhs free dims in order, rhs free dims):
contracting t moves it to the end, past c.  MACs: rows*8*Bxg^2 = 571M at
1080p (7.5x fewer).  The inverse contracts the 8-wide c dim with I_8:
rows*Bxg*64 = 17.7M MACs (240x fewer).

Padding columns carry i8 value -128 (= pixel 0 after the +128 bias), so Q6
zero padding and grid-tail tiles still cost nothing.

Risk probed here: XLA could materialize an lhs transpose to put the
contraction dim last, reintroducing the byte shuffle.  Race on device.

Outcome: bit-exact, and XLA does materialize layout copies around the dot
(the contraction dim must become minor).  Shipped as utils/tiles.py's
FACTORED engine with the auto policy: grid width >= 4096.
"""

from __future__ import annotations

import json
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

from gpu_video_codec_jax.utils.tiles import (
    interior_to_tiles, tiles_to_interior, tile_perm_device,
)
from gpu_video_codec_jax.utils.tracing import profiled_device_us

W, H, PAD = 1920, 1080, 4
BYG, BXG = 136, 256
ROWS = 8 * BYG


def fwd_factored(plane):
    """(h, w) u8 -> (8, 8, BYG, BXG) u8 via middle-dim identity contraction."""
    bot = 8 * BYG - PAD - H
    xs = (plane.astype(jnp.int32) - 128).astype(jnp.int8)
    xp = jnp.pad(xs, ((PAD, bot), (PAD, 8 * BXG - PAD - W)),
                 constant_values=-128)
    x3 = xp.reshape(ROWS, BXG, 8)
    ident = jnp.eye(BXG, dtype=jnp.int8)
    o = jax.lax.dot_general(x3, ident, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    o = (o + 128).astype(jnp.uint8)          # (rows, 8, BXG)
    o = o.reshape(BYG, 8, 8, BXG)
    return o.transpose(1, 2, 0, 3)           # same residual reorder as current


def inv_factored(tiles):
    """(8, 8, BYG, BXG) u8 -> (h, w) u8 interior."""
    o = tiles.transpose(2, 0, 1, 3).reshape(ROWS, 8, BXG)
    o = o[PAD : PAD + H]
    xs = (o.astype(jnp.int32) - 128).astype(jnp.int8)
    ident = jnp.eye(8, dtype=jnp.int8)
    r = jax.lax.dot_general(xs, ident, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    r = (r + 128).astype(jnp.uint8)          # (h, BXG, 8)
    return r.reshape(H, 8 * BXG)[:, PAD : PAD + W]


def main():
    rng = np.random.default_rng(0)
    plane = jnp.asarray(rng.integers(0, 256, (H, W), dtype=np.uint8))
    tiles = jnp.asarray(rng.integers(0, 256, (8, 8, BYG, BXG), dtype=np.uint8))

    fwd_perm = tile_perm_device(W, PAD, False, BXG)
    inv_perm = tile_perm_device(W, PAD, True, BXG)
    cur_fwd = jax.jit(lambda x: interior_to_tiles(x, PAD, perm=fwd_perm,
                                                  by_grid=BYG, bx_grid=BXG))
    cur_inv = jax.jit(lambda t: tiles_to_interior(t, PAD, H, W, perm=inv_perm))
    new_fwd = jax.jit(fwd_factored)
    new_inv = jax.jit(inv_factored)

    ref_f = jax.device_get(cur_fwd(plane))
    ref_i = jax.device_get(cur_inv(tiles))
    got_f = jax.device_get(new_fwd(plane))
    got_i = jax.device_get(new_inv(tiles))
    res = {
        "fwd_exact": bool(np.array_equal(ref_f, got_f)),
        "inv_exact": bool(np.array_equal(ref_i, got_i)),
    }
    for name, fn, arg in [("cur_fwd", cur_fwd, plane), ("new_fwd", new_fwd, plane),
                          ("cur_inv", cur_inv, tiles), ("new_inv", new_inv, tiles)]:
        jax.block_until_ready(fn(arg))
        prof = profiled_device_us(lambda: fn(arg), iters=30)
        res[name + "_us"] = round(prof[0], 2) if prof else None
        if prof:
            res[name + "_top"] = {k: v for k, v in list(prof[2].items())[:4]}
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()

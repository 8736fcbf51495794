"""Fused deblock kernel for NVIDIA Hopper (Pallas, Triton route).

Replaces the reference's CUDA kernels (DeblockingFilterLumaKernel
gpu.cu:535-837, DeblockingFilterChromaKernel gpu.cu:839-1072).  Like them,
one thread owns one 8x8 tile and runs all four edge phases -- vertical and
horizontal, decision and filter, strong and normal -- in order, in
registers, with no shared memory and no atomics.  Each pixel is read from
HBM once and written once; luma and the fused U+V grid are two launches
per frame where the reference needed three (gpu.cu:1269-1285).

Layout: the input is the tile-planes tensor (..., 8, 8, By, Bx)
(utils/tiles.py), viewed as 64 contiguous planes of By*Bx tiles.  A program
owns a block of consecutive tiles: it loads each of the 64 planes
as one masked uint8 vector (a warp reads 32 consecutive bytes of a plane,
so the loads coalesce), computes in int32, and stores each plane once.
Masks cover the grid tail, so the kernel pads nothing.

Bit-exactness: the kernel body calls ops.deblock.deblock_planes_core -- the
same code the XLA path runs -- so the two are identical by construction;
tests/test_pallas.py asserts it anyway.

Interpret mode: on the CPU backend the same kernel runs in the Pallas
interpreter (that is how the tests exercise it); on a GPU it is compiled by
Triton; any other platform is an error (interpret_mode).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .deblock import deblock_planes_core
from ..utils.tiles import plane_to_tiles, split_covered, tiles_to_plane

# Grid-layout contract of the callers: the streaming, resident and mesh
# paths pad their tile grids to multiples of these (effective_block_bx),
# and the kernel accepts any grid, padded or not.
BLOCK_BY = 8
BLOCK_BX = 512
CHROMA_BLOCK_BY = 32
CHROMA_BLOCK_BX = 256
CHROMA_BLOCK = (CHROMA_BLOCK_BY, CHROMA_BLOCK_BX)

# Tiles per program over 4 warps.  Luma: one tile per thread, so a thread
# holds the 64 int32 planes of its tile plus the filter's temporaries,
# under the 255-register limit.  Chroma's filter keeps far fewer values
# live, so two tiles per thread fit.  Both were the fastest of the
# (64, 2), (128, 4), (256, 4), (256, 8) sweep on an H100 at 1080p and 4K
# (bench.bench_lib.autotune_kernel; PERF.md).
LUMA_TILES_PER_PROGRAM = 128
CHROMA_TILES_PER_PROGRAM = 256
NUM_WARPS = 4


def interpret_mode(platform: str | None = None) -> bool:
    """Whether the kernel runs in the Pallas interpreter on `platform`
    (default: JAX's default backend).  cpu -> interpreted (the tests);
    gpu -> compiled; anything else -> ValueError naming the platform."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise ValueError(
        f"the deblock kernel runs compiled on 'gpu' or interpreted on "
        f"'cpu'; platform {platform!r} is not supported")


def _kernel(beta_ref, tc_ref, t_ref, v1_ref, v2_ref, h1_ref, h2_ref, out_ref,
            *, chroma, dtype, n_tiles, block, per_frame_maps):
    b = pl.program_id(0)
    start = pl.program_id(1) * block
    mask = start + jnp.arange(block) < n_tiles
    cols = pl.ds(start, block)

    def load(ref, *idx):
        return plgpu.load(ref.at[(*idx, cols)], mask=mask, other=0)

    mb = b if per_frame_maps else 0
    bs_maps = tuple(load(ref, mb).astype(jnp.int32)
                    for ref in (v1_ref, v2_ref, h1_ref, h2_ref))
    planes = [[load(t_ref, b, 8 * r + c).astype(dtype) for c in range(8)]
              for r in range(8)]
    deblock_planes_core(planes, bs_maps, beta_ref[0], tc_ref[0], chroma,
                        dtype=dtype)
    for r in range(8):
        for c in range(8):
            plgpu.store(out_ref.at[b, 8 * r + c, cols],
                        planes[r][c].astype(out_ref.dtype), mask=mask)


def effective_block_bx(requested: int, grid_bx: int) -> int:
    """Tile-column block of the callers' grid layout (streaming, resident
    and mesh paths pad their grids to multiples of it, and must agree).

    Clamps the requested block to the 8-aligned grid size so small grids
    are not padded all the way up (CIF: Bx=45 -> 48, not 256), and rounds
    up to a 128-column multiple when that costs at most ~10% padding."""
    tight = min(requested, -(-grid_bx // 8) * 8)
    if tight >= 128:
        aligned = -(-grid_bx // 128) * 128
        if aligned <= requested and aligned * 10 <= tight * 11:
            return aligned
    return tight


@functools.partial(jax.jit, static_argnames=("chroma", "dtype", "block",
                                             "num_warps"))
def deblock_tiles_pallas(
    tiles,
    bs_ver1,
    bs_ver2,
    bs_hor1,
    bs_hor2,
    beta,
    tc,
    chroma: bool = False,
    dtype=jnp.int32,
    block: int | None = None,
    num_warps: int = NUM_WARPS,
):
    """Fused deblock of a (8, 8, By, Bx) uint8 tile tensor.

    A leading batch axis is supported natively: tiles (NB, 8, 8, By, Bx)
    with bs maps (NB, By, Bx) -- or (1, By, Bx) to share one map across the
    batch -- runs the batch as the outer grid dimension (frames / planes
    per launch with zero data reordering).

    bs_*: (By, Bx) uint8 segment BS maps.  beta/tc: int32 scalars.
    block/num_warps: tiles per program (default per plane type) and warps
    per program, powers of 2.
    """
    if block is None:
        block = CHROMA_TILES_PER_PROGRAM if chroma else LUMA_TILES_PER_PROGRAM
    batched = tiles.ndim == 5
    nb = tiles.shape[0] if batched else 1
    maps = (bs_ver1, bs_ver2, bs_hor1, bs_hor2)
    if batched:
        for name, m in zip(("bs_ver1", "bs_ver2", "bs_hor1", "bs_hor2"), maps):
            if m.ndim != 3 or m.shape[0] not in (1, nb):
                raise ValueError(
                    f"batched tiles (leading batch {nb}) need 3-D BS maps with "
                    f"a leading dim of 1 (shared) or {nb} (per-frame); "
                    f"{name} has shape {m.shape}")
    by, bx = tiles.shape[-2], tiles.shape[-1]
    n_tiles = by * bx
    # free reshapes: the 64 planes are contiguous over the By*Bx tiles.
    # Maps smaller than a pre-padded tile grid get BS 0 (no-op) tiles.
    t = tiles.reshape(nb, 64, n_tiles)
    maps = [jnp.pad(m, [(0, 0)] * (m.ndim - 2) + [(0, by - m.shape[-2]),
                                                 (0, bx - m.shape[-1])])
            .reshape(-1, n_tiles) for m in maps]
    per_frame_maps = maps[0].shape[0] != 1
    name = "deblock_chroma" if chroma else "deblock_luma"
    out = pl.pallas_call(
        functools.partial(_kernel, chroma=chroma, dtype=dtype,
                          n_tiles=n_tiles, block=block,
                          per_frame_maps=per_frame_maps),
        out_shape=jax.ShapeDtypeStruct(t.shape, t.dtype),
        grid=(nb, pl.cdiv(n_tiles, block)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret_mode(),
        name=name,
    )(
        jnp.asarray(beta, jnp.int32).reshape(1),
        jnp.asarray(tc, jnp.int32).reshape(1),
        t,
        *maps,
    )
    return out.reshape(tiles.shape)


def deblock_frame_pallas(y_ext, u_ext, v_ext, luma_maps, chroma_maps, beta, tc,
                         luma_only=False, dtype=jnp.int32):
    """Full-frame deblock via the fused kernel.

    Luma runs as one kernel call; U and V fold into a single chroma call by
    concatenating their tile grids along the By axis (tiles are independent,
    so any tile-aligned packing is exact) -- 2 launches per frame vs the
    reference's 3 (gpu.cu:1269-1285).
    """
    yt = plane_to_tiles(y_ext)
    y_out = deblock_tiles_pallas(yt, *luma_maps, beta, tc, chroma=False,
                                 dtype=dtype)
    y_plane = tiles_to_plane(y_out)
    if luma_only:
        return y_plane, u_ext, v_ext
    u_plane, v_plane = deblock_chroma_ext_pallas(
        u_ext, v_ext, chroma_maps, beta, tc, dtype=dtype)
    return y_plane, u_plane, v_plane


def deblock_chroma_ext_pallas(u_ext, v_ext, chroma_maps, beta, tc,
                              dtype=jnp.int32):
    """Chroma-only deblock of extended U/V planes (one fused launch).

    Chroma sweeps the reference's flat (8*ncby, 8*ncbx) view (quirk Q9:
    sheared when the extended width isn't 8-aligned; the flat remainder,
    possibly containing real bottom rows, is untouched)."""
    u_core, u_paste = split_covered(u_ext)
    v_core, v_paste = split_covered(v_ext)
    ut = plane_to_tiles(u_core)
    vt = plane_to_tiles(v_core)
    uv = jnp.concatenate([ut, vt], axis=2)  # stack tile grids along By
    cmaps = [jnp.concatenate([m, m], axis=0) for m in chroma_maps]
    uv_out = deblock_tiles_pallas(uv, *cmaps, beta, tc, chroma=True,
                                  dtype=dtype)
    cby = ut.shape[2]
    u_plane = u_paste(tiles_to_plane(uv_out[:, :, :cby]), jnp)
    v_plane = v_paste(tiles_to_plane(uv_out[:, :, cby:]), jnp)
    return u_plane, v_plane


@functools.partial(jax.jit, static_argnames=("luma_only", "dtype"))
def deblock_frame_pallas_jit(y, u, v, luma_maps, chroma_maps, beta, tc, luma_only=False,
                             dtype=jnp.int32):
    return deblock_frame_pallas(y, u, v, luma_maps, chroma_maps, beta, tc,
                                luma_only=luma_only, dtype=dtype)

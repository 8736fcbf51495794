"""Tile-planes layout: extended plane (Hext, Wext) <-> (8, 8, By, Bx).

This layout is the central design decision of the framework.  Every
deblocking edge segment of the reference reads and writes only pixels inside
its own shifted 8x8 tile (cpu.h:146-447), so after regrouping the plane into
per-tile-coordinate "planes" T[r, c] of shape (By, Bx), the *entire* filter
-- decisions, strong/normal luma, chroma, all four segments -- becomes pure
elementwise arithmetic between 64 such planes.  No gathers, no shifts, no
halos: one GPU thread owns one tile (ops/pallas_kernel.py), and the 64
planes of a block of tiles are 64 coalesced rows.  (The reference instead
enumerates 32 pixel *pointers* per segment, cpu.h:169-207.)

Works on numpy and jax.numpy arrays alike (pure reshape/transpose).
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

from ..ops.tables import SAMPLE_BLOCK_SIZE


class FactoredPerm(NamedTuple):
    """Marker operand selecting the FACTORED relayout engine (no device
    payload -- the engine's identity matrices are tiny and built in-trace).

    The factored engine (round 3): once the plane is padded to the extended
    grid width, the intra-row de-interleave IS a transpose of the (t, c)
    column split, and dot_general contracting the MIDDLE dim moves it past
    c (output = lhs free dims in order + rhs free dims):

        forward: (.., rows, Bxg, 8) x I_Bxg -> (.., rows, 8, Bxg)
        inverse: (.., rows, 8, Bxg) x I_8   -> (.., rows, Bxg, 8)

    MACs per 1080p luma plane: 571M forward / 17.7M inverse, vs the full
    one-hot perm's 4.28G each; bit-exact by construction (identity
    contraction selects exactly one input).  Padding:
    u8 mode (default) pads plain 0 -- identity dot of 0 is 0 (Q6); s8 mode
    pads -128 in the shifted domain == pixel 0 after the +128 add-back.
    """


def split_covered(plane):
    """Split (.., H, W) into the tile-swept region and a paste-back closure.

    Quirk Q9 (discovered by fuzzing the compiled reference, see
    tools/validate_vs_reference.py --fuzz): the reference's chroma pointer
    arithmetic uses `num_chroma_blocks_x * 8` as the row stride
    (cpu.h:469-471 et al.) instead of the plane's actual `_new_chroma_width`.
    When the extended chroma width is not a multiple of 8 (w % 16 == 8,
    e.g. 56x72 frames), the filter therefore operates on a *sheared*
    reinterpretation of the buffer: the first (8*ncby)*(8*ncbx) bytes of the
    flat plane viewed as an (8*ncby, 8*ncbx) row-major image.  That view is
    deterministic and in-bounds, so bit-exactness requires reproducing it.
    When the extended width IS a multiple of 8 the view degenerates to the
    first 8*ncby true rows (possibly truncating bottom padding rows).

    Tile counts come from truncating division (num_blocks = new_dim / 8,
    cpu.h:141-142, 450-451).  Returns (core, paste): `core` is the
    (.., 8*ncby, 8*ncbx) tile-swept view; `paste(filtered_core, xp)` rebuilds
    the full (.., H, W) plane with the untouched flat remainder reattached.
    """
    b = SAMPLE_BLOCK_SIZE
    h, w = plane.shape[-2], plane.shape[-1]
    ncby, ncbx = h // b, w // b
    vh, vw = ncby * b, ncbx * b
    lead = plane.shape[:-2]
    flat = plane.reshape(*lead, h * w)
    core = flat[..., : vh * vw].reshape(*lead, vh, vw)

    def paste(out_core, xp):
        out_flat = out_core.reshape(*lead, vh * vw)
        if vh * vw != h * w:
            out_flat = xp.concatenate([out_flat, flat[..., vh * vw :]], axis=-1)
        return out_flat.reshape(*lead, h, w)

    return core, paste


def split_covered_data(plane):
    """Data-oriented split_covered: returns (core, remainder) as ARRAYS
    instead of (core, paste-closure), so the pieces can live inside jit
    pytrees (the device-resident streaming state).  Same Q9 semantics:
    `core` is the first (8*ncby)*(8*ncbx) bytes of the flat plane viewed as
    an (8*ncby, 8*ncbx) row-major image; `remainder` is the untouched flat
    tail (possibly containing real bottom chroma rows)."""
    core, _ = split_covered(plane)
    lead = plane.shape[:-2]
    h, w = plane.shape[-2], plane.shape[-1]
    vh, vw = core.shape[-2], core.shape[-1]
    rem = plane.reshape(*lead, h * w)[..., vh * vw :]
    return core, rem


def join_covered(core, rem, h, w, xp):
    """Inverse of split_covered_data: rebuild the (.., h, w) plane from the
    filtered core and the untouched flat remainder."""
    lead = core.shape[:-2]
    flat = core.reshape(*lead, core.shape[-2] * core.shape[-1])
    if rem.shape[-1]:
        flat = xp.concatenate([flat, rem], axis=-1)
    return flat.reshape(*lead, h, w)


# ---------------------------------------------------------------------------
# Relayout engines (GVCT_RELAYOUT).
#
# "transpose" (default; "auto" means the same): reshape + jnp/np transpose,
# a pure data movement that XLA lowers to copy kernels.
#
# "mxu": express the intra-row de-interleave (the minor-dim change, the only
# hard part) as ONE one-hot matmul -- the one-hot contraction selects exactly
# one input per output, so the result is bit-exact by construction.  The
# residual row-block reorder keeps the minor dim contiguous and costs a cheap
# chunked copy.  Kept for comparison; callers build its one-hot operands only
# when it is selected.
#
# Dot dtype of the mxu engine (GVCT_RELAYOUT_DTYPE):
#   "u8" (default): u8 x u8 -> s32, consuming uint8 pixels and the 0/1
#     matrix directly; unselected (padding) output columns give dot == 0 ==
#     pixel 0 (Q6).
#   "s8": s8 x s8 -> s32 on shifted pixels -- (x - 128) fits int8, and with
#     a 0/1 matrix P: dot(x - 128, P) + 128 * colsum(P) == dot(x, P) exactly
#     (colsum is 1 on selected output columns, 0 on padding columns).
#   "bf16": uint8 values (<= 255) are exact in bf16, and so is every one-hot
#     product accumulated in f32, whatever the matmul precision.
# ---------------------------------------------------------------------------


def relayout_engine() -> str:
    """The selected relayout engine: "mxu" when GVCT_RELAYOUT=mxu, else
    "transpose" (the default, also for "auto")."""
    mode = os.environ.get("GVCT_RELAYOUT", "auto")
    if mode not in ("auto", "transpose", "mxu"):
        raise ValueError(f"GVCT_RELAYOUT must be auto, transpose or mxu, got {mode!r}")
    return "mxu" if mode == "mxu" else "transpose"


def _relayout_dtype() -> str:
    return os.environ.get("GVCT_RELAYOUT_DTYPE", "u8")


def _perm_device(perm_np):
    """Device operands for a one-hot relayout dot: (mat, bias).

    u8 mode (default): (uint8 matrix, None) -- the dot consumes uint8
    pixels directly.  s8 mode: (int8 matrix, int32 bias = 128 * column
    sums).  bf16 mode: (bfloat16 matrix, None)."""
    import jax.numpy as jnp

    mode = _relayout_dtype()
    if mode == "bf16":
        return jnp.asarray(perm_np, jnp.bfloat16), None
    if mode == "s8":
        bias = (128.0 * perm_np.sum(0)).astype("int32")
        return jnp.asarray(perm_np, jnp.int8), jnp.asarray(bias)
    return jnp.asarray(perm_np, jnp.uint8), None


def _onehot_dot(x_u8, ops, n):
    """dot(x_u8, P) over x's last axis (n leading axes kept), exactly.

    ops = (mat, bias) from _perm_device; returns int32 (u8/s8 modes) or
    int-valued f32 (bf16 mode) -- callers .astype(uint8) after any
    reshaping."""
    import jax
    import jax.numpy as jnp

    mat, bias = ops
    dims = (((n + 1,), (0,)), ((), ()))
    if mat.dtype == jnp.uint8:
        return jax.lax.dot_general(x_u8, mat, dims,
                                   preferred_element_type=jnp.int32)
    if bias is None:
        return jax.lax.dot_general(x_u8.astype(jnp.bfloat16), mat, dims,
                                   preferred_element_type=jnp.float32)
    xs = (x_u8.astype(jnp.int32) - 128).astype(jnp.int8)
    o = jax.lax.dot_general(xs, mat, dims, preferred_element_type=jnp.int32)
    return o + bias


@functools.lru_cache(maxsize=None)
def _perm_np(w: int, inverse: bool):
    """One-hot (w, w) permutation: col j = (tile t=j//8, in-tile c=j%8) maps
    to de-interleaved col c*(w//8) + t (forward); transposed for inverse."""
    import numpy as np

    b = SAMPLE_BLOCK_SIZE
    bx = w // b
    j = np.arange(w)
    p = np.zeros((w, w), np.float32)
    if inverse:
        p[(j % b) * bx + j // b, j] = 1.0
    else:
        p[j, (j % b) * bx + j // b] = 1.0
    return p


# Block-diagonal split of the one-hot relayout for LARGE widths: the full
# perm's dot does O(Wext) MACs per pixel; slicing the extended width into K
# 8-aligned slices with one shared square (S, S) per-slice perm cuts that to
# O(S), and the K axis lands exactly where the de-interleaved layout wants it
# (t_global = k * bxh + t_local), so only the reshape pattern changes.
_SPLIT_MIN_WEXT = 4096
_SPLIT_TARGET_S = 1024


def _split_k(wext_grid: int) -> int:
    """Number of relayout slices for a grid-padded extended width (1 = use
    the full-width perm).  GVCT_RELAYOUT_SPLIT=<k> forces a value (0 = auto);
    split requires an integer mode, u8/s8 (the bf16 engine keeps the full
    perm)."""
    forced = os.environ.get("GVCT_RELAYOUT_SPLIT")
    if forced is not None and int(forced) > 0:
        k = int(forced)
        return k if (wext_grid // SAMPLE_BLOCK_SIZE) % k == 0 else 1
    if _relayout_dtype() == "bf16" or wext_grid < _SPLIT_MIN_WEXT:
        return 1
    bxg = wext_grid // SAMPLE_BLOCK_SIZE
    k = max(1, wext_grid // _SPLIT_TARGET_S)
    while k > 1 and bxg % k:
        k -= 1
    return k




def _fact_enabled(wext_grid: int | None = None) -> bool:
    """Factored engine policy (integer modes u8/s8; GVCT_RELAYOUT_FACT=1
    forces on, =0 forces off, unset = auto by grid width).

    The middle-dim contraction cuts the one-hot MACs (O(Wg) -> O(Wg/8)
    forward, O(64) inverse) and is bit-exact, but XLA materializes lhs and
    output layout copies around the middle-dim dot_general.  Auto policy:
    factored iff the extended grid width >= _SPLIT_MIN_WEXT (4096) --
    superseding the split engine as the large-width strategy
    (GVCT_RELAYOUT_SPLIT still forces split for experiments)."""
    forced = os.environ.get("GVCT_RELAYOUT_FACT")
    if _relayout_dtype() == "bf16":
        return False
    if forced is not None:
        return forced == "1"
    if os.environ.get("GVCT_RELAYOUT_SPLIT"):
        return False  # explicit split experiment wins over auto-factored
    return wext_grid is not None and wext_grid >= _SPLIT_MIN_WEXT


def _to_s8(x):
    """uint8 -> shifted int8 domain (x - 128), exact."""
    import jax.numpy as jnp

    return (x.astype(jnp.int32) - 128).astype(jnp.int8)


def _fact_fwd_rows(rows_u8):
    """(.., R, 8*Bxg) uint8 extended-grid rows -> (.., R, 8, Bxg) uint8
    de-interleaved rows, via the middle-dim identity contraction.  u8 mode
    feeds the pixels straight to the dot; s8 mode shifts to (x - 128)
    internally and adds 128 back (both exact; zero-padded input rows come
    out 0 either way -- the shift maps 0 -> -128 -> 0)."""
    import jax
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    *lead, r, wg = rows_u8.shape
    n = len(lead)
    bxg = wg // b
    dims = (((n + 1,), (0,)), ((), ()))
    if _relayout_dtype() == "s8":
        x3 = _to_s8(rows_u8).reshape(*lead, r, bxg, b)
        o = jax.lax.dot_general(x3, jnp.eye(bxg, dtype=jnp.int8), dims,
                                preferred_element_type=jnp.int32) + 128
    else:
        x3 = rows_u8.reshape(*lead, r, bxg, b)
        o = jax.lax.dot_general(x3, jnp.eye(bxg, dtype=jnp.uint8), dims,
                                preferred_element_type=jnp.int32)
    return o.astype(jnp.uint8)  # (.., R, 8, Bxg)


def _fact_inv_rows(rows_cs):
    """(.., R, 8, Bxg) uint8 de-interleaved rows -> (.., R, 8*Bxg) uint8
    extended-grid rows (inverse identity contraction over the 8-wide c dim).
    Same u8/s8 dtype policy as _fact_fwd_rows."""
    import jax
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    *lead, r, _, bxg = rows_cs.shape
    n = len(lead)
    dims = (((n + 1,), (0,)), ((), ()))
    if _relayout_dtype() == "s8":
        o = jax.lax.dot_general(_to_s8(rows_cs), jnp.eye(b, dtype=jnp.int8),
                                dims, preferred_element_type=jnp.int32) + 128
    else:
        o = jax.lax.dot_general(rows_cs, jnp.eye(b, dtype=jnp.uint8),
                                dims, preferred_element_type=jnp.int32)
    # (.., R, Bxg, 8): flat col index t*8 + c IS the extended column
    return o.astype(jnp.uint8).reshape(*lead, r, b * bxg)


def _mxu_eligible(x) -> bool:
    """The mxu engine applies to uint8 jax arrays when it is selected."""
    if relayout_engine() != "mxu":
        return False
    import numpy as np

    return not isinstance(x, np.ndarray) and str(x.dtype) == "uint8"


def _plane_to_tiles_mxu(plane):
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    *lead, h, w = plane.shape
    n = len(lead)
    by, bx = h // b, w // b
    if _fact_enabled(w):
        o = _fact_fwd_rows(plane)  # (.., Hext, 8, Bx) uint8
    else:
        # convert to uint8 IN the dot epilogue (values are exact u8 already):
        # the residual reorder then moves 1-byte, not 4-byte, elements -- the
        # transpose copy's traffic drops 4x
        o = _onehot_dot(plane, _perm_device(_perm_np(w, inverse=False)), n)
        o = o.astype(jnp.uint8)  # (.., Hext, [c, t])
    o = o.reshape(*lead, by, b, b, bx)
    # (.., By, r, c, Bx) -> (.., r, c, By, Bx): minor dim Bx unchanged
    return o.transpose(*range(n), n + 1, n + 2, n + 0, n + 3)


def _tiles_to_plane_mxu(tiles):
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    *lead, r, c, by, bx = tiles.shape
    n = len(lead)
    w = bx * b
    # (.., r, c, By, Bx) -> (.., By, r, [c, Bx]) rows: minor dim Bx unchanged
    o = tiles.transpose(*range(n), n + 2, n + 0, n + 1, n + 3)
    if _fact_enabled(w):
        return _fact_inv_rows(o.reshape(*lead, by * b, b, bx))
    o = o.reshape(*lead, by * b, b * bx)
    o = _onehot_dot(o, _perm_device(_perm_np(w, inverse=True)), n)
    return o.astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _perm_np_interior(w: int, pad: int, inverse: bool, bx_grid: int | None = None):
    """Rectangular one-hot: interior col j <-> de-interleaved extended col
    (c, t) of global col j+pad.  Forward (w, 8*bx_grid): extended padding
    columns (and Pallas grid-tail tile columns when bx_grid > Bx) have no 1
    anywhere -> they come out zero, i.e. the Q6 zero padding AND the kernel
    block padding are FREE (folded into the relayout dot).  Inverse
    (8*bx_grid, w): those columns are simply never selected, folding the
    interior slice."""
    import numpy as np

    b = SAMPLE_BLOCK_SIZE
    wext = w + 2 * pad
    if wext % b:
        raise ValueError(f"extended width {wext} not a multiple of {b}")
    bx = wext // b
    bxg = bx if bx_grid is None else bx_grid
    if bxg < bx:
        raise ValueError(f"bx_grid {bxg} < tile columns {bx}")
    j = np.arange(w)
    g = j + pad
    if inverse:
        p = np.zeros((b * bxg, w), np.float32)
        p[(g % b) * bxg + g // b, j] = 1.0
    else:
        p = np.zeros((w, b * bxg), np.float32)
        p[j, (g % b) * bxg + g // b] = 1.0
    return p


def tile_perm_device(w: int, pad: int, inverse: bool, bx_grid: int | None = None):
    """The one-hot relayout operands as DEVICE arrays: (mat, bias) --
    uint8 matrix + None (u8 mode, default), int8 matrix + int32 add-back
    bias (GVCT_RELAYOUT_DTYPE=s8) or bfloat16 matrix + None
    (GVCT_RELAYOUT_DTYPE=bf16).  For large widths the operand is the
    shared square (S, S) per-slice perm of the block-diagonal split engine
    (_split_k policy); the engines detect the mode from the matrix shape.

    Pass this into interior_to_tiles/tiles_to_interior via perm= when the
    call sits inside a jit that runs per frame: as a closure/trace constant
    XLA regenerates the (multi-MB) matrix on device every step; as an
    argument it lives in HBM once.  Under the factored engine (large grid
    widths, see FactoredPerm / _fact_enabled) there is no device payload at
    all -- the returned marker just selects the engine."""
    b = SAMPLE_BLOCK_SIZE
    bxg = (w + 2 * pad) // b if bx_grid is None else bx_grid
    if _fact_enabled(b * bxg):
        return FactoredPerm()
    k = _split_k(b * bxg)
    if k > 1:
        return _perm_device(_perm_np(b * bxg // k, inverse))
    return _perm_device(_perm_np_interior(w, pad, inverse, bx_grid))


def interior_to_tiles(plane, pad: int, *, perm=None, bx_grid: int | None = None,
                      by_grid: int | None = None):
    """(.., h, w) INTERIOR plane -> (.., 8, 8, by_grid, bx_grid) tile-planes
    of the zero-extended plane (Q6 defined-zero padding, cpu.h:55-82 done
    right), with the tile grid optionally pre-padded to (by_grid, bx_grid)
    (no-op tiles: zero pixels).

    Tile rows count by truncating division, (h + 2*pad) // 8 -- for luma
    (h % 8 == 0) that covers the full extended plane; for chroma with
    h % 8 == 4 it is the Q9 COVERED row count (the dropped bottom rows are
    padding that the covered sweep never touches, cpu.h:450-451).  Requires
    the extended width to be 8-aligned (the non-sheared Q9 case).

    Equals plane_to_tiles(zero-pad(plane, pad)) restricted to covered tile
    rows (plus zero tiles up to the grid) bit-for-bit; on the mxu engine
    the column padding, grid padding and row truncation all fold into one
    relayout matmul + one row pad."""
    *lead, h, w = plane.shape
    n = len(lead)
    b = SAMPLE_BLOCK_SIZE
    bx = (w + 2 * pad) // b
    by = (h + 2 * pad) // b
    bxg = bx if bx_grid is None else bx_grid
    byg = by if by_grid is None else by_grid
    if byg < by:
        raise ValueError(f"by_grid {byg} < tile rows {by}")
    if pad + h > b * by:
        raise ValueError(f"interior rows [{pad}, {pad + h}) exceed covered rows {b * by}")
    bot = b * byg - pad - h  # bottom zero rows: Q6 padding (clipped to the
    #                          covered extent) + grid-padding tile rows
    if not _mxu_eligible(plane):
        import numpy as np

        if isinstance(plane, np.ndarray):
            xp = np
        else:
            import jax.numpy as xp
        widths = [(0, 0)] * n + [(pad, bot), (pad, pad)]
        t = plane_to_tiles(xp.pad(plane, widths))
        if bxg > bx:
            t = xp.pad(t, [(0, 0)] * (n + 2) + [(0, 0), (0, bxg - bx)])
        return t
    import jax.numpy as jnp

    if perm is None:
        perm = tile_perm_device(w, pad, False, bxg)
    if isinstance(perm, FactoredPerm):
        # plain zero padding is exact in both dot modes: u8 selects the 0
        # directly; s8 shifts it to -128 and the +128 add-back restores 0
        # (Q6) -- so column/grid padding still costs nothing
        xp = jnp.pad(plane,
                     [(0, 0)] * n + [(pad, bot), (pad, b * bxg - pad - w)])
        o = _fact_fwd_rows(xp)  # (.., 8*byg, 8, bxg) uint8
        o = o.reshape(*lead, byg, b, b, bxg)
        return o.transpose(*range(n), n + 1, n + 2, n + 0, n + 3)
    mat = perm[0]
    # split engine = square slice perm; the full fwd perm (w, 8*bxg) is
    # never square (the extended grid width always exceeds the interior)
    if mat.shape[0] == mat.shape[1]:
        s = mat.shape[0]
        k, bxh = b * bxg // s, s // b
        # explicit zero column padding (the rectangular full perm folds it;
        # the split perm is square, so pad first -- still exact: (0-128)
        # selected + bias 128 = 0)
        rows = jnp.pad(plane, [(0, 0)] * n
                       + [(pad, bot), (pad, b * bxg - pad - w)])
        o = _onehot_dot(rows.reshape(*lead, b * byg, k, s), perm, n + 1)
        o = o.astype(jnp.uint8).reshape(*lead, byg, b, k, b, bxh)
        # (.., By, r, k, c, bxh) -> (.., r, c, By, [k, bxh]=Bx); uint8
        # convert done in the dot epilogue so this copy moves 1-byte elements
        o = o.transpose(*range(n), n + 1, n + 3, n + 0, n + 2, n + 4)
        return o.reshape(*lead, b, b, byg, bxg)
    # zero row padding is exact under the s8 engine too: (0-128) selected
    # -> -128 + bias 128 = 0, and unselected columns get bias 0
    rows = jnp.pad(plane, [(0, 0)] * n + [(pad, bot), (0, 0)])
    o = _onehot_dot(rows, perm, n)  # (.., 8*byg, [c, t])
    # uint8 convert IN the dot epilogue, held there by an optimization
    # barrier: without it, in-graph XLA re-fuses the convert into the
    # residual reorder, which then moves 4-byte elements
    import jax

    o = jax.lax.optimization_barrier(o.astype(jnp.uint8))
    o = o.reshape(*lead, byg, b, b, bxg)
    return o.transpose(*range(n), n + 1, n + 2, n + 0, n + 3)


def tiles_to_interior(tiles, pad: int, h: int, w: int, *, perm=None):
    """(.., 8, 8, By, bx_grid) tile-planes -> (.., h, w) interior of the
    extended plane (the written-back region, cpu.h:995-1018).  Accepts a
    grid whose tile columns are padded past Bx (the extra columns are
    ignored).  Equals tiles_to_plane(tiles[.., :Bx])[.., pad:pad+h,
    pad:pad+w]; on the mxu engine the interior selection folds into the inverse
    relayout matmul and interior rows are sliced BEFORE the dot so the
    matmul output converts straight to uint8."""
    *lead, r, c, by_g, bxg = tiles.shape
    n = len(lead)
    b = SAMPLE_BLOCK_SIZE
    bx = (w + 2 * pad) // b
    by = (h + 2 * pad) // b
    if not _mxu_eligible(tiles):
        full = tiles_to_plane(tiles[..., :by, :bx])
        return full[..., pad : pad + h, pad : pad + w]
    import jax.numpy as jnp

    if perm is None:
        perm = tile_perm_device(w, pad, True, bxg)
    if isinstance(perm, FactoredPerm):
        o = tiles[..., :by, :].transpose(*range(n), n + 2, n + 0, n + 1, n + 3)
        o = o.reshape(*lead, by * b, b, bxg)   # (.., rows, 8c, bxg)
        o = o[..., pad : pad + h, :, :]        # interior rows BEFORE the dot
        rows = _fact_inv_rows(o)               # (.., h, 8*bxg) uint8
        return rows[..., :, pad : pad + w]
    mat = perm[0]
    # split engine = square slice perm; the full inverse perm (8*bxg, w) is
    # never square (the extended grid width always exceeds the interior)
    if mat.shape[0] == mat.shape[1]:
        s = mat.shape[0]
        k, bxh = b * bxg // s, s // b
        o = tiles[..., :by, :].reshape(*lead, b, b, by, k, bxh)
        # (.., r, c, By, k, bxh) -> (.., By, r, k, [c, bxh]=S)
        o = o.transpose(*range(n), n + 2, n + 0, n + 3, n + 1, n + 4)
        o = o.reshape(*lead, by * b, k, s)
        o = o[..., pad : pad + h, :, :]  # interior rows BEFORE the dot
        o = _onehot_dot(o, perm, n + 1)
        o = o.reshape(*lead, h, b * bxg)
        return o[..., :, pad : pad + w].astype(jnp.uint8)
    o = tiles[..., :by, :].transpose(*range(n), n + 2, n + 0, n + 1, n + 3)
    o = o.reshape(*lead, by * b, b * bxg)
    o = o[..., pad : pad + h, :]  # interior rows BEFORE the dot
    o = _onehot_dot(o, perm, n)
    return o.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Packed-chroma fold engine (GVCT_PACKED_CHROMA=fold, with the mxu engine).
#
# The packed YV12 graph's chroma boundary is buf[h:] (h/2, w) <-> (2, ch, cw)
# -- a minor-dim width change that costs a retile copy.  The fold expresses
# the SAME boundary as wider one-hot dots: packed row r of a plane holds
# plane rows 2r and 2r+1 side by side (w = 2*cw), so the row PARITY rides
# the output-column space of a (w, 2*8*cbxg) forward one-hot, and the
# residual-reorder transpose absorbs it by splitting packed rows (By, rh)
# and merging r8 = 2*rh + q -- minor dim untouched.  Inverse symmetric:
# (2*8*cbxg, w) emits packed rows directly.  Bit-exact by construction
# (one-hot selection); the trade is 2x the relayout MACs for zero retile
# copies (tools/chromafold_exp.py races the two).  Non-sheared Q9
# geometries only (w % 16 == 0); sheared geometries keep the retile path.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fold_perm_np(w: int, pad: int, cbxg: int, inverse: bool):
    """One-hot for the parity-split de-interleave of packed chroma rows.

    Forward (w, 2*8*cbxg): packed col c = q*cw + c_int -> output col
    q*(8*cbxg) + (g % 8)*cbxg + g//8 with g = c_int + pad; padding/grid-tail
    output columns select nothing -> 0 (Q6 free, like _perm_np_interior).
    Inverse (2*8*cbxg, w): the transpose restricted to interior columns."""
    import numpy as np

    b = SAMPLE_BLOCK_SIZE
    cw = w // 2
    cols = 2 * b * cbxg
    c = np.arange(w)
    q, c_int = c // cw, c % cw
    g = c_int + pad
    tgt = q * (b * cbxg) + (g % b) * cbxg + g // b
    if inverse:
        m = np.zeros((cols, w), np.float32)
        m[tgt, c] = 1.0
    else:
        m = np.zeros((w, cols), np.float32)
        m[c, tgt] = 1.0
    return m


def fold_perm_device(w: int, pad: int, cbxg: int, inverse: bool):
    """Device operands for the packed-chroma fold dots (same (mat, bias)
    contract as tile_perm_device; pass as step arguments, not closures)."""
    return _perm_device(_fold_perm_np(w, pad, cbxg, inverse))


def packed_rows_to_chroma_tiles(region, pad: int, h: int, w: int, cby: int,
                                cbxg: int, perm):
    """Packed chroma rows (h/2, w) -> (2, 8, 8, cby, cbxg) tile-planes,
    bit-equal to region.reshape(2, ch, cw) -> interior_to_tiles(...), with
    the plane-split retile folded into the dot."""
    import jax
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    ch = h // 2
    packed_rows = cby * b // 2          # covered ext rows per plane / 2
    pad_packed = pad // 2
    reg3 = region.reshape(2, ch // 2, w)            # leading split: free
    bot = packed_rows - pad_packed - ch // 2        # covered bottom pad rows
    reg3 = jnp.pad(reg3, ((0, 0), (pad_packed, bot), (0, 0)))
    o = _onehot_dot(reg3, perm, 1)                  # (2, rows, 2*8*cbxg) i32
    # uint8 in the dot epilogue, held by a barrier (see interior_to_tiles)
    o = jax.lax.optimization_barrier(o.astype(jnp.uint8))
    # rows = (By, rh); minor flat = (q, c8, t).  r8 = 2*rh + q.
    o = o.reshape(2, cby, 4, 2, b, cbxg)
    o = o.transpose(0, 2, 3, 4, 1, 5)               # (pl, rh, q, c8, By, Bx)
    return o.reshape(2, b, b, cby, cbxg)            # merge (rh, q) -> r8


def chroma_tiles_to_packed_rows(tiles, pad: int, h: int, w: int, perm):
    """(2, 8, 8, cby, cbxg) filtered tile-planes -> packed chroma rows
    (h/2, w), bit-equal to tiles_to_interior(...) -> reshape(h/2, w), with
    the write-back retile folded into the dot."""
    import jax.numpy as jnp

    b = SAMPLE_BLOCK_SIZE
    ch = h // 2
    _, _, _, cby, cbxg = tiles.shape
    packed_rows = cby * b // 2
    pad_packed = pad // 2
    o = tiles.reshape(2, 4, 2, b, cby, cbxg)        # r8 -> (rh, q)
    o = o.transpose(0, 4, 1, 2, 3, 5)               # (pl, By, rh, q, c8, Bx)
    o = o.reshape(2, packed_rows, 2 * b * cbxg)     # rows=(By,rh); minor=(q,c8,t)
    o = o[:, pad_packed : pad_packed + ch // 2, :]  # interior rows BEFORE dot
    o = _onehot_dot(o, perm, 1)                     # (2, ch/2, w)
    return o.astype(jnp.uint8).reshape(h // 2, w)   # leading merge: free


def plane_to_tiles(plane):
    """(.., Hext, Wext) -> (.., 8, 8, By, Bx); T[.., r, c, by, bx] == plane[.., 8by+r, 8bx+c]."""
    b = SAMPLE_BLOCK_SIZE
    *lead, h, w = plane.shape
    if h % b or w % b:
        raise ValueError(f"extended plane dims must be multiples of {b}, got {h}x{w}")
    if _mxu_eligible(plane):
        return _plane_to_tiles_mxu(plane)
    n = len(lead)
    t = plane.reshape(*lead, h // b, b, w // b, b)
    # (.., By, r, Bx, c) -> (.., r, c, By, Bx)
    return t.transpose(*range(n), n + 1, n + 3, n + 0, n + 2)


def tiles_to_plane(tiles):
    """(.., 8, 8, By, Bx) -> (.., Hext, Wext). Inverse of plane_to_tiles."""
    b = SAMPLE_BLOCK_SIZE
    *lead, r, c, by, bx = tiles.shape
    if r != b or c != b:
        raise ValueError(f"expected leading tile dims ({b},{b}), got ({r},{c})")
    if _mxu_eligible(tiles):
        return _tiles_to_plane_mxu(tiles)
    n = len(lead)
    # (.., r, c, By, Bx) -> (.., By, r, Bx, c)
    t = tiles.transpose(*range(n), n + 2, n + 0, n + 3, n + 1)
    return t.reshape(*lead, by * b, bx * b)

"""Whole-frame deblocking over the tile-planes layout.

This replaces the reference's per-tile pointer-grid sweeps (the luma loop
cpu.h:146-448 and the chroma loops cpu.h:453-992, and equivalently the CUDA
kernels gpu.cu:535-1072) with four globally-vectorized phases of elementwise
ops on (By, Bx)-shaped tile planes:

  1. upper-vertical  edges: filter rows 0-3 across tile cols 3|4
  2. lower-vertical  edges: filter rows 4-7 across tile cols 3|4
  3. left-horizontal edges: filter cols 0-3 across tile rows 3|4 (transposed)
  4. right-horizontal edges: cols 4-7, with the reference's P/Q column
     mismatch (quirk Q3, cpu.h:383-433): P comes from cols 4-7 but Q from
     cols 0-3.

Phase order is load-bearing (quirk Q7): the horizontal phases read pixels the
vertical phases wrote, and phase 4 reads Q pixels phase 3 wrote.  Phases 1
and 2 are disjoint in reads and writes.  Because every segment is confined
to its own tile, each phase is an embarrassingly parallel map over the whole
tile grid -- the sequencing is *within* the pixel planes, applied here by
functional updates between phases.

Segment geometry (derived from the reference's pointer arithmetic, verified
bit-exact against it in tests/test_bitexact.py):

  upper-vert  p[r][j] = T[r,     3-j]   q[r][j] = T[r,     4+j]   (cpu.h:169-207)
  lower-vert  p[r][j] = T[4+r,   3-j]   q[r][j] = T[4+r,   4+j]   (cpu.h:233-271)
  left-hor    p[r][j] = T[3-j,   r  ]   q[r][j] = T[4+j,   r  ]   (cpu.h:302-364)
  right-hor   p[r][j] = T[3-j, 4+r  ]   q[r][j] = T[4+j,   r  ]   (cpu.h:383-445, Q3)

where r is the filter row (0-3), j the distance from the edge, and T[a, b]
the (By, Bx) plane of tile-local pixel (a, b).
"""

from __future__ import annotations

import jax.numpy as jnp

from .filters import chroma_edge_filter_planes, luma_edge_filter_planes
from ..utils.tiles import plane_to_tiles, split_covered, tiles_to_plane

# (p_coords, q_coords) per phase; entries are (tile_row, tile_col) as a
# function of filter row r and edge distance j.
_SEGMENT_GEOMETRY = {
    "upper_vert": (lambda r, j: (r, 3 - j), lambda r, j: (r, 4 + j)),
    "lower_vert": (lambda r, j: (4 + r, 3 - j), lambda r, j: (4 + r, 4 + j)),
    "left_hor": (lambda r, j: (3 - j, r), lambda r, j: (4 + j, r)),
    "right_hor": (lambda r, j: (3 - j, 4 + r), lambda r, j: (4 + j, r)),
}
_PHASE_ORDER = ("upper_vert", "lower_vert", "left_hor", "right_hor")


def _apply_phase(planes, phase, bs_mask, beta, tc, chroma, dtype):
    """Run one edge phase in place on the 8x8 list of (By, Bx) planes.

    Plane references are passed as nested lists straight into the filter
    core -- no stacked intermediates, so neither XLA nor the kernel ever
    materializes a (4, nj, By, Bx) relayout.
    """
    p_at, q_at = _SEGMENT_GEOMETRY[phase]
    nj = 2 if chroma else 4
    p = [[planes[p_at(r, j)[0]][p_at(r, j)[1]] for j in range(nj)] for r in range(4)]
    q = [[planes[q_at(r, j)[0]][q_at(r, j)[1]] for j in range(nj)] for r in range(4)]
    if chroma:
        new_p, new_q = chroma_edge_filter_planes(p, q, bs_mask, tc, dtype=dtype)
        touched = 1
    else:
        new_p, new_q = luma_edge_filter_planes(p, q, bs_mask, beta, tc, dtype=dtype)
        touched = 3
    for r in range(4):
        for j in range(touched):
            pr, pc = p_at(r, j)
            planes[pr][pc] = new_p[r][j]
            qr, qc = q_at(r, j)
            planes[qr][qc] = new_q[r][j]


def deblock_planes_core(planes, bs_maps, beta, tc, chroma=False, dtype=jnp.int32):
    """Core four-phase sweep on an 8x8 list-of-lists of (*B) int32 planes.

    Mutates and returns `planes`.  Shared verbatim between the XLA path
    (deblock_tiles) and the fused GPU kernel (ops/pallas_kernel.py), so
    the two are bit-identical by construction.
    """
    bs_gate = (lambda m: m == 2) if chroma else (lambda m: m > 0)
    for phase, bs in zip(_PHASE_ORDER, bs_maps):
        _apply_phase(planes, phase, bs_gate(bs), beta, tc, chroma, dtype)
    return planes


def deblock_tiles(tiles, bs_ver1, bs_ver2, bs_hor1, bs_hor2, beta, tc, chroma=False,
                  dtype=jnp.int32):
    """Deblock a tile-planes tensor.

    tiles: (8, 8, *B) integer array (any int dtype; compute is int32).
    bs_*: (*B) BS value per tile segment (see utils/bs.py).
    beta, tc: scalars.  chroma: use the 2-wide chroma filter and BS == 2 gate.
    Returns a new (8, 8, *B) tensor with the input's dtype.
    """
    out_dtype = tiles.dtype
    t = tiles.astype(dtype)
    planes = [[t[r, c] for c in range(8)] for r in range(8)]
    deblock_planes_core(planes, (bs_ver1, bs_ver2, bs_hor1, bs_hor2), beta, tc, chroma,
                        dtype=dtype)
    return jnp.stack([jnp.stack(row) for row in planes]).astype(out_dtype)


def deblock_plane(ext_plane, bs_maps, beta, tc, chroma=False, dtype=jnp.int32):
    """Deblock one extended plane (.., Hext, Wext) given its four (By, Bx) BS maps.

    Leading batch axes (e.g. the stacked {U, V} pair, or a frame batch) are
    folded into the tile-grid batch; BS maps broadcast across them.
    The plane is swept through the reference's flat (8*ncby, 8*ncbx) view
    (quirk Q9, utils/tiles.split_covered): sheared when the extended width
    is not a multiple of 8, with the flat remainder -- which can include
    real bottom chroma rows -- passing through untouched.
    """
    ext_plane, paste = split_covered(ext_plane)
    tiles = plane_to_tiles(ext_plane)  # (*lead, 8, 8, By, Bx)
    nlead = tiles.ndim - 4
    if nlead:
        # -> (8, 8, *lead, By, Bx): deblock_tiles wants tile coords leading
        perm = (nlead, nlead + 1, *range(nlead), nlead + 2, nlead + 3)
        tiles = tiles.transpose(perm)
    out = deblock_tiles(tiles, *bs_maps, beta, tc, chroma=chroma, dtype=dtype)
    if nlead:
        inv = (*range(2, 2 + nlead), 0, 1, nlead + 2, nlead + 3)
        out = out.transpose(inv)
    return paste(tiles_to_plane(out), jnp)


def deblock_frame(y_ext, u_ext, v_ext, luma_maps, chroma_maps, beta, tc, luma_only=False,
                  dtype=jnp.int32):
    """Full-frame luma + chroma deblock on extended planes (uint8 in/out).

    Mirrors ReadYuvFrame::DeblockingFilter's luma -> U -> V sequence
    (cpu.h:134-993); U and V are independent so they are batched into one
    chroma call along a leading axis.
    """
    y_out = deblock_plane(y_ext, luma_maps, beta, tc, chroma=False, dtype=dtype)
    if luma_only:
        return y_out, u_ext, v_ext
    uv = jnp.stack([u_ext, v_ext])
    uv_out = deblock_plane(uv, chroma_maps, beta, tc, chroma=True, dtype=dtype)
    return y_out, uv_out[0], uv_out[1]

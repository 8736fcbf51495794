"""Device-mesh parallelism: multi-stream / batched deblocking via shard_map.

The reference's only parallelism is intra-node (OpenMP over tile columns,
cpu.h:145; one CUDA thread per tile, gpu.cu:540-545) on a single device.
The scaling story exploits the same property that made those
race-free -- every tile is independent -- so distribution is pure data
parallelism with ZERO collectives:

  * axis "data":    frames of a batch / concurrent streams across chips
  * axis "spatial": tile-row slabs of each frame across chips (a single 4K
                    frame can be split row-wise; slabs are tile-aligned and
                    exact, no halo exchange is ever needed)

Geometry never has to divide the mesh: the tile grid is padded with no-op
tiles (zero pixels, BS = 0 -- exact identities) up to the spatial axis size,
then unpadded.  Chroma planes go through the reference's tile-swept flat
view (quirk Q9; utils/tiles.split_covered).

Communication cost: the only inter-chip traffic is the initial shard scatter
and final gather done by jit's sharding machinery over ICI; steady-state
filtering is fully local, which is the optimum for this workload (SURVEY.md
section 2, parallelism checklist).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.deblock import deblock_frame
from ..ops.tables import HALF_BLOCK
from ..utils.tiles import SAMPLE_BLOCK_SIZE as _B, split_covered


def make_mesh(n_data: int, n_spatial: int, devices=None) -> Mesh:
    """Build a ("data", "spatial") mesh from the first n_data*n_spatial devices."""
    devices = devices if devices is not None else jax.devices()
    need = n_data * n_spatial
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_data, n_spatial)
    return Mesh(arr, ("data", "spatial"))


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Split n devices into (data, spatial): largest power-of-two data axis
    that still leaves >= 2-way spatial sharding when possible."""
    if n_devices <= 1:
        return 1, 1
    n_data = 2 ** int(math.log2(n_devices) // 2) if (n_devices & (n_devices - 1)) == 0 else 1
    while n_devices % n_data:
        n_data //= 2
    return n_data, n_devices // n_data


def _pad_rows_to(plane_batch, maps, mult: int):
    """Pad tile-grid rows of (N, Hext, Wext) planes (and their (By, Bx) BS
    maps) with no-op tiles so By % mult == 0.  Returns (planes, maps, by)."""
    h = plane_batch.shape[-2]
    by = h // _B
    pad_tiles = (-by) % mult
    if pad_tiles:
        plane_batch = jnp.pad(plane_batch, ((0, 0), (0, pad_tiles * _B), (0, 0)))
        maps = tuple(jnp.pad(jnp.asarray(m), ((0, pad_tiles), (0, 0))) for m in maps)
    return plane_batch, maps, by


def deblock_batch_sharded(
    mesh: Mesh,
    y_batch,
    u_batch,
    v_batch,
    luma_maps,
    chroma_maps,
    beta,
    tc,
    luma_only: bool = False,
    backend: str = "jnp",
):
    """Deblock a batch of frames sharded over a ("data", "spatial") mesh.

    y_batch: (N, Hext, Wext) uint8; u/v: (N, cHext, cWext).  N must divide by
    the data axis; tile rows are padded to the spatial axis automatically.
    backend: "jnp" (XLA) or "pallas" -- each device runs the fused kernel on
    its local slab.  Returns filtered (y, u, v) batches with original shapes.
    """
    n_data = mesh.shape["data"]
    n_sp = mesh.shape["spatial"]
    if y_batch.shape[0] % n_data:
        raise ValueError(
            f"batch {y_batch.shape[0]} not divisible by data axis {n_data}"
        )

    # chroma planes go through the reference's tile-swept view (quirk Q9 --
    # flat buffer as an (8*ncby, 8*ncbx) image; see utils/tiles.split_covered),
    # sharded like any tile grid; the flat remainder is reattached afterwards.
    u_core, u_paste = split_covered(u_batch)
    v_core, v_paste = split_covered(v_batch)

    y_p, lmaps, by = _pad_rows_to(y_batch, luma_maps, n_sp)
    u_p, cmaps, cby = _pad_rows_to(u_core, chroma_maps, n_sp)
    v_p, _, _ = _pad_rows_to(v_core, chroma_maps, n_sp)

    plane_spec = P("data", "spatial", None)
    map_spec = P("spatial", None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(plane_spec, plane_spec, plane_spec,
                  (map_spec,) * 4, (map_spec,) * 4, P(), P()),
        out_specs=(plane_spec, plane_spec, plane_spec),
        # pallas_call outputs carry no varying-mesh-axes metadata in this
        # JAX version; the specs above fully describe the sharding anyway
        check_vma=False,
    )
    def _local(y, u, v, lm, cm, b, t):
        # each device deblocks its own tile-aligned slab; tiles are
        # self-contained so no halo/collective is needed
        if backend == "pallas":
            from ..ops.pallas_kernel import deblock_frame_pallas

            # fold the local frame batch into tile rows (frames and slabs are
            # tile-aligned, so row-concat is exact), run the fused kernel once
            n, hy, wy = y.shape
            nc, hc, wc = u.shape
            lm2 = tuple(jnp.concatenate([m] * n, axis=0) for m in lm)
            cm2 = tuple(jnp.concatenate([m] * n, axis=0) for m in cm)
            yo, uo, vo = deblock_frame_pallas(
                y.reshape(n * hy, wy), u.reshape(nc * hc, wc), v.reshape(nc * hc, wc),
                lm2, cm2, b, t, luma_only=luma_only,
            )
            return (yo.reshape(n, hy, wy), uo.reshape(nc, hc, wc), vo.reshape(nc, hc, wc))
        return deblock_frame(y, u, v, lm, cm, b, t, luma_only=luma_only)

    yo, uo, vo = _local(
        y_p, u_p, v_p, tuple(jnp.asarray(m) for m in lmaps),
        tuple(jnp.asarray(m) for m in cmaps),
        jnp.int32(beta), jnp.int32(tc),
    )
    yo = yo[:, : by * _B]
    uo, vo = uo[:, : cby * _B], vo[:, : cby * _B]
    return yo, u_paste(uo, jnp), v_paste(vo, jnp)


def _deblock_packed_frames_local(buf3, lm, cm, beta, tc, yperms, *, w, h,
                                 luma_only, luma_block, chroma_block,
                                 luma_grid, inplace):
    """Per-shard batched packed step via the FUSED relayout formulation:
    (n, 3h/2, w) packed YV12 frames in -> same shape filtered.

    This is the batched twin of the single-chip packed graph
    (models/streaming._deblock_yv12_packed_impl): the luma region is a
    tile-aligned leading row-slice of the 2-D packed view (free), the Q6
    zero padding / Pallas grid padding / interior write-back all fold into
    the one-hot relayout matmuls (utils.tiles.interior_to_tiles with a
    leading batch dim -- the dot's M axis just grows), frames ride the
    kernel's native leading batch axis (deblock_tiles_pallas grid dim 0)
    with ONE shared BS map, and only the per-frame chroma retile
    (h/2, w) <-> (2, ch, cw) is a paid copy, exactly as on one chip.

    Replaces the explicit pad -> extended-plane -> interior-slice ->
    concat formulation for the frames-parallel mesh case, whose layout
    passes measured ~2.0 ms/frame at 4K batch 4 vs the single-chip
    graph's 489 us (bench/capture_r5/multistream_1.json vs
    profile_4k.json).  Pallas backend + non-sheared Q9 geometries only
    (the caller gates); bit-exactness vs the golden oracle is enforced by
    tests/test_multistream.py."""
    from ..ops.pallas_kernel import deblock_tiles_pallas
    from ..utils.tiles import interior_to_tiles, tiles_to_interior

    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    n = buf3.shape[0]
    fwd, inv, cfwd, cinv = yperms if yperms is not None else (None,) * 4
    byg, bxg = luma_grid
    y = buf3[:, :h]  # (n, h, w): tile-aligned leading row slice, no copy
    yt = interior_to_tiles(y, p, perm=fwd, by_grid=byg, bx_grid=bxg)
    lm3 = [m[None] for m in lm]  # one shared map across the frame batch
    y_out = deblock_tiles_pallas(yt, *lm3, beta, tc, chroma=False)
    y_int = tiles_to_interior(y_out, p, h, w, perm=inv)  # (n, h, w)
    parts = [(0, y_int)]
    if not luma_only:
        from ..models.streaming import _chroma_grid_bx

        cbxg = _chroma_grid_bx(w, chroma_block)
        uv = buf3[:, h:].reshape(n, 2, ch, cw)  # per-frame chroma retile
        uvt = interior_to_tiles(uv, p, perm=cfwd, bx_grid=cbxg)
        cm3 = [m[None] for m in cm]  # shared across frames AND U/V
        uv_out = deblock_tiles_pallas(uvt.reshape(n * 2, *uvt.shape[2:]),
                                      *cm3, beta, tc, chroma=True)
        uv_int = tiles_to_interior(uv_out.reshape(n, 2, *uv_out.shape[1:]),
                                   p, ch, cw, perm=cinv)  # (n, 2, ch, cw)
        parts.append((h, uv_int.reshape(n, h // 2, w)))
    # batched _pack_out (models/streaming): row offsets index axis 1
    if inplace:
        out = buf3
        for off, seg in parts:
            out = jax.lax.dynamic_update_slice(out, seg, (0, off, 0))
        return out
    segs, pos = [], 0
    for off, seg in parts:
        if off > pos:
            segs.append(buf3[:, pos:off])
        segs.append(seg)
        pos = off + seg.shape[1]
    if pos < buf3.shape[1]:
        segs.append(buf3[:, pos:])
    return jnp.concatenate(segs, axis=1) if len(segs) > 1 else segs[0]


def deblock_packed_batch_sharded(mesh, buf, luma_maps, chroma_maps, beta, tc,
                                 yperms=None, *, w, h, luma_only=False,
                                 backend="jnp", luma_block=None,
                                 chroma_block=None, luma_grid=None):
    """Packed sharded full graph: (N, 3h/2, w) raw YV12 batch in (the 2-D
    per-frame packed view -- same bytes as the flat file order) -> filtered
    (N, 3h/2, w) batch out, everything between the DMAs on device.

    This is the mesh twin of the single-chip packed graph
    (models/streaming._deblock_yv12_packed_impl): plane split, Q6 zero
    extension padding, the sharded deblock, interior slicing and output
    repack all run inside ONE jit, so the host ships exactly the packed
    bytes (one H2D per step) and gets exactly the packed bytes back --
    never the ~1.35x extended planes, and never a host-side np.pad.  The
    reference's pinned-memory copies (gpu.cu:1248-1256) shipped extended
    planes per frame; ours ships the minimal transfer, like everywhere
    else in this repo.

    Two formulations:
    * frames-parallel FAST path (pallas backend, non-sheared Q9 geometry,
      N a multiple of the device count, relayout perms supplied): frames
      shard over the flattened ("data", "spatial") axes and each device
      runs _deblock_packed_frames_local -- the fused-relayout single-chip
      formulation with a leading batch dim.  Steady state has ZERO
      collectives (whole frames never leave their chip).
    * fallback (jnp backend, sheared geometries, or N not divisible):
      explicit pads to extended planes + the tile-row-slab sharded filter
      (deblock_batch_sharded) + interior slicing.  Correct everywhere;
      pays the extended-plane layout passes the fast path folds away."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    n = buf.shape[0]
    ndev = mesh.devices.size
    chroma_fused = (cw + 2 * p) % _B == 0
    fast = (backend == "pallas"
            and luma_grid is not None and n % ndev == 0
            and (chroma_fused or luma_only))
    if fast:
        spec = P(("data", "spatial"), None, None)
        local = functools.partial(
            _deblock_packed_frames_local, w=w, h=h, luma_only=luma_only,
            luma_block=luma_block, chroma_block=chroma_block,
            luma_grid=luma_grid, inplace=True)
        if yperms is None:  # transpose relayout: no one-hot operands
            local = functools.partial(local, yperms=None)
            args, specs = (), ()
        else:
            args, specs = (tuple(yperms),), (P(),)
        fn = jax.shard_map(local, mesh=mesh,
                           in_specs=(spec, P(), P(), P(), P()) + specs,
                           out_specs=spec, check_vma=False)
        return fn(buf, tuple(luma_maps), tuple(chroma_maps), beta, tc, *args)
    pad = ((0, 0), (p, p), (p, p))
    q = h + h // 4
    y = jnp.pad(buf[:, :h], pad)
    u = jnp.pad(buf[:, h:q].reshape(n, ch, cw), pad)
    v = jnp.pad(buf[:, q:].reshape(n, ch, cw), pad)
    yo, uo, vo = deblock_batch_sharded(mesh, y, u, v, luma_maps, chroma_maps,
                                       beta, tc, luma_only=luma_only,
                                       backend=backend)
    return jnp.concatenate([
        yo[:, p : p + h, p : p + w],
        uo[:, p : p + ch, p : p + cw].reshape(n, h // 4, w),
        vo[:, p : p + ch, p : p + cw].reshape(n, h // 4, w),
    ], axis=1)


@functools.lru_cache(maxsize=32)
def _packed_sharded_jit(mesh: Mesh, w: int, h: int, luma_only: bool,
                        backend: str, luma_block, chroma_block, luma_grid,
                        donate: bool):
    f = functools.partial(deblock_packed_batch_sharded, mesh,
                          w=w, h=h, luma_only=luma_only, backend=backend,
                          luma_block=luma_block, chroma_block=chroma_block,
                          luma_grid=luma_grid)
    # donate=True (callers feeding fresh per-step ingest buffers): the fast
    # path's in-place segment writes alias output to input, so the output
    # concat pass disappears, like StreamingDeblocker._step
    return jax.jit(f, donate_argnums=(0,) if donate else ())


def deblock_packed_batch_sharded_jit(mesh, buf, *args, w, h, luma_only=False,
                                     backend="jnp", luma_block=None,
                                     chroma_block=None, luma_grid=None,
                                     donate=False):
    """jit-wrapped packed sharded graph (compiles once per geometry/mesh)."""
    return _packed_sharded_jit(mesh, w, h, luma_only, backend, luma_block,
                               chroma_block, luma_grid, donate)(buf, *args)


def packed_batch_sharding(mesh: Mesh, n_frames: int, h: int) -> NamedSharding:
    """Input sharding for a packed (N, 3h/2, w) batch: whole frames across
    the flattened device grid when the grid divides N (the frames-parallel fast
    path -- each frame's bytes land on exactly the chip that filters them,
    zero steady-state traffic); otherwise frames across "data" with packed
    ROWS across "spatial" when that divides -- the total host->HBM volume
    is exactly the packed bytes either way (each byte lands on one chip;
    GSPMD redistributes row slabs into tile-row slabs over ICI, which is
    orders of magnitude faster than the host wire)."""
    if n_frames % mesh.devices.size == 0:
        return NamedSharding(mesh, P(("data", "spatial"), None, None))
    if "spatial" in mesh.shape and (3 * h // 2) % mesh.shape["spatial"] == 0:
        return NamedSharding(mesh, P("data", "spatial", None))
    return NamedSharding(mesh, P("data"))


@functools.lru_cache(maxsize=32)
def _sharded_jit(mesh: Mesh, luma_only: bool, backend: str):
    # one cached jit per (mesh, options); calling jax.jit afresh on every
    # invocation would defeat the compile cache and retrace each step
    return jax.jit(
        functools.partial(deblock_batch_sharded, mesh, luma_only=luma_only,
                          backend=backend)
    )


def deblock_batch_sharded_jit(mesh, *args, luma_only=False, backend="jnp"):
    """jit-wrapped sharded batch deblock (compiles once per geometry/mesh)."""
    return _sharded_jit(mesh, luma_only, backend)(*args)

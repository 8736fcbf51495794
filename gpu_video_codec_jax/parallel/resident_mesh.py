"""Mesh-sharded device-resident streaming: the multi-chip steady state.

Combines the two strongest pieces of the framework:

  * models/resident.py -- frames stay on device in canonical tile-planes
    layout, so the per-step graph is exactly the fused Pallas kernels; and
  * the tile-independence property (SURVEY.md section 1) that makes
    distribution pure data parallelism with ZERO collectives.

A batched TileFrame's leading frame axis is sharded over the mesh's "data"
axis; each chip runs the batched fused kernels on its local frames
(shard_map), so the multi-chip steady state is N_chips x the single-chip
kernel-only rate with no inter-chip traffic at all after the initial shard
scatter.  The reference has no analogue -- its GPU path is single-device
and re-uploads per frame unconditionally (gpu.cu:1248-1298).

Usage:
    mrd = MeshResidentDeblocker(mesh, w, h, qp)
    state = mrd.ingest(frames)        # (n, 3wh/2) batch, n % n_data == 0
    state = mrd.step(state)           # kernels only, all chips in parallel
    out = mrd.readback(state)         # (n, 3wh/2) filtered batch

Bit-exactness: each local shard runs the same batched kernels as the
single-chip path, so mesh output == per-frame output by construction;
tests/test_mesh.py asserts it against the golden oracle anyway.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.resident import TileFrame, _ingest, _readback, _step_core
from ..utils.bs import BoundaryStrength


@functools.lru_cache(maxsize=32)
def _mesh_step(mesh: Mesh, n_steps: int, luma_only: bool, lb, cb):
    """One cached jit per (mesh, chain length, options)."""
    spec5 = P("data", None, None, None, None)
    tf_specs = TileFrame(spec5, spec5, P("data", None), P("data", None))
    map_spec = P(None, None)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(tf_specs, (map_spec,) * 4, (map_spec,) * 4, P(), P()),
        out_specs=tf_specs,
        # pallas_call outputs carry no varying-mesh-axes metadata in this
        # JAX version; the specs above fully describe the sharding anyway
        check_vma=False,
    )
    def _local(tf, lm, cm, beta, tc):
        # local (n/n_data)-frame batch through the batched fused kernels;
        # tiles are self-contained, so no halo/collective is ever needed
        if n_steps == 1:
            return _step_core(tf, lm, cm, beta, tc, luma_only, lb, cb)
        return jax.lax.fori_loop(
            0, n_steps,
            lambda _, t: _step_core(t, lm, cm, beta, tc, luma_only, lb, cb),
            tf,
        )

    return jax.jit(_local)


class MeshResidentDeblocker:
    """Device-resident deblocking of frame batches sharded over a mesh.

    Shards over the mesh's "data" axis (frames across chips); any mesh with
    a "data" axis works, including the ("data", "spatial") meshes from
    parallel.mesh.make_mesh (the spatial axis is simply not used here --
    resident state shards by whole frames).
    """

    def __init__(self, mesh: Mesh, width: int, height: int, qp: int, *,
                 luma_only: bool = False, bs: BoundaryStrength | None = None,
                 luma_block: tuple[int, int] | None = None,
                 chroma_block: tuple[int, int] | None = None):
        from ..models.resident import ResidentDeblocker

        if "data" not in mesh.shape:
            raise ValueError('mesh must have a "data" axis')
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        kwargs = {}
        if luma_block is not None:
            kwargs["luma_block"] = luma_block
        if chroma_block is not None:
            kwargs["chroma_block"] = chroma_block
        # reuse the single-chip component for geometry, BS maps and relayout
        # operands; this class only adds the sharding story
        self._rd = ResidentDeblocker(width, height, qp, luma_only=luma_only,
                                     bs=bs, **kwargs)
        self.width, self.height, self.qp = width, height, int(qp)
        self.frame_bytes = self._rd.frame_bytes
        self._batch_sharding = NamedSharding(mesh, P("data"))
        # replicate the constant operands (BS maps, relayout one-hots, beta/tc)
        # over the mesh: arrays committed to one device can't mix with
        # mesh-sharded args in a jitted computation.  Uses the ResidentDeblocker
        # operand contract (StepOperands) -- no reach into its internals.
        rep = NamedSharding(mesh, P())
        self._put_rep = put = (
            lambda t: jax.tree.map(lambda a: jax.device_put(a, rep), t))
        self._rd.install_operands(put(self._rd.operands))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Swap in new BS arrays mesh-wide (no recompile; maps are step args)."""
        rd = self._rd
        rd.update_boundary_strength(bs)
        ops = rd.operands  # re-place only the refreshed BS maps; the relayout
        rd.install_operands(ops._replace(  # one-hots are already mesh-resident
            lm=self._put_rep(ops.lm), cm=self._put_rep(ops.cm)))

    def ingest(self, frames) -> TileFrame:
        """Host frame batch -> mesh-sharded TileFrame.

        frames: list/tuple of packed frames or an (n, 3wh/2) uint8 array;
        n must divide by the mesh's data axis."""
        rd = self._rd
        if isinstance(frames, jax.Array):
            buf = frames
        else:
            if isinstance(frames, (list, tuple)):
                arr = np.stack([rd.host_buf(f) for f in frames])
            else:
                arr = rd.host_buf(frames)
            if arr.ndim != 2:
                raise ValueError("mesh ingest needs a BATCH of frames")
            buf = jax.device_put(arr, self._batch_sharding)
        if buf.shape[0] % self.n_data:
            raise ValueError(
                f"batch {buf.shape[0]} not divisible by data axis {self.n_data}")
        ops = rd.operands
        lb, cb = rd.block_shapes
        # the relayout graph is per-frame elementwise over the batch, so the
        # GSPMD partitioner keeps the batch sharding end to end
        return _ingest(buf, rd.width, rd.height, lb, cb,
                       ops.yperm_f, ops.cperm_f, fused=rd.chroma_fused)

    def step(self, tf: TileFrame, n_steps: int = 1) -> TileFrame:
        """n_steps kernel-only deblock passes on every chip in parallel."""
        rd = self._rd
        ops = rd.operands
        fn = _mesh_step(self.mesh, int(n_steps), rd.luma_only, *rd.block_shapes)
        return fn(tf, ops.lm, ops.cm, ops.beta, ops.tc)

    def readback(self, tf: TileFrame) -> np.ndarray:
        """Mesh-sharded TileFrame -> (n, 3wh/2) filtered batch on the host."""
        rd = self._rd
        ops = rd.operands
        return jax.device_get(_readback(tf, rd.width, rd.height,
                                        ops.yperm_i, ops.cperm_i,
                                        fused=rd.chroma_fused))

    def __call__(self, frames) -> np.ndarray:
        return self.readback(self.step(self.ingest(frames)))

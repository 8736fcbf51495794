"""Multi-stream deblocking over a device mesh (BASELINE config 5).

Wraps parallel/mesh.py's PACKED sharded graph in a streaming interface: N
concurrent YV12 streams (e.g. N cameras or N transcode jobs) are zipped into
per-step (N, 3h/2, w) packed batches (the 2-D per-frame packed view -- same
bytes as the flat file order), shipped host->HBM as ONE DMA per step (the
wire carries exactly the packed bytes), then split/padded/filtered/repacked
entirely on device and returned per stream.  When the device count
divides N (pallas backend, non-sheared Q9 geometry) whole frames shard over the
flattened device grid and each chip runs the fused-relayout single-chip
packed formulation on its local frame batch -- zero steady-state
collectives; otherwise frames ride "data" and tile-row slabs "spatial".
Copy/compute overlap matches the single-chip pipeline:
run() keeps `depth` batches in flight through JAX's async dispatch queue, so
batch i+1's host prep + H2D proceed under batch i's kernels and only the
oldest batch is drained per step (steady state = max(copy, compute) per
batch, not copy + compute -- the serialized copy->kernel->copy of the
reference's ExecuteGpu, gpu.cu:1248-1298, is the anti-pattern; its pinned
copies also shipped the ~1.35x extended planes, gpu.cu:1094-1132, where this
path ships the minimal packed buffer and pads on device).

The reference has no distributed analogue (single GPU, single stream,
gpu.cu:1230-1306); this is the scaling story for its hypothetical
multi-stream usage (SURVEY.md section 2, parallelism checklist).
"""

from __future__ import annotations

from collections import deque
from collections.abc import Iterable, Iterator, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import deblock_packed_batch_sharded_jit, packed_batch_sharding
from ..ops.pallas_kernel import BLOCK_BX, BLOCK_BY, CHROMA_BLOCK
from ..ops.tables import HALF_BLOCK, SAMPLE_BLOCK_SIZE, get_beta, get_tc
from ..utils.bs import BoundaryStrength, chroma_segment_maps, luma_segment_maps
from ..utils.tiles import relayout_engine, tile_perm_device
from ..utils.yuv import check_dims


class MultiStreamDeblocker:
    """Deblocks N same-geometry YV12 streams across a device mesh.

    mesh: a ("data", "spatial") Mesh (parallel.make_mesh).  The number of
    streams must be a multiple of the data axis.  Frames are raw packed
    YV12 buffers (bytes or uint8 arrays of 3*w*h/2).
    depth: sharded batches in flight during run() (2 = double buffering).
    """

    def __init__(self, mesh, n_streams: int, width: int, height: int, qp: int,
                 *, backend: str = "jnp", luma_only: bool = False,
                 bs: BoundaryStrength | None = None, depth: int = 2):
        check_dims(width, height)
        if n_streams % mesh.shape["data"]:
            raise ValueError(
                f"n_streams {n_streams} must divide by the data axis {mesh.shape['data']}"
            )
        self.mesh = mesh
        self.n = n_streams
        self.width, self.height = width, height
        self.frame_bytes = 3 * width * height // 2
        self.backend = backend
        self.luma_only = luma_only
        self.depth = max(1, depth)
        # replicate the constant step operands over the mesh once (a fresh
        # host array per step would re-upload the maps every dispatch)
        rep = NamedSharding(mesh, P())
        self.update_boundary_strength(
            bs or BoundaryStrength.intra_default(width, height))
        self._beta = jax.device_put(jnp.int32(get_beta(qp)), rep)
        self._tc = jax.device_put(jnp.int32(get_tc(qp)), rep)
        self._in_sharding = packed_batch_sharding(mesh, n_streams, height)
        # frames-parallel fast path (mesh.deblock_packed_batch_sharded):
        # pallas + non-sheared Q9 + N divisible by the device count -- the
        # fused-relayout single-chip formulation with a leading batch dim.
        # Perms live replicated in HBM once (as closure constants XLA would
        # regenerate the multi-MB matrices on device each step).
        self._luma_block = (BLOCK_BY, BLOCK_BX)
        self._chroma_block = CHROMA_BLOCK
        chroma_fused = ((width // 2 + 2 * HALF_BLOCK) % SAMPLE_BLOCK_SIZE == 0
                        and not luma_only)
        self._frames_fast = (backend == "pallas"
                             and (chroma_fused or luma_only)
                             and n_streams % mesh.devices.size == 0)
        self._luma_grid = self._yperms = None
        if self._frames_fast:
            from ..models.streaming import _chroma_grid_bx, luma_grid_shape

            self._luma_grid = luma_grid_shape(width, height, self._luma_block)
        if self._frames_fast and relayout_engine() == "mxu":
            bxg = self._luma_grid[1]
            perms = [tile_perm_device(width, HALF_BLOCK, False, bxg),
                     tile_perm_device(width, HALF_BLOCK, True, bxg)]
            if chroma_fused:
                cbxg = _chroma_grid_bx(width, self._chroma_block)
                perms += [tile_perm_device(width // 2, HALF_BLOCK, False, cbxg),
                          tile_perm_device(width // 2, HALF_BLOCK, True, cbxg)]
            else:
                perms += [None, None]
            self._yperms = jax.tree.map(lambda a: jax.device_put(a, rep),
                                        tuple(perms))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install new BS arrays mesh-wide mid-stream (the SetBoundaryStrenght
        story, cpu.h:120-132; no recompile -- maps are step arguments)."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        rep = NamedSharding(self.mesh, P())
        self._lm = tuple(jax.device_put(jnp.asarray(m), rep)
                         for m in luma_segment_maps(bs))
        self._cm = tuple(jax.device_put(jnp.asarray(m), rep)
                         for m in chroma_segment_maps(bs))

    def _stack(self, raws: Sequence) -> np.ndarray:
        """Validate and stack N packed frames to one (N, 3h/2, w) buffer
        (the 2-D per-frame packed view -- same bytes as the flat file
        order; a host-side reshape of the stacked rows, no copy beyond the
        stack itself) -- no plane splitting and NO padding on the host
        (both happen on device inside the sharded jit, parallel/mesh.py
        deblock_packed_batch_sharded), the same 2-D row view as the
        single-card packed step (models/streaming)."""
        rows = []
        for raw in raws:
            arr = (np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray))
                   else np.asarray(raw, np.uint8).ravel())
            if arr.size != self.frame_bytes:
                raise ValueError(f"frame must be {self.frame_bytes} bytes, got {arr.size}")
            rows.append(arr)
        return np.stack(rows).reshape(self.n, 3 * self.height // 2, self.width)

    def _dispatch(self, raws: Sequence):
        """Enqueue one sharded batch WITHOUT draining: ONE packed H2D (frames
        across "data", frame bytes across "spatial" -- total wire volume is
        exactly the packed bytes), then the on-device split/pad/filter/repack
        graph, still in flight behind JAX's async dispatch queue."""
        if len(raws) != self.n:
            raise ValueError(f"expected {self.n} frames (one per stream), got {len(raws)}")
        buf = jax.device_put(self._stack(raws), self._in_sharding)
        return deblock_packed_batch_sharded_jit(
            self.mesh, buf, self._lm, self._cm, self._beta, self._tc,
            self._yperms,
            w=self.width, h=self.height,
            luma_only=self.luma_only, backend=self.backend,
            luma_block=self._luma_block, chroma_block=self._chroma_block,
            luma_grid=self._luma_grid,
            # fresh per-step ingest buffer: donate so the fast path's
            # in-place segment writes alias output to input (the fallback's
            # concat output can't alias -- skip the donation warning there)
            donate=self._frames_fast,
        )

    def _drain(self, handle) -> list[np.ndarray]:
        """Block on one in-flight batch: a single packed (N, 3wh/2) D2H
        (flat per-stream views of the (N, 3h/2, w) device buffer)."""
        out = jax.device_get(handle)
        return [out[i].reshape(-1) for i in range(self.n)]

    def step(self, raws: Sequence) -> list[np.ndarray]:
        """One synchronous sharded batch step: one frame per stream in,
        filtered packed frames out (in stream order).  For overlapped
        multi-batch throughput use run() -- step() fully drains."""
        return self._drain(self._dispatch(raws))

    def run_batches(self, batches: Iterable[Sequence]) -> Iterator[list[np.ndarray]]:
        """Overlapped core: consume an iterable of n_streams-frame batches,
        keeping `depth` sharded batches in flight -- batch i+1's host prep
        and H2D ride under batch i's kernels, and draining lags dispatch by
        depth-1 batches (real cross-step copy/compute overlap, unlike a
        serial step() loop)."""
        inflight: deque = deque()
        for raws in batches:
            inflight.append(self._dispatch(raws))
            if len(inflight) >= self.depth:
                yield self._drain(inflight.popleft())
        while inflight:
            yield self._drain(inflight.popleft())

    def run(self, streams: Sequence[Iterable]) -> Iterator[list[np.ndarray]]:
        """Zip N frame iterables; yield one list of filtered frames (one per
        stream) per overlapped step until the shortest stream ends."""
        if len(streams) != self.n:
            raise ValueError(f"expected {self.n} streams, got {len(streams)}")
        return self.run_batches(list(raws) for raws in zip(*streams))

"""Device-resident, layout-persistent streaming: tile-planes end to end.

The per-frame cost of the standard streaming path (models/streaming.py) is
dominated not by the fused deblock kernel but by the layout contract around
it -- packed YV12 bytes in, packed YV12 bytes out -- and its relayout
passes (PERF.md has the split by layer).  For a pipeline whose frames
*stay on device between stages* (a codec loop, a transcode graph, a filter
chain), those transposes are pure overhead: the producer can hand this stage
tile-planes directly and the consumer can keep them.

This module makes the canonical device layout -- (8, 8, By, Bx) tile-planes,
grid pre-padded to the callers' block layout -- a first-class streaming
state:

  ingest(raw)    one host->HBM DMA + one relayout pass     (once per frame)
  step(state)    the fused deblock kernels and NOTHING else (the steady state)
  readback(st)   one relayout pass + one device->host DMA  (only at the sink)

so an on-device consumer pays layout cost once at the pipeline boundary, and
the steady-state deblock step is kernel-only.

Reference parity: the reference has no analogue -- its GPU path re-uploads,
re-launches, and re-downloads per frame unconditionally (gpu.cu:1248-1298).
This removes that structural waste.

Quirk handling is identical to every other path: chroma sweeps the flat
(8*ncby, 8*ncbx) view (Q9, utils/tiles.split_covered_data) with the
uncovered flat remainder carried through the state untouched; grid padding
tiles are zero pixels with BS = 0, i.e. exact no-ops (Q5 done right).
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.pallas_kernel import (
    BLOCK_BX, BLOCK_BY, CHROMA_BLOCK, deblock_tiles_pallas,
)
from ..ops.tables import HALF_BLOCK, get_beta, get_tc
from ..utils.bs import BoundaryStrength, chroma_segment_maps, luma_segment_maps
from ..utils.tiles import (
    SAMPLE_BLOCK_SIZE as _B,
    interior_to_tiles,
    join_covered,
    plane_to_tiles,
    split_covered_data,
    tiles_to_interior,
    tiles_to_plane,
)
from ..utils.yuv import check_dims


class StepOperands(NamedTuple):
    """The device operands a ResidentDeblocker's jitted graphs consume -- the
    public contract for sharded wrappers (parallel/resident_mesh.py) that need
    to re-place these arrays (e.g. replicate them over a mesh) without
    touching ResidentDeblocker internals.

    A plain pytree: `jax.tree.map(put, ops)` re-places every leaf; hand the
    result to ResidentDeblocker.install_operands().  cperm_f/cperm_i are None
    on sheared (Q9, w % 16 == 8) geometries, where chroma relayout cannot ride
    the fused one-hot path.
    """

    lm: tuple        # 4 padded luma segment BS maps, (Byp, Bxp) uint8
    cm: tuple        # 4 padded chroma maps (U over V stacked), (2cByp, cBxp)
    beta: jax.Array  # int32 scalar (QP-derived, ops/tables.py)
    tc: jax.Array    # int32 scalar
    yperm_f: tuple   # forward luma relayout operands (utils.tiles.tile_perm_device)
    yperm_i: tuple   # inverse luma relayout operands
    cperm_f: tuple | None  # forward chroma operands (None when sheared)
    cperm_i: tuple | None  # inverse chroma operands


class TileFrame(NamedTuple):
    """Device-resident frame state (a jit-friendly pytree).

    y:  (8, 8, Byp, Bxp) uint8 luma tile-planes, grid padded to the
        layout's block shape with no-op tiles.
    uv: (8, 8, 2*cBy (padded), cBxp) uint8 -- U and V covered-core tile grids
        concatenated along By (one fused chroma launch per step).
    u_rem / v_rem: flat uncovered remainder of the extended chroma planes
        (quirk Q9); never touched by the filter, carried for exact readback.
        Zero-size on non-sheared geometries (the fused chroma path -- the
        remainder is then pure bottom padding that readback regenerates).
    """

    y: jax.Array
    uv: jax.Array
    u_rem: jax.Array
    v_rem: jax.Array


def _pad_to(x, by, bx):
    """Zero-pad the trailing (By, Bx) axes up to multiples of (by, bx):
    no-op tiles (zero pixels, BS 0) that fill the grid layout."""
    pb = (-x.shape[-2]) % by
    px = (-x.shape[-1]) % bx
    if pb == 0 and px == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 2) + [(0, pb), (0, px)]
    return jnp.pad(x, pad)


def _effective_block(block: tuple[int, int], by: int, bx: int) -> tuple[int, int]:
    """The grid-layout block after effective_block_bx's clamp (and its cheap
    128-column alignment), so ingest pads the grid the same way as the
    streaming and mesh layouts."""
    from ..ops.pallas_kernel import effective_block_bx

    return (min(block[0], -(-by // 8) * 8), effective_block_bx(block[1], bx))


@functools.partial(jax.jit, static_argnames=("w", "h", "lb", "cb", "fused"))
def _ingest(buf, w, h, lb, cb, yperm=None, cperm=None, fused=True):
    """Packed YV12 uint8 (.., 3wh/2) -> TileFrame, one relayout pass.

    A leading batch axis carries through every field (the fused kernels run
    the batch as a grid dimension).  Luma goes interior -> grid-padded
    tile-planes directly (utils.tiles.interior_to_tiles: the Q6 zero
    padding and the grid padding happen in the same relayout).  Chroma does
    the same when `fused` (the non-sheared Q9 case: the covered flat view
    IS the extended plane, and U+V batch through one relayout); sheared
    geometries keep explicit extended planes with the covered split,
    because the Q9 flat view is defined on the padded buffer.  yperm/cperm
    are the one-hot operands of the mxu relayout engine, or None."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    lead = buf.shape[:-1]
    n = len(lead)

    by, bx = (h + 2 * p) // _B, (w + 2 * p) // _B
    eby, ebx = _effective_block(lb, by, bx)
    yt = interior_to_tiles(buf[..., : w * h].reshape(*lead, h, w), p, perm=yperm,
                           by_grid=-(-by // eby) * eby,
                           bx_grid=-(-bx // ebx) * ebx)

    if fused:
        cby, cbx = (ch + 2 * p) // _B, (cw + 2 * p) // _B
        cbxg = -(-cbx // cb[1]) * cb[1]  # lane-aligned grid, folded into perm
        t = interior_to_tiles(buf[..., w * h :].reshape(*lead, 2, ch, cw),
                              p, perm=cperm, bx_grid=cbxg)
        t = jnp.moveaxis(t, n, n + 2)          # (.., 8, 8, 2, cby, cbxg)
        uv = t.reshape(*lead, _B, _B, 2 * cby, cbxg)
        rem = jnp.zeros((*lead, 0), jnp.uint8)
        uv = _pad_to(uv, *cb)  # row padding only; columns already at grid
        return TileFrame(yt, uv, rem, rem)

    cpad = [(0, 0)] * n + [(p, p), (p, p)]
    u = jnp.pad(buf[..., w * h : w * h + cw * ch].reshape(*lead, ch, cw), cpad)
    v = jnp.pad(buf[..., w * h + cw * ch :].reshape(*lead, ch, cw), cpad)
    u_core, u_rem = split_covered_data(u)
    v_core, v_rem = split_covered_data(v)
    uv = jnp.concatenate([plane_to_tiles(u_core), plane_to_tiles(v_core)], axis=-2)
    uv = _pad_to(uv, *_effective_block(cb, uv.shape[-2], uv.shape[-1]))
    return TileFrame(yt, uv, u_rem, v_rem)


@functools.partial(jax.jit, static_argnames=("w", "h", "fused"))
def _readback(tf: TileFrame, w, h, yperm=None, cperm=None, fused=True):
    """TileFrame -> filtered packed YV12 uint8 (.., 3wh/2), one relayout pass."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    chext, cwext = ch + 2 * p, cw + 2 * p
    # covered chroma grid dims (truncating division, Q9 / cpu.h:450-451)
    cby, cbx = chext // _B, cwext // _B
    lead = tf.y.shape[:-4]
    n = len(lead)

    y_int = tiles_to_interior(tf.y, p, h, w, perm=yperm)
    if fused:  # non-sheared chroma (see _ingest)
        cbxg = tf.uv.shape[-1]
        t = tf.uv[..., : 2 * cby, :].reshape(*lead, _B, _B, 2, cby, cbxg)
        t = jnp.moveaxis(t, n + 2, n)          # (.., 2, 8, 8, cby, cbxg)
        uv_int = tiles_to_interior(t, p, ch, cw, perm=cperm)
        return jnp.concatenate([
            y_int.reshape(*lead, h * w),
            uv_int.reshape(*lead, 2 * ch * cw),
        ], axis=-1)
    u_core = tiles_to_plane(tf.uv[..., :cby, :cbx])
    v_core = tiles_to_plane(tf.uv[..., cby : 2 * cby, :cbx])
    u = join_covered(u_core, tf.u_rem, chext, cwext, jnp)
    v = join_covered(v_core, tf.v_rem, chext, cwext, jnp)
    return jnp.concatenate([
        y_int.reshape(*lead, h * w),
        u[..., p : p + ch, p : p + cw].reshape(*lead, ch * cw),
        v[..., p : p + ch, p : p + cw].reshape(*lead, ch * cw),
    ], axis=-1)


def _step_core(tf: TileFrame, lm, cm, beta, tc, luma_only, lb, cb):
    """The steady state: fused deblock kernels only, zero layout work.

    The graph is exactly two kernel launches (one with luma_only).  A
    batched TileFrame (leading frame axis) runs the batch as the kernels'
    outermost grid dimension with ONE shared BS map."""
    if tf.y.ndim == 5:  # batched: share one map across the frame batch
        lm = tuple(m[None] for m in lm)
        cm = tuple(m[None] for m in cm)
    y = deblock_tiles_pallas(tf.y, *lm, beta, tc, chroma=False)
    if luma_only:
        return TileFrame(y, tf.uv, tf.u_rem, tf.v_rem)
    uv = deblock_tiles_pallas(tf.uv, *cm, beta, tc, chroma=True)
    return TileFrame(y, uv, tf.u_rem, tf.v_rem)


_step = functools.partial(jax.jit, static_argnames=("luma_only", "lb", "cb"))(_step_core)


@functools.partial(jax.jit, static_argnames=("n", "luma_only", "lb", "cb"))
def _step_n(tf: TileFrame, lm, cm, beta, tc, n, luma_only, lb, cb):
    """n chained resident steps in ONE dispatch (lax.fori_loop).

    A single dispatch over an n-step on-device chain takes host dispatch
    out of a wall-clock bracket, like the reference's CUDA-event 'without
    copy' bracket (gpu.cu:1264-1294).  Also a real API: n filter passes
    for stacked-stage pipelines without touching the host."""
    return jax.lax.fori_loop(
        0, n, lambda _, t: _step_core(t, lm, cm, beta, tc, luma_only, lb, cb), tf
    )


class ResidentDeblocker:
    """Deblocks frames that live on device in tile-planes layout.

    Usage (device-resident pipeline):
        rd = ResidentDeblocker(w, h, qp)
        state = rd.ingest(raw_yv12)      # boundary: host -> canonical layout
        state = rd.step(state)           # kernel-only; chain with other
        ...                              #   tile-planes stages freely
        out = rd.readback(state)         # boundary: canonical layout -> host

    One-shot convenience: rd(raw) == readback(step(ingest(raw))), which is
    bit-identical to DeblockPipeline/StreamingDeblocker on the same frame.
    """

    def __init__(self, width: int, height: int, qp: int, *,
                 luma_only: bool = False, bs: BoundaryStrength | None = None,
                 luma_block: tuple[int, int] = (BLOCK_BY, BLOCK_BX),
                 chroma_block: tuple[int, int] = CHROMA_BLOCK):
        check_dims(width, height)  # reference contract (cpu.h:46-48)
        self.width, self.height, self.qp = width, height, int(qp)
        self.frame_bytes = 3 * width * height // 2
        self._luma_only = luma_only
        self._beta = jnp.int32(get_beta(qp))
        self._tc = jnp.int32(get_tc(qp))

        p = HALF_BLOCK
        by, bx = (height + 2 * p) // _B, (width + 2 * p) // _B
        cby = (height // 2 + 2 * p) // _B
        cbx = (width // 2 + 2 * p) // _B
        self._lb = _effective_block(tuple(luma_block), by, bx)
        self._cb = _effective_block(tuple(chroma_block), 2 * cby, cbx)

        from ..utils.tiles import relayout_engine, tile_perm_device

        # one-hot relayout operands exist only under GVCT_RELAYOUT=mxu; the
        # default transpose engine needs none
        mxu = relayout_engine() == "mxu"
        bxg = -(-bx // self._lb[1]) * self._lb[1]
        self._yperm_f = tile_perm_device(width, p, False, bxg) if mxu else None
        self._yperm_i = tile_perm_device(width, p, True, bxg) if mxu else None
        cw = width // 2
        self._chroma_fused = (cw + 2 * p) % _B == 0
        if self._chroma_fused and mxu:
            # non-sheared Q9: chroma rides the fused relayout too, on the
            # same lane-aligned grid the kernel will sweep
            ccbxg = -(-cbx // self._cb[1]) * self._cb[1]
            self._cperm_f = tile_perm_device(cw, p, False, ccbxg)
            self._cperm_i = tile_perm_device(cw, p, True, ccbxg)
        else:
            self._cperm_f = self._cperm_i = None

        self.update_boundary_strength(
            bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Swap in new BS arrays (the SetBoundaryStrenght story, cpu.h:120-132)
        without recompiling: the padded segment maps are step arguments."""
        lm = luma_segment_maps(bs)
        cm = chroma_segment_maps(bs)
        # pad maps once to the padded grid; padding tiles get BS = 0 (no-op)
        self._lm = tuple(jnp.asarray(_pad_to(np.asarray(m), *self._lb)) for m in lm)
        self._cm = tuple(
            jnp.asarray(_pad_to(np.concatenate([m, m], axis=0), *self._cb)) for m in cm
        )

    # -- public operand/shape contract (used by parallel/resident_mesh.py) ----

    @property
    def operands(self) -> StepOperands:
        """The step/ingest/readback device operands as one pytree."""
        return StepOperands(self._lm, self._cm, self._beta, self._tc,
                            self._yperm_f, self._yperm_i,
                            self._cperm_f, self._cperm_i)

    def install_operands(self, ops: StepOperands) -> None:
        """Replace the device operands (e.g. with mesh-replicated copies).
        Shapes/dtypes must match what `operands` returned; only placement is
        expected to change."""
        (self._lm, self._cm, self._beta, self._tc,
         self._yperm_f, self._yperm_i, self._cperm_f, self._cperm_i) = ops

    @property
    def block_shapes(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """Effective (luma_block, chroma_block) after the kernel's adaptive
        clamp -- static args every step wrapper must pass through."""
        return self._lb, self._cb

    @property
    def luma_only(self) -> bool:
        return self._luma_only

    @property
    def chroma_fused(self) -> bool:
        """Non-sheared Q9 geometry: chroma shares luma's fused relayout
        (static arg of ingest/readback)."""
        return self._chroma_fused

    # -- pipeline boundaries --------------------------------------------------

    def host_buf(self, frame) -> np.ndarray:
        """Normalize one packed frame (bytes / any uint8 array whose total
        size is frame_bytes) or a frame batch to a validated uint8 ndarray.

        Batch forms are recognized STRUCTURALLY -- the trailing dims after a
        leading batch axis must multiply to frame_bytes (so (n, 3wh/2),
        (n, 3h/2, w), and in particular a batch of ONE keep their batch
        axis), or a 2-D row stack (n*3h/2, w) whose row width is the frame
        width.  Anything else whose size merely divides by frame_bytes
        (e.g. a transposed (frame_bytes, n) array) is rejected rather than
        silently reinterpreted as scrambled frames."""
        arr = (np.frombuffer(frame, np.uint8)
               if isinstance(frame, (bytes, bytearray))
               else np.asarray(frame, np.uint8))
        if arr.ndim >= 2 and int(np.prod(arr.shape[1:])) == self.frame_bytes:
            return arr.reshape(-1, self.frame_bytes)  # batch (incl. n == 1)
        if arr.size == self.frame_bytes:  # single frame in any layout
            return arr.ravel()
        if (arr.ndim == 2 and arr.shape[1] == self.width
                and arr.size % self.frame_bytes == 0):
            return arr.reshape(-1, self.frame_bytes)  # stacked frame rows
        raise ValueError(
            f"frame must be {self.frame_bytes} bytes, an (n, {self.frame_bytes}) "
            f"/ (n, {3 * self.height // 2}, {self.width}) batch, or a "
            f"(n*{3 * self.height // 2}, {self.width}) row stack; got shape "
            f"{arr.shape}")

    _host_buf = host_buf  # backward-compatible alias

    def ingest(self, frame) -> TileFrame:
        """Host frame(s) -> device TileFrame.  Accepts one packed frame
        (bytes / uint8 buffer), a BATCH of frames (list/tuple of frames, or
        an (n, 3wh/2)-shaped array -- the batch runs through the kernels as
        one launch), or an already-device-resident packed buffer (skips the
        H2D)."""
        if isinstance(frame, jax.Array):
            buf = frame
        else:
            if isinstance(frame, (list, tuple)):
                arr = np.stack([self._host_buf(f) for f in frame])
            else:
                arr = self._host_buf(frame)
            buf = jax.device_put(arr)
        return _ingest(buf, self.width, self.height, self._lb, self._cb,
                       self._yperm_f, self._cperm_f, fused=self._chroma_fused)

    def step(self, tf: TileFrame) -> TileFrame:
        """Kernel-only deblock of a resident frame (the steady state)."""
        return _step(tf, self._lm, self._cm, self._beta, self._tc,
                     self._luma_only, self._lb, self._cb)

    def run_steps(self, tf: TileFrame, n: int) -> TileFrame:
        """n chained deblock steps entirely on device, one dispatch
        (bit-identical to calling step() n times)."""
        return _step_n(tf, self._lm, self._cm, self._beta, self._tc,
                       int(n), self._luma_only, self._lb, self._cb)

    def readback(self, tf: TileFrame) -> np.ndarray:
        """Device TileFrame -> filtered packed YV12 on the host."""
        return jax.device_get(_readback(tf, self.width, self.height,
                                        self._yperm_i, self._cperm_i,
                                        fused=self._chroma_fused))

    def __call__(self, frame) -> np.ndarray:
        return self.readback(self.step(self.ingest(frame)))

    # -- measurement -----------------------------------------------------------

    def step_time(self, frame, iters: int = 100, repeats: int = 3) -> dict:
        """Steady-state resident step latency, two ways:

        step_s/step_us/mpix_s -- DEVICE time per step, profiler-trace
        measured (the reference's 'without copy' definition done right,
        gpu.cu:1264-1294: device execution, not host dispatch).

        dispatch_us -- wall time per individually-dispatched chained step.
        On the CPU backend step_us is that chained wall time and
        `step_clock` says "cpu_wall"."""
        from ..utils.tracing import profiled_device_us

        tf = self.step(self.ingest(frame))
        jax.block_until_ready(tf.y)
        prof = profiled_device_us(lambda: self.step(tf), iters=min(iters, 30))
        clock = "device_trace"
        if prof is not None:
            device_best = prof[0] / 1e6
        else:
            clock = "cpu_wall"
            n = min(iters, 20)
            t = self.run_steps(tf, n)  # compile the n-step chain
            jax.block_until_ready(t.y)
            device_best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                t = self.run_steps(tf, n)
                jax.block_until_ready(t.y)
                device_best = min(device_best, (time.perf_counter() - t0) / n)
        dispatch_best = float("inf")
        for _ in range(repeats):
            t = tf
            t0 = time.perf_counter()
            for _ in range(iters):
                t = self.step(t)
            jax.block_until_ready(t.y)
            dispatch_best = min(dispatch_best, (time.perf_counter() - t0) / iters)
        luma_px = self.width * self.height
        return {
            "step_s": device_best,
            "step_us": device_best * 1e6,
            "mpix_s": luma_px / device_best / 1e6,
            "dispatch_us": dispatch_best * 1e6,
            "step_clock": clock,
        }

"""Streaming YV12 pipeline with host->HBM copy overlap.

The reference's perf-engineering centerpiece is pinned host memory cutting
synchronous cudaMemcpy time (gpu.cu:1103-1114, 1248-1256; README rows) --
yet its copies still serialize with the kernel and dominate end-to-end time
5:1 even pinned.  The equivalent here:

* ONE host->HBM DMA per frame, of the raw packed YV12 buffer (3*w*h/2 bytes,
  the minimal transfer) -- plane splitting, extension padding, tile-plane
  layout all happen on device where they run at HBM bandwidth;
* JAX's asynchronous dispatch pipelines the DMA of frame i+1 under the
  kernel of frame i (`depth` frames in flight), so steady state is
  max(copy, compute) instead of copy + compute;
* readback (when the consumer is the host) is a single device->host DMA of
  the repacked YV12 output.

Reference parity map: ExecuteGpu's alloc/copy/launch/copy/save sequence
(gpu.cu:1230-1306) becomes StreamingDeblocker.run(); pinned-memory copies
become overlap-by-async-dispatch; the copy-vs-kernel timing split
(gpu.cu:1246-1303) is exposed via time_breakdown().
"""

from __future__ import annotations

import functools
import time
from collections import deque
from collections.abc import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.deblock import deblock_frame
from ..ops.pallas_kernel import BLOCK_BX, BLOCK_BY, CHROMA_BLOCK
from ..ops.tables import HALF_BLOCK, SAMPLE_BLOCK_SIZE, get_beta, get_tc
from ..utils.bs import BoundaryStrength, segment_bs_maps_device
from ..utils.yuv import FramePlanes, check_dims


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def luma_grid_shape(width: int, height: int,
                    luma_block: tuple[int, int]) -> tuple[int, int]:
    """The padded luma tile-grid of the streaming layout: tile counts
    rounded up to the effective block shape (effective_block_bx's clamp,
    incl. its cheap 128-column alignment; the resident and mesh layouts
    use the same rule)."""
    from ..ops.pallas_kernel import effective_block_bx

    by, bx = (height + 2 * HALF_BLOCK) // 8, (width + 2 * HALF_BLOCK) // 8
    eby = min(luma_block[0], _ceil_to(by, 8))
    ebx = effective_block_bx(luma_block[1], bx)
    return _ceil_to(by, eby), _ceil_to(bx, ebx)


def _chroma_grid_bx(width: int, chroma_block: tuple[int, int]) -> int:
    """Padded chroma tile-grid columns for a non-sheared geometry (same
    rule as luma_grid_shape)."""
    from ..ops.pallas_kernel import effective_block_bx

    cbx = (width // 2 + 2 * HALF_BLOCK) // SAMPLE_BLOCK_SIZE
    return _ceil_to(cbx, effective_block_bx(chroma_block[1], cbx))


def _pack_out(buf, parts_at, inplace):
    """Assemble the output packed buffer from (row-offset, segment) pieces
    (buf and segments share trailing dims; offsets index the leading axis).

    inplace=True writes each filtered segment into `buf` via
    dynamic-update-slice -- with the buffer donated (the streaming step),
    XLA aliases output to input and the writes are genuinely in place,
    removing the output concatenate pass entirely.  Unwritten byte ranges
    (e.g. chroma under luma_only) pass through untouched, exactly like the
    reference's in-place plane filtering (cpu.h:146-447 mutates ext_Y/U/V
    directly).
    inplace=False materializes a fresh buffer (concatenate) -- the
    borrow-safe form for callers that must keep `buf` alive.
    """
    rest = (0,) * (buf.ndim - 1)
    if inplace:
        out = buf
        for off, p in parts_at:
            out = jax.lax.dynamic_update_slice(out, p, (off, *rest))
        return out
    parts = []
    pos = 0
    for off, p in parts_at:
        if off > pos:  # untouched gap: carry input bytes through
            parts.append(buf[pos:off])
        parts.append(p)
        pos = off + p.shape[0]
    if pos < buf.shape[0]:
        parts.append(buf[pos:])
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


def _deblock_planes_impl(y, uv, lm, cm, beta, tc, w, h, luma_only, backend,
                         luma_block=(BLOCK_BY, BLOCK_BX),
                         chroma_block=CHROMA_BLOCK,
                         yperms=None, luma_grid=None):
    """Device-side PLANES contract: y (h, w) + uv (2, h/2, w/2) uint8 ->
    (filtered y, filtered uv), same shapes.

    This is the exact analogue of the reference's device format: it keeps
    Y, U and V in three SEPARATE device buffers (_gpu_Y/U/V_ptr,
    gpu.cu:1248-1250) and its kernels index the planes directly
    (gpu.cu:535-545) -- its 'without copy' bracket never touches a packed
    YV12 buffer.  Operating at plane granularity here likewise skips every
    packed-buffer retile and write-back pass (the (3h/2, w) <-> (2, ch, cw)
    chroma retiles and the output packing).

    On the pallas path the luma plane goes interior -> tile-planes ->
    interior directly (utils.tiles.interior_to_tiles/tiles_to_interior):
    the Q6 zero padding, the grid padding and the interior write-back
    slice all happen inside the relayout.  Chroma does the same whenever the extended
    chroma width is 8-aligned (the non-sheared Q9 case -- every w%16==0
    geometry); only sheared geometries pay the explicit extended-plane
    covered-split path.  yperms carries the mxu engine's one-hot operands
    as arguments (so XLA doesn't regenerate the multi-MB matrices on device
    each step), or None under the default transpose engine."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    u, v = uv[0], uv[1]
    if backend == "pallas":
        from ..ops.pallas_kernel import deblock_chroma_ext_pallas, deblock_tiles_pallas
        from ..utils.tiles import interior_to_tiles, tiles_to_interior

        byg, bxg = luma_grid or luma_grid_shape(w, h, luma_block)
        fwd, inv, cfwd, cinv = yperms if yperms is not None else (None,) * 4
        yt = interior_to_tiles(y, p, perm=fwd, by_grid=byg, bx_grid=bxg)
        y_out = deblock_tiles_pallas(yt, *lm, beta, tc, chroma=False)
        y_int = tiles_to_interior(y_out, p, h, w, perm=inv)  # (h, w)
        if luma_only:
            return y_int, uv
        if (cw + 2 * p) % SAMPLE_BLOCK_SIZE == 0:
            # non-sheared Q9: the covered flat view IS the extended plane
            # (minus untouched bottom padding rows), so chroma rides the same
            # fused interior<->tiles relayout as luma -- no explicit pads,
            # covered split/join, or interior slices.  U and V batch through
            # ONE relayout dot via the uv buffer's (2, ch, cw) adjacency.
            from ..ops.pallas_kernel import effective_block_bx

            cbx = (cw + 2 * p) // SAMPLE_BLOCK_SIZE
            cbxg = _ceil_to(cbx, effective_block_bx(chroma_block[1], cbx))
            uvt = interior_to_tiles(uv, p, perm=cfwd, bx_grid=cbxg)
            cmaps = [m[None] for m in cm]  # one shared map across the U/V batch
            uv_out = deblock_tiles_pallas(uvt, *cmaps, beta, tc, chroma=True)
            return y_int, tiles_to_interior(uv_out, p, ch, cw, perm=cinv)
        ue, ve = deblock_chroma_ext_pallas(jnp.pad(u, p), jnp.pad(v, p),
                                           cm, beta, tc)
        uv_int = jnp.stack([ue[p : p + ch, p : p + cw], ve[p : p + ch, p : p + cw]])
        return y_int, uv_int
    y, u, v = (jnp.pad(t, p) for t in (y, u, v))  # extended planes, zero pad
    ye, ue, ve = deblock_frame(y, u, v, lm, cm, beta, tc, luma_only=luma_only)
    y_int = ye[p : p + h, p : p + w]
    if luma_only:
        return y_int, uv
    uv_int = jnp.stack([ue[p : p + ch, p : p + cw], ve[p : p + ch, p : p + cw]])
    return y_int, uv_int


def _deblock_yv12_packed_impl(buf, lm, cm, beta, tc, w, h, luma_only, backend,
                              luma_block=(BLOCK_BY, BLOCK_BX),
                              chroma_block=CHROMA_BLOCK,
                              yperms=None, luma_grid=None, inplace=False,
                              chroma_fold=False):
    """Device-side: packed YV12 uint8 (3h/2, w) -> filtered packed YV12.

    The buffer is 2-D ((3h/2, w) -- the same bytes as the flat YV12 file
    order, viewed as rows): the luma plane is a leading row-slice (free)
    and its write-back a row-aligned dynamic-update-slice; only the chroma
    region is reshaped to (2, ch, cw) and back.  The filter math is the planes contract
    (_deblock_planes_impl); this wrapper just adds the packed-buffer
    boundary.

    chroma_fold=True (GVCT_PACKED_CHROMA=fold; pallas backend, non-sheared
    geometries): even that chroma retile goes away -- the packed rows feed
    the fold relayout dots directly (utils.tiles.packed_rows_to_chroma_tiles
    / chroma_tiles_to_packed_rows; yperms[2:4] carry the fold operands).
    Bit-identical; the trade is 2x chroma relayout MACs for zero retile
    copies (tools/chromafold_exp.py races the two)."""
    p = HALF_BLOCK
    cw, ch = w // 2, h // 2
    y = buf[:h]
    if chroma_fold and not luma_only:
        from ..ops.pallas_kernel import deblock_tiles_pallas
        from ..utils.tiles import (
            chroma_tiles_to_packed_rows, packed_rows_to_chroma_tiles,
        )

        # luma via the planes path (uv operand unused under luma_only)
        dummy_uv = jnp.zeros((2, 8, 8), jnp.uint8)
        y_int, _ = _deblock_planes_impl(
            y, dummy_uv, lm, cm, beta, tc, w, h, True, backend,
            luma_block, chroma_block, yperms, luma_grid)
        cby = (ch + 2 * p) // SAMPLE_BLOCK_SIZE
        cbxg = _chroma_grid_bx(w, chroma_block)
        t = packed_rows_to_chroma_tiles(buf[h:], p, h, w, cby, cbxg,
                                        yperms[2])
        cmaps = [m[None] for m in cm]  # one shared map across the U/V batch
        t_out = deblock_tiles_pallas(t, *cmaps, beta, tc, chroma=True)
        reg = chroma_tiles_to_packed_rows(t_out, p, h, w, yperms[3])
        return _pack_out(buf, [(0, y_int), (h, reg)], inplace)
    uv = buf[h:].reshape(2, ch, cw)
    y_int, uv_int = _deblock_planes_impl(
        y, uv, lm, cm, beta, tc, w, h, luma_only, backend,
        luma_block, chroma_block, yperms, luma_grid)
    parts = [(0, y_int)]
    if not luma_only:
        parts.append((h, uv_int.reshape(h // 2, w)))
    return _pack_out(buf, parts, inplace)


_PACKED_STATIC = ("w", "h", "luma_only", "backend", "luma_block",
                  "chroma_block", "luma_grid", "inplace", "chroma_fold")

# borrow-safe step: buf stays valid (callers that reuse the input buffer)
_deblock_yv12_packed = functools.partial(jax.jit, static_argnames=_PACKED_STATIC)(
    _deblock_yv12_packed_impl)

# donating step: buf's HBM buffer is aliased as the output, so the in-place
# segment writes are true in-place updates and the output concat disappears.
# The caller's handle is invalidated -- StreamingDeblocker always feeds this
# a fresh per-frame device_put (or chains step outputs), never a kept buffer.
_deblock_yv12_packed_donated = jax.jit(
    _deblock_yv12_packed_impl, static_argnames=_PACKED_STATIC, donate_argnums=(0,))

_PLANES_STATIC = ("w", "h", "luma_only", "backend", "luma_block",
                  "chroma_block", "luma_grid")

# planes contract: y/uv in, y/uv out (see _deblock_planes_impl).  Both
# plane buffers are donated and aliased output-to-input -- with
# shape-preserving outputs XLA reuses the device memory in place, so the
# graph is purely relayout + kernels, like the reference's in-place plane
# filtering on its separate _gpu_Y/U/V buffers (gpu.cu:535-545, 1248-1250).
_deblock_planes_donated = jax.jit(
    _deblock_planes_impl, static_argnames=_PLANES_STATIC, donate_argnums=(0, 1))


@functools.partial(jax.jit, static_argnames=("n", "w", "h", "luma_only", "backend",
                                              "luma_block", "chroma_block",
                                              "luma_grid", "chroma_fold"))
def _deblock_yv12_packed_n(buf, lm, cm, beta, tc, n, w, h, luma_only, backend,
                           luma_block=(BLOCK_BY, BLOCK_BX), chroma_block=CHROMA_BLOCK,
                           yperms=None, luma_grid=None, chroma_fold=False):
    """n chained packed-YV12 deblock steps in ONE dispatch (lax.fori_loop):
    one dispatch over an n-step on-device chain takes host dispatch out of
    a wall-clock bracket, like the reference's CUDA-event 'without copy'
    bracket (gpu.cu:1264-1294).  The loop body is the full packed graph (unpack -> kernels -> repack), so
    per-iteration work is identical to one streaming step."""
    return jax.lax.fori_loop(
        0, n,
        # inplace=True: the loop carry double-buffers, so the in-place form
        # writes segments without materializing a concat each iteration
        lambda _, b: _deblock_yv12_packed_impl(b, lm, cm, beta, tc, w, h,
                                               luma_only, backend, luma_block,
                                               chroma_block, yperms, luma_grid,
                                               inplace=True,
                                               chroma_fold=chroma_fold),
        buf,
    )


class StreamingDeblocker:
    """Deblocks a stream of same-geometry raw YV12 frames with copy/compute
    overlap.  Frames are 1-D uint8 arrays of size 3*w*h/2 (or bytes).

    depth: frames in flight (2 = classic double buffering).
    backend: "pallas" (fused kernel) or "jnp" (XLA path).
    """

    def __init__(self, width: int, height: int, qp: int, *,
                 backend: str = "pallas", luma_only: bool = False,
                 depth: int = 2, bs: BoundaryStrength | None = None,
                 luma_block: tuple[int, int] = (BLOCK_BY, BLOCK_BX),
                 chroma_block: tuple[int, int] = CHROMA_BLOCK):
        if backend not in ("pallas", "jnp"):
            raise ValueError(f"streaming backend must be 'pallas' or 'jnp', got {backend!r}")
        check_dims(width, height)  # reference contract (cpu.h:46-48)
        self.width, self.height, self.qp = width, height, int(qp)
        self.depth = max(1, depth)
        self.frame_bytes = 3 * width * height // 2
        self._beta = jnp.int32(get_beta(qp))
        self._tc = jnp.int32(get_tc(qp))
        self._luma_only = luma_only
        self._backend = backend
        self._luma_block = tuple(luma_block)
        self._chroma_block = tuple(chroma_block)
        self._luma_grid = luma_grid_shape(width, height, self._luma_block)
        # GVCT_PACKED_CHROMA=fold (pallas backend, non-sheared geometries,
        # GVCT_RELAYOUT=mxu): the packed step's chroma boundary runs through
        # the fold relayout dots instead of the (h/2, w) <-> (2, ch, cw)
        # retile copies -- bit-identical (tests/test_streaming.py).
        import os

        from ..utils.tiles import relayout_engine

        mxu = backend == "pallas" and relayout_engine() == "mxu"
        cw = width // 2
        # Q9: the flat chroma sweep is non-sheared iff the extended chroma
        # width is lane-aligned -- the single predicate that gates both the
        # fused chroma relayout and the fold engine
        chroma_fused = ((cw + 2 * HALF_BLOCK) % SAMPLE_BLOCK_SIZE == 0
                        and not luma_only)
        self._chroma_fold = (
            mxu and chroma_fused
            and os.environ.get("GVCT_PACKED_CHROMA", "retile") == "fold")
        if mxu:
            # one-hot relayout operands, built only when the mxu engine is
            # selected (the default transpose engine needs none)
            from ..utils.tiles import fold_perm_device, tile_perm_device

            bxg = self._luma_grid[1]
            perms = [tile_perm_device(width, HALF_BLOCK, False, bxg),
                     tile_perm_device(width, HALF_BLOCK, True, bxg)]
            if chroma_fused:
                # non-sheared Q9 geometry: chroma uses the fused relayout too,
                # on the same lane-aligned grid the kernel will sweep
                cbxg = _chroma_grid_bx(width, self._chroma_block)
                perms += [tile_perm_device(cw, HALF_BLOCK, False, cbxg),
                          tile_perm_device(cw, HALF_BLOCK, True, cbxg)]
            else:
                perms += [None, None]
            self._yperms = tuple(perms)
            if self._chroma_fold:
                # the PACKED step swaps the interior chroma perms for the
                # fold operands; step_planes keeps self._yperms (its chroma
                # stays at plane granularity, no packed boundary to fold)
                self._packed_yperms = (
                    perms[0], perms[1],
                    fold_perm_device(width, HALF_BLOCK, cbxg, False),
                    fold_perm_device(width, HALF_BLOCK, cbxg, True))
            else:
                self._packed_yperms = self._yperms
        else:
            self._yperms = None
            self._packed_yperms = None
        self.update_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def update_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install new BS arrays mid-stream (the streaming equivalent of the
        reference's SetBoundaryStrenght, cpu.h:120-132).  Segment gate maps
        are derived on device via utils.bs.segment_bs_maps_device (the
        in-graph twin of the host derivation); geometry stays fixed so the
        compiled step is reused."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        b = 8
        w, h = self.width, self.height
        ny, nx = h // b + 1, w // b + 1
        cny, cnx = (h // 2) // b + 1, (w // 2) // b + 1
        self._lm = tuple(segment_bs_maps_device(bs.vert, bs.hor, w, ny, nx, ny, nx))
        self._cm = tuple(segment_bs_maps_device(bs.chroma_vert, bs.chroma_hor, w // 2,
                                                cny, cnx, ny, nx))

    def _step(self, dev_buf):
        """One packed deblock step.  CONSUMES dev_buf (the buffer is donated
        and aliased as the output -- no output concat pass); every internal
        caller feeds a fresh per-frame _put or chains step outputs.  Use
        _step_borrow when the input must stay alive."""
        return _deblock_yv12_packed_donated(
            dev_buf, self._lm, self._cm, self._beta, self._tc,
            w=self.width, h=self.height,
            luma_only=self._luma_only, backend=self._backend,
            luma_block=self._luma_block, chroma_block=self._chroma_block,
            yperms=self._packed_yperms, luma_grid=self._luma_grid,
            inplace=True, chroma_fold=self._chroma_fold,
        )

    def step_planes(self, y, uv):
        """One deblock step at PLANE granularity: y (h, w) + uv (2, h/2, w/2)
        uint8 device arrays -> (filtered y, filtered uv).

        This is the like-for-like twin of the reference's device format --
        separate per-plane buffers filtered in place (gpu.cu:1248-1250,
        535-545) -- and skips the packed-buffer retile/write-back passes the
        YV12 single-buffer contract pays.  CONSUMES both inputs (the output
        buffers alias them); chain outputs or feed fresh device_puts.  For
        host-side packed YV12 streams use run()/_step instead."""
        return _deblock_planes_donated(
            y, uv, self._lm, self._cm, self._beta, self._tc,
            w=self.width, h=self.height,
            luma_only=self._luma_only, backend=self._backend,
            luma_block=self._luma_block, chroma_block=self._chroma_block,
            yperms=self._yperms, luma_grid=self._luma_grid,
        )

    def put_planes(self, frame):
        """Host packed YV12 frame -> (y, uv) device plane buffers (two
        H2D DMAs, mirroring the reference's per-plane cudaMemcpys,
        gpu.cu:1248-1250)."""
        arr = self._host_frame(frame)
        w, h = self.width, self.height
        y = jax.device_put(arr[: w * h].reshape(h, w))
        uv = jax.device_put(arr[w * h :].reshape(2, h // 2, w // 2))
        return y, uv

    def _step_borrow(self, dev_buf):
        """Non-donating step (input stays valid); same output values."""
        return _deblock_yv12_packed(
            dev_buf, self._lm, self._cm, self._beta, self._tc,
            w=self.width, h=self.height,
            luma_only=self._luma_only, backend=self._backend,
            luma_block=self._luma_block, chroma_block=self._chroma_block,
            yperms=self._packed_yperms, luma_grid=self._luma_grid,
            inplace=False, chroma_fold=self._chroma_fold,
        )

    def _chain(self, dev_buf, n: int):
        """n chained packed steps in one dispatch (see _deblock_yv12_packed_n)."""
        return _deblock_yv12_packed_n(
            dev_buf, self._lm, self._cm, self._beta, self._tc,
            n=n, w=self.width, h=self.height,
            luma_only=self._luma_only, backend=self._backend,
            luma_block=self._luma_block, chroma_block=self._chroma_block,
            yperms=self._packed_yperms, luma_grid=self._luma_grid,
            chroma_fold=self._chroma_fold,
        )

    def _host_frame(self, frame) -> np.ndarray:
        """Normalize a frame (bytes or array-like) to a validated uint8 buffer."""
        arr = (np.frombuffer(frame, np.uint8) if isinstance(frame, (bytes, bytearray))
               else np.asarray(frame, np.uint8).ravel())
        if arr.size != self.frame_bytes:
            raise ValueError(f"frame must be {self.frame_bytes} bytes, got {arr.size}")
        return arr

    def _put(self, frame) -> jax.Array:
        """Async host->HBM DMA of one packed frame, placed as the 2-D
        (3h/2, w) row view (same bytes; the host reshape is free, and the
        2-D placement avoids the 1-D->2-D retiling copies on device)."""
        rows = self._host_frame(frame).reshape(3 * self.height // 2, self.width)
        return jax.device_put(rows)

    def run(self, frames: Iterable) -> Iterator[np.ndarray]:
        """Yield filtered packed YV12 frames (np.uint8, flat).  H2D(i+1),
        kernel(i) and D2H(i-depth) overlap through the async dispatch queue."""
        inflight: deque = deque()
        for frame in frames:
            inflight.append(self._step(self._put(frame)))
            if len(inflight) >= self.depth:
                yield jax.device_get(inflight.popleft()).reshape(-1)
        while inflight:
            yield jax.device_get(inflight.popleft()).reshape(-1)

    def run_frames(self, frames: Iterable[FramePlanes]) -> Iterator[FramePlanes]:
        """FramePlanes convenience wrapper around run()."""
        from ..utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

        packed = (np.frombuffer(yv12_bytes_from_planes(f), np.uint8) for f in frames)
        for out in self.run(packed):
            yield planes_from_yv12_bytes(out, self.width, self.height)

    # -- measurement ---------------------------------------------------------

    def throughput(self, frame, n_frames: int = 100, readback: bool = False,
                   repeats: int = 3) -> dict:
        """Steady-state pipelined throughput over n_frames copies of `frame`.

        readback=False measures the host->HBM->filter rate (outputs stay in
        HBM for a downstream on-device consumer); readback=True drains every
        output back to the host (full YV12 in/out loop).
        """
        arr = self._host_frame(frame)
        out = self._step(self._put(arr))
        jax.block_until_ready(out)  # compile warm-up

        def one_batch() -> float:
            t0 = time.perf_counter()
            if readback:
                for _ in self.run(arr for _ in range(n_frames)):
                    pass
            else:
                last = None
                for _ in range(n_frames):
                    last = self._step(self._put(arr))
                jax.block_until_ready(last)
            return time.perf_counter() - t0

        # best of `repeats` short batches
        dt = min(one_batch() for _ in range(repeats)) / n_frames
        luma_px = self.width * self.height
        return {
            "frames": n_frames,
            "per_frame_s": dt,
            "fps": 1.0 / dt,
            "mpix_per_s": luma_px / dt / 1e6,
            "readback": readback,
        }

    def time_breakdown(self, frame, n: int = 30, measure_d2h: bool = False) -> dict:
        """Per-frame latency split: H2D copy vs kernel (the reference's
        'with copy'/'without copy' table, gpu.cu:1292-1303).

        On a GPU, kernel_s is DEVICE time per packed step from a profiler
        trace (the analogue of the reference's CUDA-event bracket around
        the kernel launches), with device_split_us beside it.  On the CPU
        backend there is no device trace: the step is timed by host wall
        clock and reported as kernel_s with `kernel_clock: "cpu_wall"`.
        dispatch_s is host wall per individually-dispatched step.

        measure_d2h adds a synchronous end-to-end (put -> filter -> get)
        measurement.
        """
        from ..utils.tracing import profiled_device_us

        arr = self._host_frame(frame)
        out = self._step(self._put(arr))  # compile warm-up
        jax.block_until_ready(out)

        def best_of(fn, reps=3):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                last = None
                for _ in range(n):
                    last = fn()
                jax.block_until_ready(last)
                best = min(best, (time.perf_counter() - t0) / n)
            return best

        h2d = best_of(lambda: self._put(arr))

        # chain step outputs (output shape == input shape): _step donates its
        # input, so a kept buffer cannot be re-fed
        cell = [out]

        def chained():
            cell[0] = self._step(cell[0])
            return cell[0]

        dispatch = best_of(chained)

        prof = profiled_device_us(chained, iters=n)
        if prof is not None:
            res = {"h2d_s": h2d, "kernel_s": prof[0] / 1e6,
                   "dispatch_s": dispatch, "kernel_clock": "device_trace"}
            cats = prof[1]
            res["device_split_us"] = {
                "deblock_kernels": round(cats.get("deblock_kernels", 0.0), 2),
                "layout_and_copies": round(cats.get("layout_and_copies", 0.0), 2),
                "other": round(cats.get("other", 0.0), 2),
            }
        else:
            # CPU backend: host wall of a chained on-device loop
            k = min(n, 4)
            dev2 = self._put(arr)
            jax.block_until_ready(self._chain(dev2, k))
            t0 = time.perf_counter()
            jax.block_until_ready(self._chain(dev2, k))
            res = {"h2d_s": h2d, "kernel_s": (time.perf_counter() - t0) / k,
                   "dispatch_s": dispatch, "kernel_clock": "cpu_wall"}
        if measure_d2h:
            reps = max(1, n // 10)
            t0 = time.perf_counter()
            for _ in range(reps):
                jax.device_get(self._step(self._put(arr)))
            res["e2e_sync_s"] = (time.perf_counter() - t0) / reps
        return res

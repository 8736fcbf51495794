"""Frame deblocking pipeline: the framework's execution-driver layer.

Replaces the reference's ExecuteCpu / ExecuteGpu drivers (main.cu:36-83,
gpu.cu:1230-1306) with a backend-dispatching pipeline object:

  backend="jnp"    whole-frame tile-plane deblock under jax.jit (XLA fuses
                   the elementwise phases); correctness anchor on any device
  backend="pallas" fused GPU kernel fast path (ops/pallas_kernel.py)
  backend="golden" scalar NumPy oracle (models/golden.py)
  backend="native" C++ OpenMP CPU runtime (runtime/native.py), the analogue
                   of the reference's ExecuteCpu path

BS segment maps are precomputed host-side once per (geometry, BS) pair --
they are frame-rate-invariant metadata, unlike the reference which re-reads
flat BS entries per tile per frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.deblock import deblock_frame
from ..ops.tables import get_beta, get_tc
from ..utils.bs import BoundaryStrength, chroma_segment_maps, luma_segment_maps
from ..utils.tiles import split_covered
from ..utils.yuv import FramePlanes


@functools.partial(jax.jit, static_argnames=("luma_only",))
def _deblock_jit(y, u, v, luma_maps, chroma_maps, beta, tc, luma_only):
    # beta/tc are traced int32 scalars so a QP change never recompiles
    return deblock_frame(y, u, v, luma_maps, chroma_maps, beta, tc, luma_only=luma_only)


class DeblockPipeline:
    """Deblock frames of a fixed geometry/QP with a chosen execution backend."""

    def __init__(self, width: int, height: int, qp: int,
                 luma_only: bool = False, backend: str = "jnp",
                 bs: BoundaryStrength | None = None, num_threads: int = 0):
        self.width = width
        self.height = height
        self.qp = int(qp)
        self.beta = get_beta(qp)
        self.tc = get_tc(qp)
        self.luma_only = luma_only
        self.backend = backend
        # native backend OpenMP threads; 0 = library default (the reference
        # sweeps 1/2/4/6/8 via omp_set_num_threads, cpu.h:135)
        self.num_threads = num_threads
        self.set_boundary_strength(bs or BoundaryStrength.intra_default(width, height))

    def set_boundary_strength(self, bs: BoundaryStrength) -> None:
        """Install BS arrays and precompute per-segment (By, Bx) gate maps."""
        if (bs.width, bs.height) != (self.width, self.height):
            raise ValueError("BoundaryStrength geometry mismatch")
        self.bs = bs
        self.luma_maps = tuple(np.asarray(m) for m in luma_segment_maps(bs))
        self.chroma_maps = tuple(np.asarray(m) for m in chroma_segment_maps(bs))

    # -- backends ----------------------------------------------------------

    def _run_jnp(self, frame: FramePlanes) -> FramePlanes:
        y, u, v = _deblock_jit(
            jnp.asarray(frame.y), jnp.asarray(frame.u), jnp.asarray(frame.v),
            self.luma_maps, self.chroma_maps,
            jnp.int32(self.beta), jnp.int32(self.tc), self.luma_only,
        )
        # jax.device_get, never np.asarray, for computed device arrays (CLAUDE.md)
        return FramePlanes(jax.device_get(y), jax.device_get(u), jax.device_get(v),
                           frame.width, frame.height)

    def _run_pallas(self, frame: FramePlanes) -> FramePlanes:
        from ..ops.pallas_kernel import deblock_frame_pallas_jit

        y, u, v = deblock_frame_pallas_jit(
            jnp.asarray(frame.y), jnp.asarray(frame.u), jnp.asarray(frame.v),
            self.luma_maps, self.chroma_maps,
            jnp.int32(self.beta), jnp.int32(self.tc), self.luma_only,
        )
        return FramePlanes(jax.device_get(y), jax.device_get(u), jax.device_get(v),
                           frame.width, frame.height)

    def _run_golden(self, frame: FramePlanes) -> FramePlanes:
        from .golden import deblock_frame_golden

        return deblock_frame_golden(frame, self.bs, self.qp, luma_only=self.luma_only)

    def _run_native(self, frame: FramePlanes) -> FramePlanes:
        from ..runtime.native import deblock_frame_native

        return deblock_frame_native(frame, self.bs, self.qp, luma_only=self.luma_only,
                                    num_threads=self.num_threads)

    def __call__(self, frame: FramePlanes) -> FramePlanes:
        if (frame.width, frame.height) != (self.width, self.height):
            raise ValueError("frame geometry mismatch")
        runner = getattr(self, f"_run_{self.backend}", None)
        if runner is None:
            raise ValueError(f"unknown backend {self.backend!r}")
        return runner(frame)

    def batch(self, frames: list[FramePlanes]) -> list[FramePlanes]:
        """Deblock a batch of frames in ONE device step (BASELINE config 3).

        Frames fold into a single taller tile grid by row-concatenation --
        exact because tiles are independent and extended luma heights are
        always 8-aligned; chroma planes are concatenated by their tile-swept
        flat views (quirk Q9) with each frame's untouched flat remainder
        re-attached afterwards.  Supported on the device backends
        ("jnp", "pallas").
        """
        if self.backend not in ("jnp", "pallas"):
            raise ValueError("batch() requires a device backend ('jnp' or 'pallas')")
        for f in frames:
            if (f.width, f.height) != (self.width, self.height):
                raise ValueError("frame geometry mismatch in batch")
        if not frames:
            return []
        n = len(frames)
        y = np.concatenate([f.y for f in frames], axis=0)
        lmaps = tuple(np.concatenate([m] * n, axis=0) for m in self.luma_maps)
        if self.luma_only:
            # don't build or upload chroma data that would be discarded
            u = v = np.zeros((8, 8), np.uint8)
            ch = cw = 8
            u_views = v_views = [(None, None)] * n
            cmaps = self.chroma_maps
        else:
            # chroma goes through the reference's tile-swept flat view (quirk Q9)
            u_views = [split_covered(np.ascontiguousarray(f.u)) for f in frames]
            v_views = [split_covered(np.ascontiguousarray(f.v)) for f in frames]
            ch, cw = u_views[0][0].shape
            u = np.concatenate([core for core, _ in u_views], axis=0)
            v = np.concatenate([core for core, _ in v_views], axis=0)
            cmaps = tuple(np.concatenate([m] * n, axis=0) for m in self.chroma_maps)

        if self.backend == "pallas":
            from ..ops.pallas_kernel import deblock_frame_pallas_jit as fn
        else:
            fn = _deblock_jit
        yo, uo, vo = fn(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                        lmaps, cmaps, jnp.int32(self.beta), jnp.int32(self.tc),
                        luma_only=self.luma_only)
        yo = np.asarray(jax.device_get(yo))
        uo = np.asarray(jax.device_get(uo))
        vo = np.asarray(jax.device_get(vo))
        hy = frames[0].y.shape[0]
        out = []
        for i, (f, (_, upaste), (_, vpaste)) in enumerate(zip(frames, u_views, v_views)):
            if self.luma_only:
                uf, vf = f.u.copy(), f.v.copy()
            else:
                uf = upaste(uo[i * ch : (i + 1) * ch], np)
                vf = vpaste(vo[i * ch : (i + 1) * ch], np)
            out.append(FramePlanes(
                y=yo[i * hy : (i + 1) * hy], u=uf, v=vf,
                width=self.width, height=self.height,
            ))
        return out

"""Drop-in migration shim: the reference's class API, on this framework.

Users of the reference drive everything through `ReadYuvFrame`
(hevc_deblocking_filter_cpu.h:33-1489): construct from a YV12 file, call
`DeblockingFilter(num_threads)`, optionally inject BS via
`SetBoundaryStrenght` (sic -- the reference's spelling, kept verbatim so
call sites port unchanged), and `Save(path)`.  This module reproduces that
surface exactly on top of the JAX pipeline so a reference user can switch by
changing one import.

    from gpu_video_codec_jax.compat import ReadYuvFrame
    frame = ReadYuvFrame("in.yuv", 352, 288, Qp=35)
    frame.DeblockingFilter()          # fused deblock kernel on the GPU
    frame.Save("out.yuv")

`num_threads` maps to the native CPU backend's OpenMP thread count when
backend="native" (reference semantics, cpu.h:135); for the device backends
the device's full parallelism is always used and the argument is accepted
and ignored, like a GPU user would expect.
"""

from __future__ import annotations

import numpy as np

from .models.pipeline import DeblockPipeline
from .utils.bs import BoundaryStrength
from .utils.yuv import FramePlanes, read_yv12, write_yv12


class ReadYuvFrame:
    """Reference-API frame object (cpu.h:33).  Reads YV12 and deblocks."""

    def __init__(self, file_name: str, width: int, height: int, Qp: int = 20,
                 backend: str = "pallas"):
        # ctor parity: reads the file, validates size/dims, pads planes,
        # initializes all-Intra BS (cpu.h:35-118).  Padding is defined-zero
        # here (quirk Q6) instead of uninitialized heap memory.
        self._frame: FramePlanes = read_yv12(file_name, width, height)
        self._bs = BoundaryStrength.intra_default(width, height)
        self._qp = int(Qp)
        self._backend = backend

    # reference spelling preserved (cpu.h:120)
    def SetBoundaryStrenght(self, vert_bs, num_vert_bs=None, hor_bs=None, num_hor_bs=None):
        """Inject luma BS arrays (cpu.h:120-132).

        Accepts either the 4-arg C-style call (arrays + explicit sizes) or
        the natural 2-arg Python call (vert_bs, hor_bs).
        """
        if hor_bs is None and num_vert_bs is not None:
            # SetBoundaryStrenght(vert, hor) convenience form
            hor_bs = num_vert_bs
            num_vert_bs = None
        vert = np.asarray(vert_bs, np.uint8).ravel()
        hor = np.asarray(hor_bs, np.uint8).ravel()
        if num_vert_bs is not None and vert.size != num_vert_bs:
            raise ValueError("num_vert_bs does not match vert_bs length")
        if num_hor_bs is not None and hor.size != num_hor_bs:
            raise ValueError("num_hor_bs does not match hor_bs length")
        self._bs.set_luma(vert, hor)  # size-checked like the reference

    def DeblockingFilter(self, num_threads: int = 1) -> None:
        """Run the in-loop deblocking filter in place (cpu.h:134)."""
        if self._backend == "native":
            from .runtime.native import deblock_frame_native

            self._frame = deblock_frame_native(
                self._frame, self._bs, self._qp, num_threads=num_threads
            )
            return
        pipe = DeblockPipeline(
            self._frame.width, self._frame.height, self._qp,
            backend=self._backend, bs=self._bs,
        )
        self._frame = pipe(self._frame)

    def Save(self, output_file_name: str) -> None:
        """Write the (filtered) frame back as YV12 (cpu.h:995-1018)."""
        write_yv12(output_file_name, self._frame)

    # pythonic accessors beyond the reference API
    @property
    def planes(self) -> FramePlanes:
        return self._frame


def GetGpuDeviceInfo() -> dict:
    """GetGpuDeviceInfo equivalent (main.cu:92-107): device properties of
    every visible accelerator, returned structured (the reference printed
    name/globalMem/SM-count/warp size to stdout)."""
    from .cli import device_info

    return device_info()


def ExecuteCpu(input_file: str, output_file: str, width: int, height: int,
               Qp: int, thread_counts=(1, 2, 4, 6, 8)) -> dict:
    """Reference ExecuteCpu parity (main.cu:36-83): run the host CPU filter
    at several OpenMP thread counts, timing each, writing the (identical)
    output once per run like the original.  Returns {threads: seconds}."""
    import time

    from .runtime import native

    native.load()  # build/load the runtime OUTSIDE the timed region
    timings: dict[int, float] = {}
    for nt in thread_counts:
        frame = ReadYuvFrame(input_file, width, height, Qp, backend="native")
        t0 = time.perf_counter()
        # native backend honors num_threads (cpu.h:135 parity)
        frame._frame = native.deblock_frame_native(
            frame._frame, frame._bs, frame._qp, num_threads=nt
        )
        timings[nt] = time.perf_counter() - t0
        frame.Save(output_file)
    return timings


def ExecuteGpu(input_file: str, output_file: str, width: int, height: int,
               Qp: int, luma_block=None, chroma_block=None) -> dict:
    """Reference ExecuteGpu parity (gpu.cu:1230-1306): fused-kernel filter
    with caller-chosen per-plane block dims, timing the copy and kernel
    separately like the original's 'with copy' / 'without copy' split.

    Returned keys mirror the reference's brackets honestly:
      kernel_s  -- filter step alone, input already resident (gpu.cu:1266-1291)
      h2d_s     -- host->HBM copy alone (the reference's H2D at gpu.cu:1248-1256;
                   D2H is NOT included in this key, hence the name)
      total_s   -- a MEASURED synchronous put -> filter -> get wall loop, the
                   true analogue of the reference's 'with copy' total
                   (gpu.cu:1246-1303), not a sum of separately-timed parts.
    """
    from .models.streaming import StreamingDeblocker
    from .ops.pallas_kernel import BLOCK_BX, BLOCK_BY, CHROMA_BLOCK

    with open(input_file, "rb") as f:
        raw = f.read(3 * width * height // 2)
    s = StreamingDeblocker(width, height, Qp, backend="pallas",
                           luma_block=tuple(luma_block or (BLOCK_BY, BLOCK_BX)),
                           chroma_block=tuple(chroma_block or CHROMA_BLOCK))
    (out,) = list(s.run([raw]))
    with open(output_file, "wb") as f:
        f.write(out.tobytes())
    tb = s.time_breakdown(raw, n=10, measure_d2h=True)
    return {"kernel_s": tb["kernel_s"], "h2d_s": tb["h2d_s"],
            "total_s": tb["e2e_sync_s"]}

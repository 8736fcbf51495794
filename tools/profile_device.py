"""Device-op profiler: captures a jax.profiler trace of the deblock graphs
and reports per-op DEVICE time (what the hardware actually executed), not
host wall time.

Device-side trace events are recorded on the card's own timeline and are
immune to host dispatch overhead -- the analogue of the reference's
CUDA-event 'without copy' bracket (gpu.cu:1264-1294).

Usage:
    python -m tools.profile_device [--geometry WxH] [--steps N] [--out DIR]

Reports, for one N-step window of each pipeline:
  resident   : ResidentDeblocker.run_steps (kernels only, tile-planes state)
  packed     : N chained packed-YV12 steps (unpack -> kernels -> repack)
  planes     : N chained plane-contract steps (separate y/uv buffers -- the
               reference's actual device format, gpu.cu:1248-1250)
with per-op-category device-time breakdowns (fused deblock kernels vs XLA
copy/transpose/relayout passes vs everything else).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpu_video_codec_jax.utils.tracing import (  # noqa: E402
    categorize_ops as categorize,
    device_op_totals as device_op_durations,
)


def profile_pipelines(w: int = 1920, h: int = 1080, qp: int = 35,
                      steps: int = 20, out_dir: str | None = None,
                      mode: str = "stream") -> dict:
    """Profile the deblock pipelines and report measured device time.

    mode="stream": `steps` INDEPENDENT step dispatches over distinct device
    buffers -- the actual streaming workload (frames are independent), where
    launches pipeline back-to-back.  Per-step device time = total device busy
    time / steps (one TensorCore runs one program at a time, so busy time is
    additive even with overlapped dispatch).
    mode="chain": `steps` dependent steps in one fori_loop dispatch (the
    latency view; includes the loop's carry copies).
    """
    import jax

    from bench.bench_lib import packed_yv12, synthetic_frame
    from gpu_video_codec_jax.models.resident import ResidentDeblocker
    from gpu_video_codec_jax.models.streaming import StreamingDeblocker

    rd = ResidentDeblocker(w, h, qp)
    sd = StreamingDeblocker(w, h, qp)
    k = min(4, steps)  # distinct buffers to defeat any same-args caching
    raws = [packed_yv12(synthetic_frame(w, h, seed=s)) for s in range(k)]
    tfs = [rd.ingest(r) for r in raws]

    if mode == "chain":
        dev0 = sd._put(raws[0])  # _chain does not donate; safe to reuse

        def run_resident():
            return [rd.run_steps(tfs[0], steps)]

        def run_packed():
            return [sd._chain(dev0, steps)]

        run_planes = None
    else:
        # sd._step DONATES its input (in-place packed output): keep a
        # rotating set of chained step outputs instead of reusing inputs
        cells = [sd._step(sd._put(r)) for r in raws]
        pcells = [sd.step_planes(*sd.put_planes(r)) for r in raws]

        def run_resident():
            return [rd.step(tfs[i % k]) for i in range(steps)]

        def run_packed():
            for i in range(steps):
                cells[i % k] = sd._step(cells[i % k])
            return list(cells)

        def run_planes():
            for i in range(steps):
                pcells[i % k] = sd.step_planes(*pcells[i % k])
            return list(pcells)

    # compile everything OUTSIDE the trace windows
    jax.block_until_ready(run_resident())
    jax.block_until_ready(run_packed())
    if run_planes is not None:
        jax.block_until_ready(run_planes())

    base = out_dir or tempfile.mkdtemp(prefix="gvct_prof_")
    report: dict = {"geometry": f"{w}x{h}", "steps": steps, "mode": mode,
                    "trace_dir": base}
    luma_px = w * h
    pipelines = [("resident", run_resident), ("packed", run_packed)]
    if run_planes is not None:
        pipelines.append(("planes", run_planes))
    for label, fn in pipelines:
        d = os.path.join(base, label)
        with jax.profiler.trace(d):
            jax.block_until_ready(fn())
        totals = device_op_durations(d)
        cats = categorize(totals)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:12]
        per_step_us = cats["total"] / steps
        report[label] = {
            "device_us_per_step": {k2: round(v / steps, 2) for k2, v in cats.items()},
            "device_mpix_s": round(luma_px / per_step_us, 1) if per_step_us else None,
            "top_ops_us_total": {k2: round(v, 1) for k2, v in top},
        }
    return report


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", default="1920x1080")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mode", choices=("stream", "chain"), default="stream")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    gw, gh = (int(x) for x in a.geometry.split("x"))
    print(json.dumps(profile_pipelines(gw, gh, steps=a.steps, out_dir=a.out,
                                       mode=a.mode), indent=2))

"""Device-trace timing: measure what the card executed, not host wall.

The reference brackets its GPU timing with CUDA events around an explicit
synchronize (gpu.cu:1264-1294) -- device execution time.  The equivalent
here is JAX's profiler trace: per-kernel events recorded on the device's
own timeline, immune to host dispatch overhead and async-queue depth.

A GPU device process ("/device:GPU:0") carries one line per CUDA stream
("Stream #N(...)") plus lines derived from them ("XLA Ops", "XLA Modules",
...) that repeat the same intervals.  Only the stream lines are counted,
so each interval counts once.

API:
  with jax.profiler.trace(d): ...         (stock JAX)
  device_op_totals(d)   -> {op_name: total_us} for device-lane LEAF events
  device_busy_us(d)     -> (busy, span) of the device-event intervals (us)
  categorize_ops(totals)-> {deblock_kernels, layout_and_copies, other, total}
  profiled_device_us(thunk, iters) -> (per_iter_us, cats, top_ops), None
                           on the CPU backend (no device lanes); raises on
                           a GPU backend whose trace has no device lanes
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import tempfile
from collections import defaultdict

# control/module scopes are not hardware ops; they also live on separate
# trace tracks where per-track nesting can't catch them
_SCOPES = ("jit_", "jit__", "while", "condition", "body", "cond_")

# stable kernel names (pallas_call name=...) of the deblock kernels
KERNEL_NAMES = ("deblock_luma", "deblock_chroma")


def _load_trace_events(trace_dir: str) -> list[dict]:
    """Read every Chrome-trace event from a jax.profiler trace directory."""
    pats = os.path.join(trace_dir, "**", "*.trace.json.gz")
    events: list[dict] = []
    for path in glob.glob(pats, recursive=True):
        with gzip.open(path, "rt") as f:
            data = json.load(f)
        events.extend(data.get("traceEvents", []))
    return events


def _device_tracks(trace_dir: str) -> list[list[dict]]:
    """Complete events of the device lanes, one list per counted track.

    Device processes are named "/device:<KIND>:<n>".  Where a device has
    stream lines, only those count; the derived lines repeat them."""
    events = _load_trace_events(trace_dir)
    pid_names: dict[int, str] = {}
    tid_names: dict[tuple, str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = e.get("args", {}).get("name", "")
        if e.get("name") == "process_name":
            pid_names[e["pid"]] = name
        elif e.get("name") == "thread_name":
            tid_names[(e["pid"], e.get("tid", 0))] = name
    device_pids = {pid for pid, name in pid_names.items()
                   if "/device:" in name.lower()}
    by_track: dict[tuple, list[dict]] = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") in device_pids
                and not str(e.get("name", "")).startswith(_SCOPES)):
            by_track[(e["pid"], e.get("tid", 0))].append(e)
    streams = {k for k in by_track
               if tid_names.get(k, "").startswith("Stream")}
    stream_pids = {pid for pid, _ in streams}
    return [track for k, track in by_track.items()
            if k in streams or k[0] not in stream_pids]


def device_op_totals(trace_dir: str) -> dict[str, float]:
    """Sum device-lane LEAF complete-event durations (us) by op name.

    Container events (module/control scopes) enclose their children on the
    same track, so summing every event double-counts; leaf-only = events
    that contain no other event on their track."""
    totals: dict[str, float] = defaultdict(float)
    for track in _device_tracks(trace_dir):
        track.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: list[tuple[float, dict]] = []  # (end_ts, event) of open spans
        has_child: dict[int, bool] = {}

        def _close(parent):
            if not has_child.pop(id(parent), False):
                totals[parent.get("name", "?")] += float(parent.get("dur", 0.0))

        for e in track:
            ts = float(e["ts"])
            while stack and stack[-1][0] <= ts:
                _close(stack.pop()[1])
            if stack:
                has_child[id(stack[-1][1])] = True
            stack.append((ts + float(e.get("dur", 0.0)), e))
            has_child[id(e)] = False
        while stack:
            _close(stack.pop()[1])
    return dict(totals)


def device_busy_us(trace_dir: str) -> tuple[float, float]:
    """(busy, span) in us: the union of the device-event intervals (time in
    which at least one operation ran on a device) and the span from the
    first event's start to the last one's end.  Idle share of the traced
    steady window = 1 - busy / span."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for track in _device_tracks(trace_dir) for e in track)
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t <= end:
            continue
        busy += t - max(s, end)
        end = t
    return busy, end - spans[0][0]


def categorize_ops(totals: dict[str, float]) -> dict[str, float]:
    """Bucket op names into deblock-kernel vs layout/copy vs other."""
    cats: dict[str, float] = defaultdict(float)
    for name, us in totals.items():
        n = name.lower()
        if n.startswith(_SCOPES):
            cats["scopes_should_be_empty"] += us
        elif any(k in n for k in KERNEL_NAMES):
            cats["deblock_kernels"] += us
        elif any(k in n for k in ("copy", "transpose", "bitcast", "reshape",
                                  "concatenate", "pad", "slice", "fusion",
                                  "convert", "convolution", "dot", "memcpy",
                                  "memset", "gemm")):
            cats["layout_and_copies"] += us
        else:
            cats["other"] += us
    cats["total"] = sum(v for k, v in cats.items() if k != "total")
    return dict(cats)


def profiled_device_us(thunk, iters: int = 20, trace_dir: str | None = None):
    """Run `thunk()` (returning a jax array or pytree) `iters` times under a
    profiler trace; return (device_us_per_iter, categories, top_ops) from
    device-lane leaf events.

    On the CPU backend there are no device lanes and this returns None
    (callers then report host wall time, labelled as CPU).  On any other
    backend a trace without device lanes is an error: a missing device
    must not turn into a wall-clock number."""
    import jax

    from .compile_cache import REPO_ROOT

    if trace_dir is None:
        # inside the checkout (git-ignored), removed after the reduction
        root = os.path.join(REPO_ROOT, ".traces")
        os.makedirs(root, exist_ok=True)
        d = tempfile.mkdtemp(prefix="trace_", dir=root)
    else:
        d = trace_dir
    last = None
    try:
        with jax.profiler.trace(d):
            for _ in range(iters):
                last = thunk()
            jax.block_until_ready(last)
        totals = device_op_totals(d)
    finally:
        if trace_dir is None:
            shutil.rmtree(d, ignore_errors=True)
    if not totals:
        platform = jax.default_backend()
        if platform == "cpu":
            return None
        raise RuntimeError(
            f"profiler trace has no device lanes on platform {platform!r}")
    cats = {k: v / iters for k, v in categorize_ops(totals).items()}
    top = {k: round(v / iters, 2)
           for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:12]}
    return cats["total"], cats, top

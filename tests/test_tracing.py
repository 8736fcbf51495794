"""utils/tracing.py: device-lane leaf accounting over synthetic Chrome-trace
events.  This logic underpins every kernel-time claim in the benchmarks
(PERF.md), so its edge cases -- container nesting, scope filtering,
host-lane exclusion, derived GPU lines -- are pinned here without needing
a device."""

import gzip
import json
import os

from gpu_video_codec_jax.utils.tracing import (
    categorize_ops, device_busy_us, device_op_totals,
)


def _write_trace(tmp_path, events):
    d = tmp_path / "plugins" / "profile" / "run1"
    d.mkdir(parents=True)
    with gzip.open(os.path.join(d, "host.trace.json.gz"), "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}


def _ev(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name,
            "ts": ts, "dur": dur}


def test_leaf_only_no_double_count(tmp_path):
    """A container op enclosing children on the same track must NOT add its
    own duration (summing every event would double-count)."""
    events = [
        _meta(1, "/device:GPU:0"),
        _ev(1, 0, "fusion", 0.0, 100.0),        # container
        _ev(1, 0, "copy", 10.0, 30.0),          # leaf inside
        _ev(1, 0, "reshape", 50.0, 20.0),       # leaf inside
        _ev(1, 0, "dot", 200.0, 40.0),          # separate leaf
    ]
    totals = device_op_totals(_write_trace(tmp_path, events))
    assert totals == {"copy": 30.0, "reshape": 20.0, "dot": 40.0}


def test_host_lanes_excluded(tmp_path):
    events = [
        _meta(1, "/device:GPU:0"),
        _meta(2, "python"),
        _ev(1, 0, "dot", 0.0, 10.0),
        _ev(2, 0, "dispatch", 0.0, 9999.0),  # host work: ignored
    ]
    totals = device_op_totals(_write_trace(tmp_path, events))
    assert totals == {"dot": 10.0}


def test_scopes_filtered(tmp_path):
    """jit_/while/body module+control scopes are not hardware ops; they can
    live on separate tracks where nesting can't catch them."""
    events = [
        _meta(1, "/device:GPU:0"),
        _ev(1, 0, "jit_step", 0.0, 500.0),
        _ev(1, 1, "while", 0.0, 500.0),   # other track: nesting won't help
        _ev(1, 1, "dot", 10.0, 50.0),
        _ev(1, 0, "copy", 20.0, 5.0),
    ]
    totals = device_op_totals(_write_trace(tmp_path, events))
    assert totals == {"dot": 50.0, "copy": 5.0}


def test_same_name_leafs_sum_across_tracks(tmp_path):
    events = [
        _meta(1, "/device:GPU:0"),
        _ev(1, 0, "dot", 0.0, 10.0),
        _ev(1, 1, "dot", 0.0, 15.0),
        _ev(1, 0, "dot", 100.0, 25.0),
    ]
    totals = device_op_totals(_write_trace(tmp_path, events))
    assert totals == {"dot": 50.0}


def test_categorize_buckets():
    cats = categorize_ops({
        "deblock_luma": 10.0,
        "deblock_chroma": 5.0,
        "copy.1": 7.0,
        "loop_pad_fusion_3": 3.0,
        "rng-something": 2.0,
    })
    assert cats["deblock_kernels"] == 15.0
    assert cats["layout_and_copies"] == 10.0
    assert cats["other"] == 2.0
    assert cats["total"] == 27.0


def test_empty_trace_dir(tmp_path):
    assert device_op_totals(str(tmp_path)) == {}


def _thread(pid, tid, name):
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _gpu_shaped_trace(tmp_path):
    """The shape of an H100 trace: one stream line with the kernels, plus
    derived "XLA Ops" / "XLA Modules" lines repeating the same intervals."""
    return _write_trace(tmp_path, [
        _meta(1, "/device:GPU:0"), _meta(2, "/host:CPU"),
        _thread(1, 13, "Stream #13(Compute)"),
        _thread(1, 100, "XLA Ops"), _thread(1, 101, "XLA Modules"),
        _ev(1, 13, "deblock_luma", 0.0, 6.0),
        _ev(1, 13, "loop_pad_fusion_3", 10.0, 4.0),
        _ev(1, 13, "deblock_chroma", 20.0, 2.5),
        _ev(1, 100, "deblock_luma", 0.0, 6.0),
        _ev(1, 100, "loop_pad_fusion_3", 10.0, 4.0),
        _ev(1, 100, "deblock_chroma", 20.0, 2.5),
        _ev(1, 101, "packed_step", 0.0, 22.5),
        _ev(2, 0, "PjitFunction(step)", 0.0, 50.0),
    ])


def test_gpu_derived_lines_not_double_counted(tmp_path):
    """Only the stream line counts; "XLA Ops"/"XLA Modules" repeat it."""
    d = _gpu_shaped_trace(tmp_path)
    totals = device_op_totals(d)
    assert totals == {"deblock_luma": 6.0, "loop_pad_fusion_3": 4.0,
                      "deblock_chroma": 2.5}
    cats = categorize_ops(totals)
    assert cats["deblock_kernels"] == 8.5 and cats["layout_and_copies"] == 4.0


def test_gpu_busy_and_span(tmp_path):
    """Busy time is the union of the stream intervals (12.5 us) over a
    22.5 us span from the first start to the last end."""
    assert device_busy_us(_gpu_shaped_trace(tmp_path)) == (12.5, 22.5)
    assert device_busy_us(str(tmp_path / "empty")) == (0.0, 0.0)

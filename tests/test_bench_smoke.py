"""Bench harness smoke tests on CPU (tiny geometry): keeps the harness from
bit-rotting.  Real numbers come from GPU runs (bench.py, chip_smoke.py)."""

import json

import pytest


def test_bench_stream_smoke():
    from bench.bench_lib import bench_stream

    r = bench_stream(64, 48, backend="jnp", n_frames=4, repeats=1)
    assert r["kernel_us"] > 0 and r["pipelined_mpix_s"] > 0
    json.dumps(r)  # serializable


def test_headline_shape_contract(monkeypatch):
    """bench.py must emit the driver's expected keys (incl. the honesty kit:
    sustained rate, link microbench, resident step, 4K rows)."""
    from bench import bench_lib

    # monkeypatch the geometry down so the contract test runs on CPU
    # (capture the originals first -- the lambdas must not recurse)
    orig_soak, orig_link, orig_res, orig_df, orig_pl = (
        bench_lib.soak, bench_lib.link_h2d_microbench, bench_lib.bench_resident,
        bench_lib.bench_device_fed, bench_lib.bench_planes)
    monkeypatch.setattr(bench_lib, "bench_1080p", lambda **kw: bench_lib.bench_stream(
        64, 48, backend="jnp", n_frames=4, repeats=1))
    monkeypatch.setattr(bench_lib, "soak", lambda **kw: orig_soak(n_frames=8, w=64, h=48))
    monkeypatch.setattr(bench_lib, "link_h2d_microbench",
                        lambda **kw: orig_link(mb=0.01, n=4, repeats=1))
    monkeypatch.setattr(bench_lib, "bench_resident",
                        lambda **kw: orig_res(w=64, h=48, iters=3))
    monkeypatch.setattr(bench_lib, "bench_device_fed",
                        lambda w=64, h=48, **kw: orig_df(w=64, h=48, k=2,
                                                         n_steps=4, repeats=1))
    monkeypatch.setattr(bench_lib, "bench_planes",
                        lambda w=64, h=48, **kw: orig_pl(w=64, h=48, k=2, iters=3))
    out = bench_lib.headline()
    assert set(out) >= {"metric", "value", "unit", "vs_baseline"}
    for key in ("sustained_mpix_s", "link_h2d_gbs", "resident_step_us",
                "pipelined_mpix_s", "device_fed_overlap",
                "planes_full_graph", "planes_vs_baseline",
                "device_fed_4k", "planes_4k"):
        assert key in out["details"], key
    assert "vs_north_star" not in out["details"]  # no divisor of another device
    # headline contract: value IS the packed full-graph rate and the metric
    # says so (the resident kernel-only rate stays in details)
    assert "packed full graph" in out["metric"]
    assert out["vs_baseline"] == round(out["value"] / bench_lib.REF_KERNEL_MPIX_S, 2)
    line = json.dumps(out)
    assert line.startswith("{") and "\n" not in line


def _representative_headline() -> dict:
    """assemble_headline fed device-magnitude inputs (digit counts matter
    for the size bound, values don't)."""
    from bench.bench_lib import assemble_headline

    r = {"kernel_us": 132.84, "h2d_us": 2154.3, "dispatch_us": 3891.2,
         "kernel_mpix_s": 15611.4, "pipelined_mpix_s": 21.34,
         "pipelined_fps": 10.29,
         "device_split_us": {"deblock_kernels": 25.51,
                             "layout_and_copies": 107.33}}
    resident = {"step_us": 26.06, "mpix_s": 79566.0, "dispatch_us": 496.32}
    devfed = {"wall_us_per_frame": 533.21, "wall_mpix_s": 3889.3,
              "device_us_per_frame": 133.55, "device_mpix_s": 15527.4,
              "wire_gbs_to_sustain_device_rate": 23.284}
    devfed4k = {"wall_us_per_frame": 2133.21, "wall_mpix_s": 3889.3,
                "device_us_per_frame": 533.55, "device_mpix_s": 15547.4,
                "wire_gbs_to_sustain_device_rate": 23.314}
    planes = {"device_us_per_frame": 101.91, "device_mpix_s": 20348.1,
              "device_split_us": {"deblock_kernels": 25.51,
                                  "layout_and_copies": 76.4}}
    planes4k = {"device_us_per_frame": 502.44, "device_mpix_s": 16510.9,
                "device_split_us": {"deblock_kernels": 101.2,
                                    "layout_and_copies": 401.2}}
    link = {"gb_s": 1.624}
    sk = {"sustained_mpix_s": 102.3, "frames": 400}
    return assemble_headline(r, resident, devfed, planes, link, sk,
                             devfed4k, planes4k)


def test_headline_fits_driver_capture():
    """Round-3 failure mode, pinned forever: the driver records only the
    last 2000 bytes of bench.py stdout, and a headline once grew past that
    and parsed as null.  The assembled record with device-magnitude numbers
    must serialize well under the window."""
    line = json.dumps(_representative_headline())
    assert len(line) < 1900, f"headline JSON {len(line)} bytes >= 1900"


def test_headline_assembly_is_numeric():
    """No multi-sentence prose in the record: every string value is short
    (notes live in docs/PERF.md)."""
    out = _representative_headline()

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, str):
            assert len(x) <= 120, f"prose leaked into headline: {x[:60]}..."

    walk(out)
    assert out["value"] == 15611.4
    assert out["details"]["device_fed_4k"]["device_mpix_s"] == 15547.4


def test_bench_device_fed_smoke():
    """Device-fed overlap harness: runs the real donated-step machinery on
    pre-staged device frames and reports wall + device rates (structure
    check on CPU, where the device numbers are host wall time)."""
    from bench.bench_lib import bench_device_fed

    r = bench_device_fed(w=64, h=48, k=2, n_steps=6, repeats=1)
    assert r["wall_mpix_s"] > 0 and r["device_mpix_s"] > 0
    assert r["clock"] == "cpu_wall"
    assert r["wire_gbs_to_sustain_device_rate"] >= 0
    json.dumps(r)


def test_synthetic_frame_deterministic():
    from bench.bench_lib import synthetic_frame

    import numpy as np

    a = synthetic_frame(64, 48)
    b = synthetic_frame(64, 48)
    assert np.array_equal(a.y, b.y)


def test_soak_smoke():
    from bench.bench_lib import soak

    r = soak(n_frames=8, w=64, h=48)
    assert r["frames"] == 8 and r["sustained_fps"] > 0
    assert len(r["segment_s"]) == 4


@pytest.mark.slow
def test_autotune_smoke():
    """The kernel autotune needs device time: on CPU it refuses."""
    import bench.bench_lib as bl

    with pytest.raises(RuntimeError, match="needs a GPU"):
        bl.autotune_kernel(w=64, h=48, configs=((64, 2),), iters=2)


@pytest.mark.slow
def test_reference_cpu_bench_rows():
    """bench_reference_cpu compiles the actual reference and returns timed
    same-host rows (or a graceful error row when the checkout is absent)."""
    from bench.bench_lib import bench_reference_cpu

    rows = bench_reference_cpu(thread_counts=(1,), reps=1,
                               geometries=((64, 48, "tiny"),))
    assert rows
    if "error" not in rows[0]:
        assert rows[0]["filter_s"] > 0 and "compiled reference" in rows[0]["config"]


def test_multistream_bench_mesh_branch():
    """bench_4k_multistream takes the mesh-sharded branch on the 8-device
    virtual CPU mesh (tiny stand-in geometry)."""
    from bench.bench_lib import bench_4k_multistream

    r = bench_4k_multistream(n_streams=2, frames_per_stream=2, w=64, h=48)
    assert "sharded over 8 devices" in r["config"]
    assert r["mpix_s"] > 0


def test_multistream_1chip_bench():
    """bench_multistream_1chip drives MultiStreamDeblocker on a 1x1 mesh
    (round-4 verdict item 5): the staged H2D buffer must be exactly the
    packed bytes (n_streams x 3wh/2 -- nothing extended, nothing host-padded)
    and the overlapped wall loop must produce a rate."""
    from bench.bench_lib import bench_multistream_1chip

    r = bench_multistream_1chip(n_streams=2, w=64, h=48, n_batches=2,
                                backend="jnp", repeats=1)
    assert r["h2d_bytes_per_batch"] == 2 * (3 * 64 * 48 // 2)
    assert r["wall_mpix_s"] > 0
    assert "1x1 mesh" in r["config"]
    json.dumps(r)


@pytest.mark.slow
def test_cpu_interleaved_bench():
    """Interleaved native-vs-compiled-reference rows: structure + the
    1-core caveat annotation (round-2 verdict weak #4).  Tiny geometry,
    1 thread, few reps to keep it bounded."""
    from bench.bench_lib import bench_cpu_interleaved

    r = bench_cpu_interleaved(thread_counts=(1,), reps=2,
                              geometries=((64, 48, "tiny"),))
    if "error" in r:
        pytest.skip(r["error"])
    assert r["host_cpu_cores"] >= 1 and "caveat" in r
    row = r["rows"][0]
    assert row["native_s"] > 0 and row["reference_s"] > 0
    assert row["native_over_reference"] == round(
        row["reference_s"] / row["native_s"], 3)

#!/usr/bin/env python
"""End-to-end smoke test of the deblocking system on NVIDIA GPUs.

    python chip_smoke.py           # one card: main path, correctness, races
    python chip_smoke.py --four    # four cards: the mesh paths only

One card: writes seeded YV12 streams (8 frames of 1920x1080, 2 frames of
3840x2160) under --out, runs every entry point a user calls -- the CLI with
its default backend, StreamingDeblocker.run and step_planes,
ResidentDeblocker on a 16-frame batch, DeblockPipeline on each device
backend, MultiStreamDeblocker on a 1x1 mesh, and the bundled testdata/
frames -- and compares every output byte for byte with the native C++
backend on every frame and with the golden model (models/golden.py) on one
frame per geometry.  The filter is integer-only, so the tolerance is zero.
Then it measures: the deblock kernel against the same math compiled by
XLA, the transpose against the mxu relayout engine, and one profiler trace
of the packed 1080p step split by layer, with its memory analysis.

Four cards (--four): MultiStreamDeblocker with 4 streams of 1080p (the
frames-parallel path) and 6 streams on a 2x2 mesh (the slab fallback),
MeshResidentDeblocker, and deblock_batch_sharded, each compared byte for
byte with the one-card output.

Numbers go on earlier lines; the last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.  A
phase that fails raises, so the script exits non-zero and prints no
result -- also when JAX finds no GPU, and when the package is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
QP = 35
STREAMS = ((1920, 1080, 8), (3840, 2160, 2))
FOUR = (1920, 1080)  # geometry of the four-card paths
TESTDATA = (("image1_352x288_yv12.yuv", 352, 288),
            ("mother-daughter_352x288_yv12.yuv", 352, 288),
            ("image2_768x576.yuv", 768, 576))


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _frames(w: int, h: int, n: int, seed0: int = 0) -> list[bytes]:
    """n seeded packed YV12 frames (gradients plus noise, so the strong and
    normal filters both fire at QP 35)."""
    from bench.bench_lib import packed_yv12, synthetic_frame

    return [packed_yv12(synthetic_frame(w, h, seed=seed0 + i)).tobytes()
            for i in range(n)]


def _native(raw: bytes, w: int, h: int) -> bytes:
    from gpu_video_codec_jax.models.pipeline import DeblockPipeline
    from gpu_video_codec_jax.utils.yuv import (
        planes_from_yv12_bytes, yv12_bytes_from_planes,
    )

    pipe = DeblockPipeline(w, h, QP, backend="native")
    return yv12_bytes_from_planes(pipe(planes_from_yv12_bytes(raw, w, h)))


def _golden(raw: bytes, w: int, h: int) -> bytes:
    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import (
        planes_from_yv12_bytes, yv12_bytes_from_planes,
    )

    frame = planes_from_yv12_bytes(raw, w, h)
    return yv12_bytes_from_planes(
        deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), QP))


def _same(got, want: list[bytes], what: str) -> None:
    """Byte equality of each output frame with its reference frame."""
    import numpy as np

    got = [np.asarray(g, np.uint8).tobytes() if not isinstance(g, bytes) else g
           for g in got]
    _check(len(got) == len(want), f"{what}: {len(got)} frames, want {len(want)}")
    for i, (g, r) in enumerate(zip(got, want)):
        _check(g == r, f"{what}: frame {i} differs from the reference")


def _cli(path: str, w: int, h: int, out: str) -> list[bytes]:
    from gpu_video_codec_jax import cli

    rc = cli.main(["-i", path, "-W", str(w), "-H", str(h), "--qp", str(QP),
                   "-o", out])
    _check(rc == 0, f"cli.main returned {rc} on {path}")
    fb = 3 * w * h // 2
    with open(out, "rb") as f:
        data = f.read()
    return [data[i:i + fb] for i in range(0, len(data), fb)]


def phase_device() -> dict:
    import jax

    from bench.bench_lib import gpu_name_and_power_limit

    devs = jax.devices()
    platform = devs[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX's platform is {platform!r}, not gpu")
    smi = gpu_name_and_power_limit()
    _check(smi is not None, "nvidia-smi did not report a card")
    print(f"card: {smi}", flush=True)
    return {"platform": platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_main_path(out_dir: str) -> None:
    """Every single-card entry point at real size, against native on every
    frame and golden on one frame per geometry."""
    import jax
    import numpy as np

    from gpu_video_codec_jax.models.pipeline import DeblockPipeline
    from gpu_video_codec_jax.models.resident import ResidentDeblocker
    from gpu_video_codec_jax.models.streaming import StreamingDeblocker
    from gpu_video_codec_jax.parallel import MultiStreamDeblocker, make_mesh
    from gpu_video_codec_jax.utils.yuv import (
        planes_from_yv12_bytes, yv12_bytes_from_planes,
    )

    for w, h, n in STREAMS:
        t0 = time.perf_counter()
        raws = _frames(w, h, n)
        path = os.path.join(out_dir, f"in_{w}x{h}.yuv")
        with open(path, "wb") as f:
            f.write(b"".join(raws))
        want = [_native(r, w, h) for r in raws]
        _check(_golden(raws[0], w, h) == want[0],
               f"native != golden on frame 0 at {w}x{h}")
        _check(want[0] != raws[0], f"the filter changed nothing at {w}x{h}")

        _same(_cli(path, w, h, os.path.join(out_dir, f"out_{w}x{h}.yuv")),
              want, f"cli {w}x{h}")

        s = StreamingDeblocker(w, h, QP)
        _same(list(s.run(raws)), want, f"StreamingDeblocker.run {w}x{h}")
        planes = []
        for raw in raws:
            y, uv = s.step_planes(*s.put_planes(raw))
            planes.append(np.concatenate([jax.device_get(y).ravel(),
                                          jax.device_get(uv).ravel()]))
        _same(planes, want, f"StreamingDeblocker.step_planes {w}x{h}")

        for backend in ("jnp", "pallas"):
            pipe = DeblockPipeline(w, h, QP, backend=backend)
            _same([yv12_bytes_from_planes(pipe(planes_from_yv12_bytes(r, w, h)))
                   for r in raws], want, f"DeblockPipeline[{backend}] {w}x{h}")

        ms = MultiStreamDeblocker(make_mesh(1, 1), n, w, h, QP, backend="pallas")
        _same(ms.step(raws), want, f"MultiStreamDeblocker 1x1 {w}x{h}")

        if (w, h) == (1920, 1080):
            rd = ResidentDeblocker(w, h, QP)
            batch = np.stack([np.frombuffer(r, np.uint8) for r in raws + raws])
            _same(list(rd(batch)), want + want, "ResidentDeblocker 16x1080p")
        _say("main_path", geometry=f"{w}x{h}", frames=n, native_equal=True,
             golden_frames=1, seconds=round(time.perf_counter() - t0, 1))


def phase_testdata(out_dir: str) -> None:
    """The bundled frames through the CLI's default backend."""
    for name, w, h in TESTDATA:
        path = os.path.join(REPO, "testdata", name)
        with open(path, "rb") as f:
            raw = f.read()
        want = _native(raw, w, h)
        _check(_golden(raw, w, h) == want, f"native != golden on {name}")
        _same(_cli(path, w, h, os.path.join(out_dir, "out_" + name)), [want],
              f"cli {name}")
    _say("testdata", files=len(TESTDATA), native_equal=True, golden_equal=True)


def phase_measure() -> None:
    """Device-trace races and the split by layer (numbers only; every race
    byte-compares its contenders first)."""
    from bench import bench_lib as bl

    for w, h, _ in STREAMS:
        _say("race_kernel_vs_xla", **bl.race_kernel_vs_xla(w, h))
    _say("race_packed_step_1080p", **bl.race_packed_step(1920, 1080))
    # the mxu engine's bf16 dot mode is the only float path: its one-hot
    # products of values <= 255, accumulated in f32, are exact whatever the
    # matmul precision; this race runs the default u8 mode
    _say("race_relayout_1080p", **bl.race_relayout(1920, 1080))
    split = bl.layer_split(1920, 1080)
    mem = split.pop("memory_analysis")
    _say("layer_split_1080p", **split)
    print(f"memory_analysis packed 1080p step: {mem}", flush=True)


def phase_four(out_dir: str) -> None:
    """The mesh paths on four cards against the one-card output."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpu_video_codec_jax.models.streaming import StreamingDeblocker
    from gpu_video_codec_jax.ops.tables import get_beta, get_tc
    from gpu_video_codec_jax.parallel import (
        MeshResidentDeblocker, MultiStreamDeblocker, make_mesh,
    )
    from gpu_video_codec_jax.parallel.mesh import deblock_batch_sharded_jit
    from gpu_video_codec_jax.utils.bs import (
        BoundaryStrength, chroma_segment_maps, luma_segment_maps,
    )
    from gpu_video_codec_jax.utils.yuv import planes_from_yv12_bytes

    _check(len(jax.devices()) == 4, f"--four needs 4 cards, JAX sees "
                                    f"{len(jax.devices())}")
    w, h = FOUR
    raws = _frames(w, h, 8)
    with jax.default_device(jax.devices()[0]):
        one = list(StreamingDeblocker(w, h, QP).run(raws))
    one = [np.asarray(o).tobytes() for o in one]

    t0 = time.perf_counter()
    ms = MultiStreamDeblocker(make_mesh(4, 1), 4, w, h, QP, backend="pallas")
    _check(ms._frames_fast, "4 streams on 4 cards should take the frames-parallel path")
    _same(ms.step(raws[:4]) + ms.step(raws[4:]), one,
          "MultiStreamDeblocker 4 streams, 4x1 mesh")
    ms = MultiStreamDeblocker(make_mesh(2, 2), 6, w, h, QP, backend="pallas")
    _check(not ms._frames_fast, "6 streams on 4 cards should take the slab path")
    _same(ms.step(raws[:6]), one[:6], "MultiStreamDeblocker 6 streams, 2x2 mesh")

    mrd = MeshResidentDeblocker(make_mesh(4, 1), w, h, QP)
    _same(list(mrd(raws)), one, "MeshResidentDeblocker 8 frames, 4x1 mesh")

    frames = [planes_from_yv12_bytes(r, w, h) for r in raws[:4]]
    bs = BoundaryStrength.intra_default(w, h)
    yo, uo, vo = deblock_batch_sharded_jit(
        make_mesh(2, 2), *(jnp.asarray(np.stack([getattr(f, k) for f in frames]))
                           for k in "yuv"),
        luma_segment_maps(bs), chroma_segment_maps(bs), get_beta(QP), get_tc(QP))
    yo, uo, vo = (jax.device_get(a) for a in (yo, uo, vo))
    p, cw, ch = 4, w // 2, h // 2
    got = [b"".join(np.ascontiguousarray(a).tobytes() for a in (
        yo[i, p:p + h, p:p + w], uo[i, p:p + ch, p:p + cw],
        vo[i, p:p + ch, p:p + cw])) for i in range(4)]
    _same(got, one[:4], "deblock_batch_sharded 4 frames, 2x2 mesh")
    _say("four_cards", frames=8, one_card_equal=True,
         paths=["multistream_4x1_frames_parallel", "multistream_2x2_slab",
                "mesh_resident_4x1", "deblock_batch_sharded_2x2"],
         seconds=round(time.perf_counter() - t0, 1))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--out", default=os.path.join(REPO, ".smoke"),
                    help="directory for the generated streams (removed after)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "gpu_video_codec_jax")):
        print("chip_smoke: the gpu_video_codec_jax package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gpu_video_codec_jax.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    device = phase_device()
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        if args.four:
            phase_four(args.out)
        else:
            phase_main_path(args.out)
            phase_testdata(args.out)
            phase_measure()
    finally:
        shutil.rmtree(args.out, ignore_errors=True)
    _say("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

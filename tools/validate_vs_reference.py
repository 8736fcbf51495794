#!/usr/bin/env python
"""End-of-chain validation: diff this framework's golden model against the
ACTUAL reference implementation, compiled from the read-only reference mount.

The reference's CPU path (hevc_deblocking_filter_cpu.h) is portable C++; this
tool compiles a tiny driver against it (no reference code is copied into this
repository -- the header is included straight from REF_DIR at build time),
runs it on the bundled frames across QPs, and byte-compares with our golden.

Result on this machine: byte-IDENTICAL on all bundled frames at QPs
20/27/35/51 -- including the border band, i.e. the reference's uninitialized
padding reads zeros under glibc fresh allocations, matching our defined
padding == 0 (quirk Q6).

Usage: python tools/validate_vs_reference.py [REF_DIR]
       python tools/validate_vs_reference.py --fuzz [N] [SEED] [MAX_W] [MAX_H] [REF_DIR]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_REF = "/root/reference/hevc_deblocking_filter"

DRIVER = r"""
// Validation driver: runs the REFERENCE CPU implementation (included from
// the read-only reference checkout) on one YV12 frame.  Optional 6th arg
// `seed` injects pseudo-random luma BS via SetBoundaryStrenght using an
// LCG the python side replicates (exercises the injection path too).
#include "hevc_deblocking_filter_cpu.h"
#include <chrono>
#include <cstdlib>
#include <cstdio>
#include <vector>
int main(int argc, char **argv) {
    if (argc != 6 && argc != 7) {
        fprintf(stderr, "usage: %s in w h qp out [seed]\n", argv[0]);
        return 2;
    }
    unsigned int w = atoi(argv[2]), h = atoi(argv[3]);
    try {
        ReadYuvFrame frame(argv[1], w, h, atoi(argv[4]));
        if (argc == 7) {
            unsigned long long s = strtoull(argv[6], nullptr, 10);
            unsigned int nv = (w / 8 + 1) * (h / 8);
            unsigned int nh = (h / 8 + 1) * (w / 8);
            std::vector<unsigned char> v(nv), hh(nh);
            for (unsigned int i = 0; i < nv; i++) {
                s = s * 6364136223846793005ULL + 1442695040888963407ULL;
                v[i] = (unsigned char)((s >> 33) % 3);
            }
            for (unsigned int i = 0; i < nh; i++) {
                s = s * 6364136223846793005ULL + 1442695040888963407ULL;
                hh[i] = (unsigned char)((s >> 33) % 3);
            }
            frame.SetBoundaryStrenght(v.data(), nv, hh.data(), nh);
        }
        // REF_THREADS exercises the reference's OpenMP path (cpu.h:135);
        // tiles are independent so output must not depend on thread count
        const char *t = getenv("REF_THREADS");
        int nthreads = t ? atoi(t) : 1;
        // REF_BENCH_REPS=N: time the filter like main.cu:41-43 does (bracket
        // around DeblockingFilter only; frame re-read outside the bracket),
        // best-of-N, printed as "BENCH <seconds>" for the bench harness.
        const char *reps_env = getenv("REF_BENCH_REPS");
        if (reps_env) {
            int reps = atoi(reps_env);
            double best = 1e30;
            for (int i = 0; i < reps; i++) {
                ReadYuvFrame f2(argv[1], w, h, atoi(argv[4]));
                auto t0 = std::chrono::steady_clock::now();
                f2.DeblockingFilter(nthreads);
                std::chrono::duration<double> dt =
                    std::chrono::steady_clock::now() - t0;
                if (dt.count() < best) best = dt.count();
            }
            printf("BENCH %.9f\n", best);
        }
        frame.DeblockingFilter(nthreads);
        frame.Save(argv[5]);
    } catch (const char *e) { fprintf(stderr, "error: %s\n", e); return 1; }
    return 0;
}
"""


def _lcg_bs(seed: int, nv: int, nh: int):
    """Python twin of the driver's LCG BS generator."""
    import numpy as np

    s = seed & 0xFFFFFFFFFFFFFFFF
    out = []
    for n in (nv, nh):
        a = np.empty(n, np.uint8)
        for i in range(n):
            s = (s * 6364136223846793005 + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
            a[i] = (s >> 33) % 3
        out.append(a)
    return out

CASES = [
    # (file, w, h, qp, bs_seed or None for the default all-Intra BS)
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 35, None),  # committed workload
    ("image1_352x288_yv12.yuv", 352, 288, 35, None),
    ("image2_768x576.yuv", 768, 576, 35, None),
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 20, None),
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 51, None),
    ("image2_768x576.yuv", 768, 576, 27, None),
    # injected-BS cases: exercise SetBoundaryStrenght vs our bs.set_luma
    ("mother-daughter_352x288_yv12.yuv", 352, 288, 35, 12345),
    ("image2_768x576.yuv", 768, 576, 43, 999),
]


def build_reference(ref_dir: str, workdir: str) -> str:
    src = os.path.join(workdir, "ref_main.cpp")
    exe = os.path.join(workdir, "ref_deblock")
    with open(src, "w") as f:
        f.write(DRIVER)
    subprocess.run(
        ["g++", "-O2", "-fopenmp", f"-I{ref_dir}", "-o", exe, src],
        check=True, capture_output=True, text=True,
    )
    return exe


def _ub_masked_diffs(o, r, ww, hh, chroma_ub=False, band=4):
    """Diffs outside every region the reference's UB can reach.

    UB sources: (a) uninitialized padding bytes feed any tile of the sweep
    whose 8x8 extent contains one (Q6) -- under the Q9 shear those tiles
    form diagonal stripes through the interior, not just a border band;
    (b) chroma ver2/hor2 BS reads go out of bounds for the last sweep tile
    row (Q2 x Q9, cpu.h:515/645 testing with LUMA block counts).  Mask is
    tile-granular: any output pixel living in an affected sweep tile is
    excluded.  Shared by the fuzz campaign and the fullscale check.
    """
    import numpy as np

    o2 = o.reshape(hh, ww).astype(int)
    r2 = r.reshape(hh, ww).astype(int)
    wext, hext = ww + 2 * band, hh + 2 * band
    ncby, ncbx = hext // 8, wext // 8
    vh, vw = ncby * 8, ncbx * 8
    # true-layout padding map -> sheared view -> tainted tiles
    pad = np.ones((hext, wext), bool)
    pad[band : band + hh, band : band + ww] = False
    pad_sheared = pad.ravel()[: vh * vw].reshape(vh, vw)
    tainted = pad_sheared.reshape(ncby, 8, ncbx, 8).any(axis=(1, 3))
    if chroma_ub:
        tainted[-1, :] = True  # OOB BS reads (Q2 x Q9)
    # map output pixels -> sheared tile; mask tainted ones
    rows = np.arange(hh)[:, None] + band
    cols = np.arange(ww)[None, :] + band
    flat = rows * wext + cols
    in_sweep = flat < vh * vw
    sr = np.minimum(flat, vh * vw - 1) // vw // 8
    sc = (np.minimum(flat, vh * vw - 1) % vw) // 8
    # out-of-sweep pixels are untouched by both sides: compare them
    # strictly; in-sweep pixels compare unless tainted
    m = ~in_sweep | ~tainted[sr, sc]
    return int(np.sum((o2 != r2) & m))


def fuzz(ref_dir: str, n_cases: int, seed: int = 0,
         max_w: int = 128, max_h: int = 96, backend: str = "golden") -> int:
    """Adversarial campaign: random frames x dims x QPs x injected BS vs the
    compiled reference binary.

    Comparison masks the reference's *undefined-behavior* regions (our build
    pins them -- SURVEY.md quirks Q2/Q6/Q9 -- so byte equality there is luck
    of the reference process's heap): any sweep tile whose 8x8 extent
    contains an uninitialized padding byte (under the Q9 shear those tiles
    form diagonal stripes through the interior), and the last sheared chroma
    tile row (OOB BS reads).  Any mismatch OUTSIDE those regions is a real
    divergence and fails.  Robust to dirty heaps (MALLOC_PERTURB_), not just
    fresh zero pages.
    """
    import numpy as np

    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    if backend == "native":
        # fuzz the native SIMD backend (whatever tier cpuid selects --
        # AVX-512 on this host) DIRECTLY against the compiled reference:
        # two independent implementations, no shared code
        from gpu_video_codec_jax.runtime import native as native_rt

        def model(frame, bs, qp):
            return native_rt.deblock_frame_native(frame, bs, qp)
        print(f"fuzz backend: native ({native_rt.active_isa()})")
    else:
        model = deblock_frame_golden

    rng = np.random.default_rng(seed)
    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        for case in range(n_cases):
            w = 8 * int(rng.integers(1, max_w // 8 + 1))
            h = 8 * int(rng.integers(1, max_h // 8 + 1))
            qp = int(rng.integers(0, 61))
            bs_seed = int(rng.integers(1, 1 << 31)) if rng.integers(0, 2) else None
            raw = rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
            inp = os.path.join(td, "in.yuv")
            out = os.path.join(td, "out.yuv")
            raw.tofile(inp)

            cmd = [exe, inp, str(w), str(h), str(qp), out]
            bs = BoundaryStrength.intra_default(w, h)
            if bs_seed is not None:
                cmd.append(str(bs_seed))
                v, hbs = _lcg_bs(bs_seed, bs.vert.size, bs.hor.size)
                bs.set_luma(v, hbs)
            subprocess.run(cmd, check=True)

            frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
            gold = model(frame, bs, qp)
            ours = np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
            ref = np.fromfile(out, np.uint8)

            label = f"fuzz[{case}] {w}x{h} qp={qp} bs={'rand' if bs_seed else 'intra'}"
            total = int(np.sum(ours != ref))
            if total == 0:
                print(f"{label}: IDENTICAL")
                continue
            # mask UB regions and re-compare
            cw, ch = w // 2, h // 2
            interior_diffs = _ub_masked_diffs
            fb_y = w * h
            fb_c = cw * ch
            dy = interior_diffs(ours[:fb_y], ref[:fb_y], w, h)
            du = interior_diffs(ours[fb_y:fb_y + fb_c], ref[fb_y:fb_y + fb_c], cw, ch, chroma_ub=True)
            dv = interior_diffs(ours[fb_y + fb_c:], ref[fb_y + fb_c:], cw, ch, chroma_ub=True)
            if dy + du + dv == 0:
                print(f"{label}: {total} byte diffs, ALL inside reference-UB regions (OK)")
            else:
                print(f"{label}: REAL DIVERGENCE outside UB regions "
                      f"(Y {dy}, U {du}, V {dv} of {total} total)")
                failures += 1
    print(f"fuzz: {n_cases} cases, {failures} real divergences")
    return 1 if failures else 0


def fullscale(ref_dir: str, w: int = 1920, h: int = 1080, qp: int = 35) -> int:
    """Production-scale byte-compare + thread-determinism run (round-3
    verdict item 5).

    1080p is the Q9 ROW-truncation case at real scale: extended chroma
    height 548 is not 8-aligned (548 % 8 == 4, cpu.h:450-451's truncating
    num_chroma_blocks_y), so the reference's chroma sweep covers only
    68 * 8 = 544 of the 548 extended rows and the trailing flat bytes --
    including real bottom chroma rows -- are never touched.  (The width is
    16-aligned, so there is no column shear; utils/tiles.split_covered
    reproduces exactly this row truncation.)

    Runs the compiled reference at REF_THREADS=1 AND =4 on a synthetic
    gradient+noise frame (both filter branches active at QP 35): the two
    outputs must be byte-identical to each other (tiles are independent,
    cpu.h:145's omp parallel for is race-free by construction -- this
    verifies it at production scale) and to our golden model."""
    import numpy as np

    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import planes_from_yv12_bytes, yv12_bytes_from_planes

    rng = np.random.default_rng(1080)
    yy = ((np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 2
           + rng.integers(-6, 7, (h, w))) % 256).astype(np.uint8)
    cw, ch = w // 2, h // 2
    uu = ((np.arange(ch)[:, None] + rng.integers(-4, 5, (ch, cw))) % 256).astype(np.uint8)
    vv = ((np.arange(cw)[None, :] + rng.integers(-4, 5, (ch, cw))) % 256).astype(np.uint8)
    raw = np.concatenate([yy.ravel(), uu.ravel(), vv.ravel()])

    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        inp = os.path.join(td, "in.yuv")
        raw.tofile(inp)
        outs = {}
        for nt in (1, 4):
            out = os.path.join(td, f"out_{nt}.yuv")
            env = dict(os.environ, REF_THREADS=str(nt))
            subprocess.run([exe, inp, str(w), str(h), str(qp), out],
                           env=env, check=True)
            outs[nt] = np.fromfile(out, np.uint8)
        det = int(np.sum(outs[1] != outs[4]))
        print(f"fullscale {w}x{h} qp={qp}: 1-thread vs 4-thread reference: "
              f"{'IDENTICAL' if det == 0 else f'{det} byte diffs (RACE?)'}")
        failures += det != 0

        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        gold = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), qp)
        ours = np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
        strict = int(np.sum(ours != outs[1]))
        changed = int(np.sum(outs[1] != raw))
        # UB-masked comparison (same mask as the fuzz campaign): at 1080p the
        # reference's chroma ver2/hor2 BS lookups for the LAST sweep tile row
        # read past its chroma BS arrays (Q2 -- existence tested with luma
        # counts, cpu.h:515/645), so those segments filter with heap garbage;
        # our golden pins OOB BS = 0.  Empirically (this run): every strict
        # diff sits in that last chroma tile row (interior rows >= 532).
        fy, fc = w * h, cw * ch
        real = (_ub_masked_diffs(ours[:fy], outs[1][:fy], w, h)
                + _ub_masked_diffs(ours[fy:fy + fc], outs[1][fy:fy + fc],
                                   cw, ch, chroma_ub=True)
                + _ub_masked_diffs(ours[fy + fc:], outs[1][fy + fc:],
                                   cw, ch, chroma_ub=True))
        if real == 0:
            verdict = ("IDENTICAL" if strict == 0 else
                       f"IDENTICAL outside reference-UB regions "
                       f"({strict} diffs, all in the Q2xQ9 last chroma "
                       f"tile row)")
        else:
            verdict = f"{real} REAL byte diffs outside UB regions"
        print(f"fullscale {w}x{h} qp={qp}: golden vs compiled reference: "
              f"{verdict} ({changed} bytes filtered)")
        failures += real != 0
    return 1 if failures else 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--fullscale":
        ref_dir = sys.argv[2] if len(sys.argv) > 2 else DEFAULT_REF
        sys.path.insert(0, REPO)
        return fullscale(ref_dir)
    if len(sys.argv) > 1 and sys.argv[1] == "--fuzz":
        # --fuzz [N] [SEED] [MAX_W] [MAX_H] [REF_DIR] [--backend golden|native]
        argv = sys.argv[2:]
        backend = "golden"
        if "--backend" in argv:
            i = argv.index("--backend")
            backend = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
        n = int(argv[0]) if len(argv) > 0 else 30
        seed = int(argv[1]) if len(argv) > 1 else 0
        max_w = int(argv[2]) if len(argv) > 2 else 128
        max_h = int(argv[3]) if len(argv) > 3 else 96
        ref_dir = argv[4] if len(argv) > 4 else DEFAULT_REF
        sys.path.insert(0, REPO)
        return fuzz(ref_dir, n, seed=seed, max_w=max_w, max_h=max_h,
                    backend=backend)
    ref_dir = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_REF
    header = os.path.join(ref_dir, "hevc_deblocking_filter_cpu.h")
    if not os.path.exists(header):
        print(f"reference header not found at {header}; pass REF_DIR", file=sys.stderr)
        return 2

    sys.path.insert(0, REPO)
    import numpy as np

    from gpu_video_codec_jax.models.golden import deblock_frame_golden
    from gpu_video_codec_jax.utils.bs import BoundaryStrength
    from gpu_video_codec_jax.utils.yuv import read_yv12, yv12_bytes_from_planes

    failures = 0
    with tempfile.TemporaryDirectory() as td:
        exe = build_reference(ref_dir, td)
        for name, w, h, qp, seed in CASES:
            inp = os.path.join(REPO, "testdata", name)
            out = os.path.join(td, "ref_out.yuv")
            cmd = [exe, inp, str(w), str(h), str(qp), out]
            bs = BoundaryStrength.intra_default(w, h)
            label = f"{name} {w}x{h} qp={qp}"
            if seed is not None:
                cmd.append(str(seed))
                v, hbs = _lcg_bs(seed, bs.vert.size, bs.hor.size)
                bs.set_luma(v, hbs)
                label += f" bs_seed={seed}"
            subprocess.run(cmd, check=True)
            ref = np.fromfile(out, np.uint8)
            gold = deblock_frame_golden(read_yv12(inp, w, h), bs, qp)
            ours = np.frombuffer(yv12_bytes_from_planes(gold), np.uint8)
            diffs = int(np.sum(ours != ref))
            status = "IDENTICAL" if diffs == 0 else f"{diffs} byte diffs"
            print(f"{label}: {status}")
            failures += diffs != 0
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

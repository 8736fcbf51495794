#!/usr/bin/env python
"""Produce bench/RESULTS_r<N>.json — the per-round CPU results artifact.

Centers on `bench_cpu_interleaved` — native and compiled-reference reps
strictly alternated per (geometry, thread count) so shared-core noise hits
both sides equally on a shared host — with per-row rep-spread noise bands
and a summary that classifies every native loss as real or within-noise.
Device numbers live in PERF.md and PERF_LEDGER.jsonl.

Run on an otherwise-idle host: `python tools/make_results.py --round 4`.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU-only artifact
os.environ["JAX_PLATFORMS"] = "cpu"

from bench.bench_lib import bench_cpu_interleaved, device_info  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--round", type=int, required=True)
    args = ap.parse_args()
    out = {
        "round": args.round,
        "what": (
            "same-host native-vs-compiled-reference CPU comparison, "
            "interleaved reps; device numbers are in PERF.md"),
        "device": device_info(),
        "cpu_interleaved": bench_cpu_interleaved(),
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench", f"RESULTS_r{args.round}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(path)
    print(json.dumps(out["cpu_interleaved"]["summary"], indent=2))


if __name__ == "__main__":
    main()

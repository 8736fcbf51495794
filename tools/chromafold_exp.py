"""Experiment: fold the packed-graph chroma retiles into the relayout dots.

The packed YV12 graph pays two chroma retiling copies the planes contract
doesn't: `buf[h:].reshape(2, ch, cw)` on ingest and `uv_int.reshape(h/2, w)`
on write-back -- a minor-dim width change (w <-> cw) that costs copy
passes.  This tool folds those retiles into the mxu relayout dot operands
and races the two.

The fold itself ships as a production engine option (GVCT_PACKED_CHROMA=
fold; utils/tiles.py packed_rows_to_chroma_tiles / chroma_tiles_to_
packed_rows -- see those docstrings for the formulation: row parity rides
the output-column space of a (w, 2*8*cbxg) one-hot, the residual-reorder
transpose absorbs r8 = 2*rh + q).  Bit-exact by construction and enforced
by tests/test_streaming.py; this tool is the MEASUREMENT harness:

  Cost trade: both fold dots contract 2x the columns (1080p: ~1.1G ->
  ~2.1G MACs per direction) to erase the retile copies.  The race decides.

Usage:
  python -m tools.chromafold_exp --check          # CPU bit-exactness
  python -m tools.chromafold_exp --race           # GPU device-trace race
          [--geometry 3840x2160]                  # (production steps)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from gpu_video_codec_jax.ops.tables import HALF_BLOCK  # noqa: E402


def _fold_geometry(w: int, h: int, chroma_block=(32, 256)):
    from gpu_video_codec_jax.models.streaming import _chroma_grid_bx

    if (w // 2 + 2 * HALF_BLOCK) % 8:
        raise ValueError("fold requires a non-sheared Q9 geometry (w % 16 == 0)")
    cby = (h // 2 + 2 * HALF_BLOCK) // 8
    return cby, _chroma_grid_bx(w, chroma_block)


def reference_chroma_path(region, w: int, h: int, cbxg: int):
    """The production retile chroma boundary (retile -> relayout -> inverse
    -> retile), with NO filtering in between -- the layout round-trip the
    fold must reproduce byte-for-byte."""
    from gpu_video_codec_jax.utils.tiles import interior_to_tiles, tiles_to_interior

    cw, ch = w // 2, h // 2
    uv = region.reshape(2, ch, cw)
    t = interior_to_tiles(uv, HALF_BLOCK, bx_grid=cbxg)
    uv2 = tiles_to_interior(t, HALF_BLOCK, ch, cw)
    return t, uv2.reshape(h // 2, w)


def check(geometries=((64, 48), (1920, 1080), (352, 288))) -> dict:
    """CPU bit-exactness of the fold engine vs the retile path: forward
    tiles, full layout round-trip, identity on the region."""
    os.environ.setdefault("GVCT_RELAYOUT", "mxu")  # the fold rides the mxu engine
    import jax.numpy as jnp

    from gpu_video_codec_jax.utils.tiles import (
        chroma_tiles_to_packed_rows, fold_perm_device,
        packed_rows_to_chroma_tiles,
    )

    out = {}
    rng = np.random.default_rng(3)
    for w, h in geometries:
        cby, cbxg = _fold_geometry(w, h)
        region = rng.integers(0, 256, (h // 2, w), dtype=np.uint8)
        dreg = jnp.asarray(region)
        fwd = fold_perm_device(w, HALF_BLOCK, cbxg, False)
        inv = fold_perm_device(w, HALF_BLOCK, cbxg, True)
        t_ref, reg_ref = reference_chroma_path(dreg, w, h, cbxg)
        t_fold = packed_rows_to_chroma_tiles(dreg, HALF_BLOCK, h, w, cby,
                                             cbxg, fwd)
        reg_fold = chroma_tiles_to_packed_rows(t_fold, HALF_BLOCK, h, w, inv)
        import jax

        t_ref, t_fold, reg_ref, reg_fold = (
            jax.device_get((t_ref, t_fold, reg_ref, reg_fold)))
        out[f"{w}x{h}"] = {
            "fwd_tiles_equal": bool(np.array_equal(t_ref, t_fold)),
            "roundtrip_equal": bool(np.array_equal(reg_ref, reg_fold)),
            "roundtrip_is_identity": bool(np.array_equal(reg_fold, region)),
        }
    out["ok"] = all(all(v.values()) for k, v in out.items() if k != "ok")
    return out


def _make_sd(w, h, qp, fold: bool):
    """A StreamingDeblocker with the packed-chroma engine selected; the env
    knob is read at construction, so toggling it between constructions
    yields the two production graphs."""
    from gpu_video_codec_jax.models.streaming import StreamingDeblocker

    prev = os.environ.get("GVCT_PACKED_CHROMA")
    os.environ["GVCT_PACKED_CHROMA"] = "fold" if fold else "retile"
    try:
        sd = StreamingDeblocker(w, h, qp)
        assert sd._chroma_fold == fold
        return sd
    finally:
        if prev is None:
            os.environ.pop("GVCT_PACKED_CHROMA", None)
        else:
            os.environ["GVCT_PACKED_CHROMA"] = prev


def race(w: int = 1920, h: int = 1080, qp: int = 35, iters: int = 30) -> dict:
    """Device-trace race of the PRODUCTION packed step under each engine
    (GVCT_PACKED_CHROMA=retile vs fold), chained on rotating donated
    buffers.  Byte-compares one step's output first so the race can't
    quietly time a wrong graph."""
    import jax

    from bench.bench_lib import packed_yv12, synthetic_frame
    from gpu_video_codec_jax.utils.tracing import profiled_device_us

    sd_base = _make_sd(w, h, qp, fold=False)
    sd_fold = _make_sd(w, h, qp, fold=True)
    raw = packed_yv12(synthetic_frame(w, h))
    rows = raw.reshape(3 * h // 2, w)

    base = np.asarray(jax.device_get(sd_base._step_borrow(jax.device_put(rows))))
    fold = np.asarray(jax.device_get(sd_fold._step_borrow(jax.device_put(rows))))
    equal = bool(np.array_equal(base, fold))

    out = {"geometry": f"{w}x{h}", "bit_exact_vs_production": equal}

    def timed(sd):
        k = 4
        cells = [sd._step(sd._put(raw)) for _ in range(k)]
        jax.block_until_ready(cells)
        i = [0]

        def chained():
            cells[i[0] % k] = sd._step(cells[i[0] % k])
            i[0] += 1
            return cells[i[0] % k]

        return profiled_device_us(chained, iters=iters)

    p_base, p_fold = timed(sd_base), timed(sd_fold)
    if p_base is None or p_fold is None:
        out["error"] = "no device trace lanes (CPU backend)"
        return out
    out["retile_us"] = round(p_base[0], 2)
    out["fold_us"] = round(p_fold[0], 2)
    out["retile_split_us"] = {k2: round(v, 1) for k2, v in p_base[1].items()}
    out["fold_split_us"] = {k2: round(v, 1) for k2, v in p_fold[1].items()}
    out["fold_wins"] = p_fold[0] < p_base[0]
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--race", action="store_true")
    ap.add_argument("--geometry", default="1920x1080")
    a = ap.parse_args()
    if a.check:
        # --check is a CPU job
        os.environ["JAX_PLATFORMS"] = "cpu"
        print(json.dumps(check(), indent=2))
    if a.race:
        gw, gh = (int(x) for x in a.geometry.split("x"))
        print(json.dumps(race(gw, gh), indent=2))

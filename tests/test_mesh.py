"""Mesh-sharded batch deblock vs the single-device path, on the 8-device
virtual CPU mesh (BASELINE config 5's correctness side)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_video_codec_jax.models.golden import deblock_frame_golden
from gpu_video_codec_jax.ops.tables import get_beta, get_tc
from gpu_video_codec_jax.parallel.mesh import (
    default_mesh_shape,
    deblock_batch_sharded_jit,
    make_mesh,
)
from gpu_video_codec_jax.utils.bs import (
    BoundaryStrength,
    chroma_segment_maps,
    luma_segment_maps,
)
from gpu_video_codec_jax.utils.yuv import FramePlanes, extend_plane


def _batch(rng, n, w, h):
    ys = np.stack([extend_plane(rng.integers(0, 256, (h, w), dtype=np.uint8)) for _ in range(n)])
    us = np.stack([extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)) for _ in range(n)])
    vs = np.stack([extend_plane(rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)) for _ in range(n)])
    return ys, us, vs


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8), (8, 1)])
def test_sharded_matches_golden(rng, mesh_shape):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    w, h = 64, 48  # luma By=7, chroma By=5: neither divides 4 or 8 -> pads
    n = 8
    ys, us, vs = _batch(rng, n, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    lm = luma_segment_maps(bs)
    cm = chroma_segment_maps(bs)
    qp = 35

    mesh = make_mesh(*mesh_shape)
    yo, uo, vo = deblock_batch_sharded_jit(
        mesh, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        lm, cm, get_beta(qp), get_tc(qp),
    )
    yo, uo, vo = np.asarray(yo), np.asarray(uo), np.asarray(vo)
    assert yo.shape == ys.shape and uo.shape == us.shape

    for i in range(n):
        frame = FramePlanes(ys[i], us[i], vs[i], w, h)
        gold = deblock_frame_golden(frame, bs, qp)
        assert np.array_equal(yo[i], gold.y), f"frame {i} Y mesh={mesh_shape}"
        assert np.array_equal(uo[i], gold.u), f"frame {i} U mesh={mesh_shape}"
        assert np.array_equal(vo[i], gold.v), f"frame {i} V mesh={mesh_shape}"


def test_default_mesh_shape():
    assert default_mesh_shape(1) == (1, 1)
    assert default_mesh_shape(8) == (2, 4)
    assert default_mesh_shape(6) == (1, 6)
    d, s = default_mesh_shape(16)
    assert d * s == 16


def test_batch_not_divisible_raises(rng):
    mesh = make_mesh(2, 4)
    ys, us, vs = _batch(rng, 3, 64, 48)
    with pytest.raises(ValueError):
        deblock_batch_sharded_jit(mesh, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
                                  luma_segment_maps(BoundaryStrength.intra_default(64, 48)),
                                  chroma_segment_maps(BoundaryStrength.intra_default(64, 48)),
                                  32, 4)


# slow: each count re-imports jax in a fresh subprocess (~40 s on this
# single-core host); the driver-shaped invocation below stays in the default
# tier and mesh-shape coverage lives in test_sharded_matches_golden
@pytest.mark.slow
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_various_counts(n, monkeypatch):
    """The driver may invoke dryrun_multichip with any virtual device count
    <= available; it must work for every factorization.  Default suite keeps
    the degenerate (1) and driver (8) counts; intermediates are -m slow
    (each mesh shape is a fresh 15 s trace+compile on this 1-core host)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                    "__graft_entry__.py"))
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    ge.dryrun_multichip(n)


def test_dryrun_multichip_driver_invocation():
    """Run dryrun_multichip the way a GPU host's shell would -- a FRESH
    subprocess that inherits JAX_PLATFORMS=cuda -- and require rc 0.  The
    function must self-provision the 8-device virtual CPU mesh before any
    backend starts; conftest's pre-provisioned env must play no part."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cuda"  # what a GPU host's shell exports
    env.pop("JAX_PLATFORM_NAME", None)
    env["XLA_FLAGS"] = ""  # no pre-provisioned virtual devices
    proc = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        env=env, cwd=repo, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, f"stderr:\n{proc.stderr[-2000:]}"
    assert "dryrun_multichip OK" in proc.stdout


def test_sharded_pallas_backend(rng):
    """Per-shard fused Pallas kernel inside shard_map matches golden."""
    w, h, n = 64, 48, 4
    ys, us, vs = _batch(rng, n, w, h)
    bs = BoundaryStrength.intra_default(w, h)
    mesh = make_mesh(2, 4)
    yo, uo, vo = deblock_batch_sharded_jit(
        mesh, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        luma_segment_maps(bs), chroma_segment_maps(bs),
        get_beta(35), get_tc(35), backend="pallas",
    )
    for i in range(n):
        gold = deblock_frame_golden(FramePlanes(ys[i], us[i], vs[i], w, h), bs, 35)
        assert np.array_equal(np.asarray(yo[i]), gold.y), i
        assert np.array_equal(np.asarray(uo[i]), gold.u), i


def test_sharded_q9_geometry(rng):
    """Sheared chroma sweep (quirk Q9: ext chroma width % 8 != 0) must
    survive mesh sharding bit-exactly."""
    w, h, n = 56, 72, 4
    ys, us, vs = _batch(rng, n, w, h)
    assert us.shape[-1] % 8 != 0  # Q9-triggering geometry
    bs = BoundaryStrength.intra_default(w, h)
    mesh = make_mesh(2, 4)
    yo, uo, vo = deblock_batch_sharded_jit(
        mesh, jnp.asarray(ys), jnp.asarray(us), jnp.asarray(vs),
        luma_segment_maps(bs), chroma_segment_maps(bs), get_beta(35), get_tc(35),
    )
    for i in range(n):
        gold = deblock_frame_golden(FramePlanes(ys[i], us[i], vs[i], w, h), bs, 35)
        assert np.array_equal(np.asarray(yo[i]), gold.y), i
        assert np.array_equal(np.asarray(uo[i]), gold.u), i
        assert np.array_equal(np.asarray(vo[i]), gold.v), i


class TestMeshResident:
    """Mesh-sharded device-resident streaming (parallel/resident_mesh.py):
    the batched TileFrame's frame axis shards over "data"; each device runs
    the batched fused kernels locally (zero collectives)."""

    def _golden_packed(self, raw, w, h, qp):
        from gpu_video_codec_jax.utils.yuv import (
            planes_from_yv12_bytes, yv12_bytes_from_planes,
        )

        frame = planes_from_yv12_bytes(raw.tobytes(), w, h)
        out = deblock_frame_golden(frame, BoundaryStrength.intra_default(w, h), qp)
        return np.frombuffer(yv12_bytes_from_planes(out), np.uint8)

    @pytest.mark.parametrize("w,h", [
        (64, 48),
        pytest.param(56, 72, marks=pytest.mark.slow),  # Q9-sheared chroma
    ])
    def test_matches_golden(self, rng, w, h):
        from gpu_video_codec_jax.parallel import MeshResidentDeblocker

        mesh = make_mesh(4, 2)
        raws = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
                for _ in range(8)]
        mrd = MeshResidentDeblocker(mesh, w, h, qp=35)
        out = mrd(raws)
        assert out.shape == (8, 3 * w * h // 2)
        for i, raw in enumerate(raws):
            assert np.array_equal(out[i], self._golden_packed(raw, w, h, 35)), i

    def test_chained_steps_match_single_chip(self, rng):
        from gpu_video_codec_jax.models.resident import ResidentDeblocker
        from gpu_video_codec_jax.parallel import MeshResidentDeblocker

        w, h = 64, 48
        mesh = make_mesh(8, 1)
        raws = [rng.integers(0, 256, 3 * w * h // 2, dtype=np.uint8)
                for _ in range(8)]
        mrd = MeshResidentDeblocker(mesh, w, h, qp=35)
        out = mrd.readback(mrd.step(mrd.ingest(raws), n_steps=3))

        rd = ResidentDeblocker(w, h, qp=35)
        for i, raw in enumerate(raws):
            st = rd.ingest(raw)
            for _ in range(3):
                st = rd.step(st)
            assert np.array_equal(out[i], rd.readback(st)), i

    def test_batch_not_divisible_raises(self, rng):
        from gpu_video_codec_jax.parallel import MeshResidentDeblocker

        mrd = MeshResidentDeblocker(make_mesh(8, 1), 64, 48, qp=35)
        raws = [rng.integers(0, 256, 3 * 64 * 48 // 2, dtype=np.uint8)
                for _ in range(5)]
        with pytest.raises(ValueError):
            mrd.ingest(raws)

"""Entry-point contracts that need no card: the compile-cache rule, and
chip_smoke.py / bench.py refusing to report anything without a GPU."""

import os
import shutil
import subprocess
import sys

from gpu_video_codec_jax.utils.compile_cache import REPO_ROOT, compile_cache_dir


def test_compile_cache_dir_honours_env(tmp_path):
    d = str(tmp_path / "cache")
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": d}) == d


def test_compile_cache_dir_default_is_repo_jax_cache():
    assert compile_cache_dir({}) == os.path.join(REPO_ROOT, ".jax_cache")
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == \
        os.path.join(REPO_ROOT, ".jax_cache")


def _run(script, cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu(tmp_path):
    proc = _run(os.path.join(REPO_ROOT, "chip_smoke.py"), REPO_ROOT, tmp_path)
    assert proc.returncode != 0
    assert "'cpu'" in proc.stderr and '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), alone)
    proc = _run(str(alone / "chip_smoke.py"), str(alone), tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_bench_fails_without_gpu(tmp_path):
    proc = _run(os.path.join(REPO_ROOT, "bench.py"), REPO_ROOT, tmp_path)
    assert proc.returncode != 0
    assert "'cpu'" in proc.stderr and proc.stdout.strip() == ""

"""Where the entry points keep JAX's persistent compile cache.

JAX_COMPILATION_CACHE_DIR wins when it is set; otherwise the cache lives at
the fixed path <repo>/.jax_cache (git-ignored), so that every process of a
run -- and every later run from the same checkout -- hits the same cache.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    """The cache directory the entry points use under `environ`."""
    environ = os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir(); call
    before the first compilation.  Returns the directory."""
    import jax

    d = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    return d

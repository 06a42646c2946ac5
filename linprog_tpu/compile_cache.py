"""Where JAX keeps its persistent compilation cache for this package.

Compiling the batched solvers takes from seconds to minutes per shape, so
the scripts that drive the device (``chip_smoke.py``, ``bench.py``) keep
compiled programs on disk.  The cache key includes the directory, so the
directory must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads that
    directory from the environment and nothing else is configured.
    Otherwise the cache goes to ``.jax_cache/`` at the repository root.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

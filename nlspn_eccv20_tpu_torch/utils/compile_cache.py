"""Persistent cache of the kernels' nvcc builds (counterpart of
``nlspn_eccv20_tpu/utils/compile_cache.py``, which keeps XLA's executables).

``ops/kernels/build.py`` compiles each ``csrc/<name>.cu`` into a library
named by the hash of its source, the shared headers and nvcc's flags, and
loads one that exists instead of building it. By default those libraries
sit in ``build/`` of the checkout, so a fresh checkout builds every kernel
again. Pointed at a directory outside the checkout, one machine's builds
serve every later run and checkout whose sources hash the same.

``main`` enables it from ``--compile_cache`` (on by default; off with
``--no_compile_cache``) with ``--compile_cache_dir``, when it runs on the
card. ``NLSPN_COMPILE_CACHE`` names the directory where no
``--compile_cache_dir`` is given; ``NLSPN_COMPILE_CACHE=0`` disables the
cache, and the libraries stay in ``build/`` (``chip_smoke.py`` builds
there).
"""

from __future__ import annotations

import os
from typing import Optional

from nlspn_eccv20_tpu_torch.ops.kernels import build


def default_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "nlspn_eccv20_tpu_torch",
                        "nvcc")


def enable_compilation_cache(cache_dir: str = "") -> Optional[str]:
    """Make ``cache_dir`` (else ``$NLSPN_COMPILE_CACHE``, else
    ``default_dir()``) the kernels' build directory; returns it, or None
    when ``NLSPN_COMPILE_CACHE=0`` disables the cache (the build directory
    is then left as it is). The directory is made at the first build."""
    env = os.environ.get("NLSPN_COMPILE_CACHE", "")
    if env == "0":
        return None
    build.BUILD_DIR = os.path.abspath(cache_dir or env or default_dir())
    return build.BUILD_DIR

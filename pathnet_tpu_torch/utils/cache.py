"""The port's compilation cache (counterpart of
``pathnet_tpu/utils/cache.py``, JAX's persistent XLA cache).

The port compiles its CUDA sources once into
``<root>/<hash of sources and flags>/lib.so`` (``kernels/build.py``); a later
process with the same sources loads that library and compiles nothing. The
cache is that build root. It defaults to ``build/pathnet_tpu_torch`` at the
root of the checkout; :func:`enable_compilation_cache` moves it.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV = "PATHNET_TPU_TORCH_CACHE"


def enable_compilation_cache(path: Optional[str] = None) -> Path:
    """Build and find the kernel library under ``path``, else under
    ``$PATHNET_TPU_TORCH_CACHE``, else under the default
    ``build/pathnet_tpu_torch``; returns the build root it replaced (pass it
    back to restore). A library already loaded in this process stays
    loaded."""
    from ..kernels import build

    old = build.BUILD_ROOT
    path = path or os.environ.get(ENV)
    root = Path(path).expanduser().resolve() if path else build.DEFAULT_BUILD_ROOT
    root.mkdir(parents=True, exist_ok=True)
    build.BUILD_ROOT = root
    return old

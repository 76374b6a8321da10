"""The port's counterpart of the persistent compilation cache.

JAX (``runtime/compile_cache.py:36-60``) points XLA's persistent cache at
``compile_cache_dir`` so that a relaunch does not compile its step functions
again.  PyTorch compiles nothing of the port's step: eager kernels need no
compilation.  The port's only compile costs are its own libraries: ``nvcc``
builds of K1 and K2 (``ops/cuda_build.py``) and the ``g++`` build of the host
ops (``runtime/native.py``).  So ``compile_cache_dir=<dir>`` builds all three
under ``<dir>`` (``kernels/``, ``hostops/``) instead of the checkout's
``build/``; their file names carry a hash of their sources, so a relaunch on
a fresh checkout or in a new container that sees ``<dir>`` loads them without
building, and an edited source builds anew.

JAX's semantics are kept: an empty directory means off, ``~`` is expanded,
the directory is created, and the call is idempotent.  Call it before the
first kernel or host op is built: a library already loaded in this process
stays loaded.
"""

from __future__ import annotations

import os

from ..ops import cuda_build

_enabled: str | None = None


def enable_compile_cache(directory: str) -> str | None:
    """Build and reuse the port's libraries under ``directory`` -> the
    resolved path, or None when ``directory`` is empty."""
    global _enabled
    if not directory:
        return None
    path = os.path.abspath(os.path.expanduser(directory))
    if _enabled == path:
        return path
    os.makedirs(path, exist_ok=True)
    cuda_build.set_build_root(path)
    _enabled = path
    return path

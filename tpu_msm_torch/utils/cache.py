"""The CUDA build cache: where `_build.py` keeps the compiled kernels.

The counterpart of `tpu_msm/utils/cache.py`, which turns on the XLA
compile cache. The port compiles its kernels once with `nvcc` into the
build directory and reuses the library while its sources are unchanged;
`enable_compile_cache` moves that directory (and with it the native CPU
MSM's build and the autotune cache, which live there too). The build
reads the setting at every build, so it may be called at any time before
the first one; a library already loaded in this process stays loaded.
"""

from __future__ import annotations

import os

from .. import _build


def enable_compile_cache(path: str | None = None) -> str:
    """Put the build directory at `path` (default: the one in force,
    $TPU_MSM_TORCH_BUILD_DIR or build/tpu_msm_torch/), through the
    environment, so that processes this one starts build there too.
    Returns the absolute path."""
    path = os.path.abspath(path or _build.build_dir())
    os.environ[_build.BUILD_DIR_ENV] = path
    return path

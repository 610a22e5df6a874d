"""Build and load the CUDA kernels of `csrc/` as one shared library.

`nvcc` compiles each `csrc/*.cu` for `sm_90a` into an object file, all
sources at once in parallel, and links them into
`build/tpu_msm_torch/libkernels.so` beside the package; the library has a
plain C interface and is loaded with `ctypes`. The build runs at first
use (never at import, so `import tpu_msm_torch` needs no `nvcc`) and runs
again when a source's content changes: a stamp file records the hash of
the sources the library was built from.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpu_msm_torch"
LIB = BUILD_DIR / "libkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C signature of every kernel entry point (all return a cudaError_t).
SIGNATURES = {
    "msm_encode_mont": [_I, _I, _P, _P, _I64, _P, _P],
    "msm_decompose_digits": [_P, _P, _I, _I64, _I, _I, _P],
    "msm_prefix_scan": [_I, _I, _P, _P, _P, _I, _I, _I, _I64, _I, _P, _P],
    "msm_col_prefix": [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "msm_col_prefix_limits": [_I, _I, _P, _P, _P],
    "msm_padd_batch": [_I, _I, _I, _I, _P, _P, _P, _I64, _I, _I, _I, _I,
                       _P, _P, _P],
    "msm_pbpr_full": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                      _P],
    "msm_pbpr_full_limits": [_I, _I, _P, _P, _P, _P],
    "msm_pdbl_batch": [_I, _I, _P, _P, _I64, _P, _P],
    "msm_pbpr_stage1": [_I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                        _P, _P],
    "msm_globalize": [_I, _I, _I, _I, _P, _P, _P, _I64, _I64, _I, _I, _I,
                      _P, _P, _P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None
"""Wall time of the build this process ran, None if none ran."""


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh + [Path(__file__)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if the library is missing or stale."""
    global build_seconds
    stamp = BUILD_DIR / "sources.sha256"
    digest = _digest()
    if LIB.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIB
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    objs, procs = [], []
    for src in cu:
        obj = BUILD_DIR / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, proc in procs:
        out, _ = proc.communicate()
        # what ptxas says of each kernel: registers, stack frame, spills
        (BUILD_DIR / (src.stem + ".ptxas.txt")).write_text(out)
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{out}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = BUILD_DIR / "libkernels.so.tmp"
    subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)], check=True, capture_output=True,
                   text=True)
    os.replace(tmp, LIB)
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return LIB


def resources(stem: str) -> list:
    """(entry function, registers, stack frame bytes, spill store bytes,
    spill load bytes) of every kernel of `csrc/<stem>.cu`, from what ptxas
    printed when the library was built."""
    build()
    text = (BUILD_DIR / (stem + ".ptxas.txt")).read_text()
    entry = re.compile(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers", re.S)
    return [(m[1], int(m[5]), int(m[2]), int(m[3]), int(m[4]))
            for m in entry.finditer(text)]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib

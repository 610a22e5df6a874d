"""ctypes bindings and build driver of the native C++ CPU MSM.

The port of `tpu_msm/host/cpu_msm.py`. `cpu_msm()` is the fast trusted
CPU MSM (signed-window Pippenger over 64-bit Montgomery words, threaded
over windows) for checks at sizes where the pure-Python oracle is too
slow; `write_params_header()` emits the curve constants of `params_gen.h`
from the port's `CurveParams`, so the C++ core has no hand-copied
numbers; `build()` compiles `native/cpumsm.cpp` with g++.

The source in `native/` is only read. The build writes `params_gen.h`, a
copy of the source and `libcpumsm-<hash>.so` into the port's build
directory (`_build.build_dir()`), under its lock: the source includes
"params_gen.h" in quotes, so a header beside the original would be
found first, and the copy makes the port's header the one it includes.
The hash covers the source and the header.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from .. import _build
from ..constants import BLS12_377, BN254, CurveParams

SOURCE = Path(__file__).resolve().parents[2] / "native" / "cpumsm.cpp"
_CURVE_IDS = {"bn254": 0, "bls12_377": 1}


def _u64_words(value: int, n: int) -> List[int]:
    return [(value >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


def _emit_curve(prefix: str, curve: CurveParams) -> str:
    nw = (curve.p.bit_length() + 63) // 64
    r = 1 << (64 * nw)
    n0 = (-pow(curve.p, -1, 1 << 64)) % (1 << 64)
    r2 = (r * r) % curve.p
    one = r % curve.p
    sw = (curve.scalar_bits + 63) // 64

    def arr(name, vals):
        body = ", ".join(f"0x{v:016x}ull" for v in vals)
        return f"static const uint64_t {prefix}_{name}[{len(vals)}] = {{{body}}};"

    lines = [
        f"#define {prefix}_NW {nw}",
        arr("P", _u64_words(curve.p, nw)),
        f"static const uint64_t {prefix}_N0 = 0x{n0:016x}ull;",
        arr("R2", _u64_words(r2, nw)),
        arr("ONE", _u64_words(one, nw)),
        f"#define {prefix}_SCALAR_WORDS {sw}",
        f"#define {prefix}_SCALAR_BITS {curve.scalar_bits}",
    ]
    return "\n".join(lines)


def params_header() -> str:
    """The text of params_gen.h: BN254 and BLS12-377 constants."""
    return "\n".join([
        "// Generated by tpu_msm_torch/host/cpu_msm.py — do not edit.",
        "#pragma once",
        "#include <cstdint>",
        _emit_curve("BN254", BN254),
        _emit_curve("BLS377", BLS12_377),
        "",
    ])


def write_params_header(path: str) -> None:
    with open(path, "w") as f:
        f.write(params_header())


_lib = None


def build(force: bool = False) -> str:
    """Compile native/cpumsm.cpp into libcpumsm-<hash>.so in the build
    directory, unless a library of the same source and header is there
    already; returns its path."""
    src = SOURCE.read_bytes()
    header = params_header()
    digest = hashlib.sha256(src + header.encode()).hexdigest()[:16]
    with _build.build_lock() as d:
        out = d / f"libcpumsm-{digest}.so"
        if force or not out.exists():
            (d / "params_gen.h").write_text(header)
            copy = d / "cpumsm.cpp"
            copy.write_bytes(src)
            tmp = d / f"libcpumsm-{digest}.so.tmp"
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", "-pthread", str(copy), "-o", str(tmp)]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, out)
    return str(out)


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.cpu_msm.restype = ctypes.c_int
        lib.cpu_msm.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.cpu_mont_throughput.restype = ctypes.c_double
        lib.cpu_mont_throughput.argtypes = [ctypes.c_int, ctypes.c_longlong]
        _lib = lib
    return _lib


def _pack_u64(values: Sequence[int], words: int) -> np.ndarray:
    out = np.zeros((len(values), words), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(values):
        v = int(v)
        for j in range(words):
            out[i, j] = (v >> (64 * j)) & mask
    return out


def curve_id(curve: CurveParams) -> int:
    """The native library's id of a curve (any profile of BN254 or
    BLS12-377); ValueError for any other curve."""
    base = curve.name.split("_f")[0].split("_s")[0]
    if base not in _CURVE_IDS:
        raise ValueError(f"unsupported curve {curve.name}")
    return _CURVE_IDS[base]


def cpu_msm_words(xs: np.ndarray, ys: np.ndarray, scalars: np.ndarray,
                  curve: CurveParams = BN254, window: int = 13,
                  nthreads: int = 0) -> Tuple[int, int, int]:
    """Native MSM on little-endian u64 words: xs and ys (n, NW) affine
    coordinates in standard form, scalars (n, SW) below the group order.
    Returns a Jacobian (x, y, z) int tuple (standard form)."""
    cid = curve_id(curve)
    nw = (curve.p.bit_length() + 63) // 64
    sw = (curve.scalar_bits + 63) // 64
    n = xs.shape[0]
    xs, ys, scalars = (np.ascontiguousarray(a, dtype=np.uint64)
                       for a in (xs, ys, scalars))
    if xs.shape != (n, nw) or ys.shape != (n, nw) or scalars.shape != (n, sw):
        raise ValueError(f"cpu_msm: expected ({n}, {nw}) coordinates and "
                         f"({n}, {sw}) scalars, got {xs.shape}, {ys.shape}, "
                         f"{scalars.shape}")
    lib = _get_lib()
    out = np.zeros(3 * nw, dtype=np.uint64)
    rc = lib.cpu_msm(cid, xs.ctypes.data, ys.ctypes.data, scalars.ctypes.data,
                     n, window, nthreads, out.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"cpu_msm failed with code {rc}")

    def unpack(a):
        acc = 0
        for j in range(len(a) - 1, -1, -1):
            acc = (acc << 64) | int(a[j])
        return acc
    return (unpack(out[:nw]), unpack(out[nw:2 * nw]), unpack(out[2 * nw:]))


def cpu_msm(points: Sequence[Tuple[int, int]], scalars: Sequence[int],
            curve: CurveParams = BN254, window: int = 13,
            nthreads: int = 0) -> Tuple[int, int, int]:
    """Native MSM of affine int points and int scalars (truncated to the
    shorter, scalars taken mod the group order); returns a Jacobian
    (x, y, z) int tuple (standard form)."""
    curve_id(curve)
    n = min(len(points), len(scalars))
    nw = (curve.p.bit_length() + 63) // 64
    sw = (curve.scalar_bits + 63) // 64
    return cpu_msm_words(
        _pack_u64([p[0] for p in points[:n]], nw),
        _pack_u64([p[1] for p in points[:n]], nw),
        _pack_u64([s % curve.scalar_modulus for s in scalars[:n]], sw),
        curve, window, nthreads)


def mont_throughput(iters: int = 10_000_000) -> float:
    """Native Montgomery multiplies a second on one core (BN254): the
    host's speed anchor."""
    return float(_get_lib().cpu_mont_throughput(0, iters))

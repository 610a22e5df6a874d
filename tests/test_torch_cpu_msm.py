"""The port's native CPU MSM (`tpu_msm_torch/host/cpu_msm.py`) on the
CPU: its generated header against the JAX package's, its result against
the pure-Python oracle and the JAX package's `cpu_msm`, its refusals, and
a build that writes nothing into `native/` (it compiles with g++ into the
build directory)."""

from pathlib import Path

import numpy as np
import pytest

from tpu_msm.constants import CURVES as JCURVES
from tpu_msm.host import cpu_msm as jcpu
from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12, TINY62
from tpu_msm_torch.host import cpu_msm as cm
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils import cache

NATIVE = Path(__file__).resolve().parent.parent / "native"


def native_listing():
    return {p.name: p.stat().st_mtime_ns for p in NATIVE.iterdir()}


def test_header_equals_jax(tmp_path):
    ours, theirs = tmp_path / "ours.h", tmp_path / "theirs.h"
    cm.write_params_header(str(ours))
    jcpu.write_params_header(str(theirs))
    a, b = ours.read_text().splitlines(), theirs.read_text().splitlines()
    assert a[0].startswith("// Generated by tpu_msm_torch/host/cpu_msm.py")
    assert a[1:] == b[1:] and len(a) > 10
    assert ours.read_text() == cm.params_header()


@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12),
                         ids=lambda c: c.name)
def test_cpu_msm_equals_msm_naive(curve):
    pts, scalars = ref.gen_points_scalars(curve, 256, seed=11)
    scalars[3] = curve.scalar_modulus + 5         # reduced mod r
    scalars[4] = 0
    got = cm.cpu_msm(pts, scalars, curve)
    assert ref.jac_eq(curve, got, ref.msm_naive(curve, pts, scalars))
    # the same MSM on u64 words, and truncated to the shorter input
    got_w = cm.cpu_msm(pts + pts[:3], scalars, curve, window=9, nthreads=2)
    assert ref.jac_eq(curve, got_w, got)


def test_cpu_msm_equals_jax_cpu_msm():
    """The only test that builds the JAX package's library (which writes
    into native/)."""
    for curve in (BN254_S12, BLS12_377_S12):
        pts, scalars = ref.gen_points_scalars(curve, 256, seed=12)
        got = cm.cpu_msm(pts, scalars, curve)
        want = jcpu.cpu_msm(pts, scalars, JCURVES[curve.name])
        assert got == want


def test_refusals():
    pts, scalars = ref.gen_points_scalars(TINY62, 4, seed=13)
    with pytest.raises(ValueError, match="unsupported curve tiny62"):
        cm.cpu_msm(pts, scalars, TINY62)
    z4 = np.zeros((4, 4), np.uint64)
    with pytest.raises(ValueError, match="expected"):
        cm.cpu_msm_words(z4, z4[:3], z4, BN254_S12)
    with pytest.raises(RuntimeError, match="code 1"):
        cm.cpu_msm_words(z4, z4, z4, BN254_S12, window=1)


def test_build_writes_nothing_into_native(tmp_path, monkeypatch):
    before = native_listing()
    monkeypatch.setenv(cache._build.BUILD_DIR_ENV, "")   # restored after
    cache.enable_compile_cache(str(tmp_path))
    monkeypatch.setattr(cm, "_lib", None)
    lib = Path(cm.build(force=True))
    assert lib.parent == tmp_path and lib.name.startswith("libcpumsm-")
    assert (tmp_path / "params_gen.h").read_text() == cm.params_header()
    assert (tmp_path / "cpumsm.cpp").read_bytes() == \
        (NATIVE / "cpumsm.cpp").read_bytes()
    assert cm.mont_throughput(10_000) > 0
    assert Path(cm.build()) == lib            # cached: same hash
    assert native_listing() == before

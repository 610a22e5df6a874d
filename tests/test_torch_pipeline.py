"""The port's whole slice (tpu_msm_torch.tpu_variable_base_msm and
MSMPipeline) on CPU tensors, against the JAX package and the oracle.

TINY62 against JAX `tpu_variable_base_msm` on its XLA backend, window by
window; BN254_S12 against the oracle at n = 256 and 1024 with the
default schedule; the edge cases of tests/test_e2e.py; multi-pass;
`convert.from_jax`; the import boundary (no jax, no tpu_msm); and the
device rule (the default "cuda" raises without a GPU). Every comparison
is exact group equality (`jac_eq`)."""

import dataclasses
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import pipeline as jpipeline
from tpu_msm_torch import convert
from tpu_msm_torch.config import MSMConfig, default_config
from tpu_msm_torch.constants import BN254_S12, BN254_S13, TINY62
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.cuzk.pipeline import get_pipeline, tpu_variable_base_msm
from tpu_msm_torch.reference import curve as ref

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

# one small schedule for the edge cases: W = 32 windows of s = 8, C = 32
CFG = MSMConfig(curve=BN254_S12, window_size=8, columns=32, pbpr_threads=16,
                subtask_group=8)


def oracle(c, pts, scalars):
    return ref.msm_pippenger_signed(
        c, pts, [k % c.scalar_modulus for k in scalars], window=8)


def msm(pts, scalars, config=CFG, curve=BN254_S12):
    return tpu_variable_base_msm(pts, scalars, config=config, curve=curve,
                                 device="cpu")


# ---------------------------------------------------------------------------
# against the JAX package and the oracle
# ---------------------------------------------------------------------------


def test_slice_tiny62_matches_jax_xla():
    """Same packed inputs, same window sums, same MSM as the JAX pipeline
    (n = 200 pads to 224 lanes of generator points with zero scalars)."""
    fields = dict(window_size=8, columns=32, pbpr_threads=16,
                  subtask_group=4)
    jcfg = JaxConfig(curve=jc.TINY62, backend="xla", **fields)
    cfg = MSMConfig(curve=TINY62, **fields)
    pts, scalars = ref.gen_points_scalars(TINY62, 200, seed=61)
    jpipe = jpipeline.get_pipeline(jcfg)
    pipe = get_pipeline(cfg, "cpu")
    jpacked, packed = jpipe.pack(pts, scalars), pipe.pack(pts, scalars)
    for a, b in zip(jpacked, packed):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.astype(np.int64))
    jwin = jpipe.window_sums(*jpacked)
    win = pipe.window_sums(*packed)
    assert len(win) == len(jwin) == cfg.num_windows
    for a, b in zip(win, jwin):
        assert ref.jac_eq(TINY62, a, b)
    got = pipe.horner(win)
    assert ref.jac_eq(TINY62, got, jpipe.msm(pts, scalars))
    assert ref.jac_eq(TINY62, got, oracle(TINY62, pts, scalars))
    assert ref.jac_eq(TINY62, msm(pts, scalars, cfg, TINY62), got)


@pytest.mark.parametrize("n", [256, 1024])
def test_slice_bn254_s12_default_schedule(n):
    pts, scalars = ref.gen_points_scalars(BN254_S12, n, seed=n)
    got = tpu_variable_base_msm(pts, scalars, device="cpu")
    assert ref.jac_eq(BN254_S12, got, oracle(BN254_S12, pts, scalars))


def test_slice_leaves_launch_counts_alone_on_cpu():
    """The plain versions are no kernel launches."""
    kernels.reset_launches()
    pts, scalars = ref.gen_points_scalars(TINY62, 40, seed=62)
    cfg = dataclasses.replace(CFG, curve=TINY62)
    assert ref.jac_eq(TINY62, msm(pts, scalars, cfg, TINY62),
                      oracle(TINY62, pts, scalars))
    assert set(kernels.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# edge cases (tests/test_e2e.py)
# ---------------------------------------------------------------------------


def test_slice_single_point_and_tiny():
    c = BN254_S12
    pts, scalars = ref.gen_points_scalars(c, 3, seed=74)
    got = msm(pts[:1], scalars[:1])
    assert ref.jac_eq(c, got, ref.scalar_mul(c, (*pts[0], 1), scalars[0]))
    assert ref.jac_eq(c, msm(pts, scalars), oracle(c, pts, scalars))


def test_slice_adversarial_lanes():
    """Duplicate points, zero scalars, 1, r - 1 and scalars >= r."""
    c = BN254_S12
    rng = random.Random(72)
    pts, scalars = ref.gen_points_scalars(c, 64, seed=72)
    pts = pts + pts[:32]
    scalars = scalars + [rng.randrange(0, c.scalar_modulus)
                         for _ in range(32)]
    scalars[0] = 0
    scalars[1] = 1
    scalars[2] = c.scalar_modulus - 1
    scalars[3] = c.scalar_modulus              # == 0 in the group
    scalars[4] = c.scalar_modulus + 12345
    scalars[5] = (1 << c.scalar_bits) - 1      # largest scalar that fits
    assert ref.jac_eq(c, msm(pts, scalars), oracle(c, pts, scalars))


def test_slice_equal_scalars_long_runs():
    """One bucket run per window spanning every scan column."""
    c = BN254_S12
    pts, _ = ref.gen_points_scalars(c, 96, seed=73)
    scalars = [random.Random(73).randrange(1, c.scalar_modulus)] * 96
    assert ref.jac_eq(c, msm(pts, scalars), oracle(c, pts, scalars))


def test_slice_sum_to_infinity_and_all_zero():
    c = BN254_S12
    pts, _ = ref.gen_points_scalars(c, 2, seed=75)
    assert ref.is_inf(msm([pts[0], pts[0]], [5, c.scalar_modulus - 5]))
    assert ref.is_inf(msm(pts, [0, 0]))


def test_slice_truncate_and_empty():
    c = BN254_S12
    pts, scalars = ref.gen_points_scalars(c, 8, seed=76)
    full = msm(pts, scalars)
    assert ref.jac_eq(c, full, oracle(c, pts, scalars))
    assert ref.jac_eq(c, full, msm(pts, scalars + [12345] * 5))
    assert ref.jac_eq(c, full, msm(pts + pts[:3], scalars))
    for a, b in (([], []), (pts, []), ([], scalars)):
        with pytest.raises(ValueError):
            msm(a, b)


@pytest.mark.parametrize("cfg", [
    MSMConfig(curve=BN254_S12, window_size=11, columns=16, pbpr_threads=8,
              subtask_group=4),
    MSMConfig(curve=BN254_S13, window_size=8, columns=32, pbpr_threads=16,
              subtask_group=8),
], ids=["s11_C16", "bn254_s13"])
def test_slice_other_shapes_and_profiles(cfg):
    """R > 1 rows per column with an odd window; the 13-bit profile whose
    Montgomery multiply takes the mid-loop fold."""
    c = cfg.curve
    pts, scalars = ref.gen_points_scalars(c, 160, seed=77)
    scalars[0], scalars[1] = 0, c.scalar_modulus - 1
    assert ref.jac_eq(c, msm(pts, scalars, cfg, c), oracle(c, pts, scalars))


def test_slice_multi_pass():
    """max_points_per_pass below n: three passes whose window sums add on
    the host, equal window by window to one pass."""
    c = BN254_S12
    pts, scalars = ref.gen_points_scalars(c, 150, seed=79)
    multi = dataclasses.replace(CFG, max_points_per_pass=64)
    got = msm(pts, scalars, multi)
    assert ref.jac_eq(c, got, oracle(c, pts, scalars))
    one, three = get_pipeline(CFG, "cpu"), get_pipeline(multi, "cpu")
    packed = one.pack(pts, scalars)
    for a, b in zip(one.window_sums(*packed), three.window_sums(*packed)):
        assert ref.jac_eq(c, a, b)


# ---------------------------------------------------------------------------
# convert.from_jax
# ---------------------------------------------------------------------------


def test_convert_from_jax():
    c = BN254_S12
    jcfg = JaxConfig(curve=jc.BN254_S12, window_size=8, columns=32,
                     pbpr_threads=16, subtask_group=8, backend="xla")
    pts, scalars = ref.gen_points_scalars(c, 64, seed=80)
    xs, ys, hw = jpipeline.get_pipeline(jcfg).pack(pts, scalars)
    for fields in (dataclasses.asdict(jcfg),
                   {f.name: getattr(jcfg, f.name)
                    for f in dataclasses.fields(jcfg)}):
        cfg, tx, ty, th = convert.from_jax(xs, ys, hw, fields, device="cpu")
        assert cfg == CFG
        assert all(t.dtype == torch.int32 and t.device.type == "cpu"
                   for t in (tx, ty, th))
        assert np.array_equal(th.numpy(), hw.astype(np.int32))
        pipe = get_pipeline(cfg, "cpu")
        got = pipe.horner(pipe.window_sums(tx, ty, th))
        assert ref.jac_eq(c, got, oracle(c, pts, scalars))
    glv = convert.config_from_fields({**dataclasses.asdict(jcfg),
                                      "glv": True})
    assert glv == dataclasses.replace(CFG, glv=True)
    with pytest.raises(ValueError):
        convert.config_from_fields({"curve": "bn254_s12", "bogus": 1})
    with pytest.raises(ValueError):
        convert.from_jax(xs[:-1], ys, hw, dataclasses.asdict(jcfg), "cpu")


# ---------------------------------------------------------------------------
# the package boundary and the device rule
# ---------------------------------------------------------------------------


def test_import_boundary_no_jax_no_tpu_msm():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu_msm_torch\n"
        "for m in pkgutil.walk_packages(tpu_msm_torch.__path__, "
        "'tpu_msm_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib')) or k == 'tpu_msm' or "
        "k.startswith('tpu_msm.'))\n"
        "n = sum(k.startswith('tpu_msm_torch.') for k in sys.modules)\n"
        "print(n, bad)\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, _ = out.stdout.split(" ", 1)
    assert int(n) >= 18, out.stdout
    mods = {p.relative_to(REPO).with_suffix("").as_posix().replace("/", ".")
            for p in (REPO / "tpu_msm_torch").rglob("*.py")}
    assert {"tpu_msm_torch.glv", "tpu_msm_torch.cuzk.glv",
            "tpu_msm_torch.cuzk.pbpr", "tpu_msm_torch.ops.inverse",
            "tpu_msm_torch.ops.limbs", "tpu_msm_torch.ops.barrett",
            "tpu_msm_torch.parallel.sharded"} <= mods


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, scalars = ref.gen_points_scalars(TINY62, 4, seed=81)
    with pytest.raises(RuntimeError, match="cuda"):
        tpu_variable_base_msm(pts, scalars, curve=TINY62)
    with pytest.raises(RuntimeError):
        get_pipeline(default_config(4, TINY62))
    with pytest.raises(RuntimeError):
        convert.from_jax(np.zeros((6, 4)), np.zeros((6, 4)),
                         np.zeros((6, 4)), {"curve": "tiny62"})


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors: a tensor
    elsewhere (here the meta device) is refused, never computed."""
    x = torch.empty((6, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        kernels.encode_mont(x, TINY62)
    with pytest.raises(ValueError):
        get_pipeline(CFG, "meta")
    p = torch.empty((3, 6, 2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        kernels.pdbl_batch(p, TINY62)
    with pytest.raises(ValueError, match="meta"):
        kernels.pbpr_stage1(p, TINY62, 4)
    with pytest.raises(ValueError, match="meta"):
        kernels.globalize(p, p[:, :, 0], TINY62)
    # a mix of devices is refused too, never sent to the plain version
    with pytest.raises(ValueError):
        kernels.globalize(torch.zeros((3, 6, 2, 8), dtype=torch.int32),
                          p[:, :, 0], TINY62)


def test_glv_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, scalars = ref.gen_points_scalars(BN254_S12, 4, seed=82)
    with pytest.raises(RuntimeError, match="cuda"):
        tpu_variable_base_msm(pts, scalars,
                              config=dataclasses.replace(CFG, glv=True))

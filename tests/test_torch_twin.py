"""The port of the JAX package's XLA path (tpu_msm_torch/cuzk/decompose.py,
sort.py, smvp.py, pipeline._windows_device, MSMConfig.backend) on CPU
tensors, against the JAX functions on the same inputs from a seed:
decompose and sort bit for bit; the stitch's scan order against
`jax.lax.associative_scan`; `bucket_accumulate` bit for bit at TINY62
(BN254_S12 in tests/test_torch_twin_bn254.py); `_windows_device` bit
for bit at TINY62 (so equal by decoded value), unsharded and at
w_shards = 2 for both w_index; the MSM with backend="xla" EXACT against
the oracle on the adversarial, equal-scalar and sum-to-infinity inputs
of tests/test_e2e.py; the backend's validation, dispatch and carrying
from JAX; the sharded pipeline on one gloo rank under backend="xla"."""

import dataclasses
import datetime
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_twin as tw
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import decompose as jdecompose
from tpu_msm.cuzk import smvp as jsmvp
from tpu_msm.cuzk import sort as jsort
from tpu_msm_torch import constants as tc
from tpu_msm_torch import convert
from tpu_msm_torch.config import MSMConfig, default_config
from tpu_msm_torch.cuzk import decompose, kernels, pipeline, smvp, sort
from tpu_msm_torch.cuzk.pipeline import (MSMPipeline, _windows_device,
                                         get_pipeline, tpu_variable_base_msm)
from tpu_msm_torch.cuzk.pipeline_cuda import windows_device
from tpu_msm_torch.parallel import sharded
from tpu_msm_torch.reference import curve as ref

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# stage 1: encoding and digits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [3, 8, 13, 16])
def test_decompose_matches_jax(s):
    c = tc.BN254_S12
    cfg = MSMConfig(curve=c, window_size=s, columns=32, pbpr_threads=2,
                    subtask_group=1)
    pts, scalars = ref.gen_points_scalars(c, 8, seed=s)
    scalars += [0, 1, c.scalar_modulus - 1, (1 << 253) - 1]
    _, _, hw = get_pipeline(cfg, "cpu").pack(pts[:1] * 12, scalars)
    jhw = jnp.asarray(hw.astype(np.uint32))
    thw = torch.from_numpy(hw)
    raw = decompose.extract_windows(thw, s, cfg.num_windows)
    jraw = jdecompose.extract_windows(jhw, s, cfg.num_windows)
    assert raw.dtype == torch.int32
    assert np.array_equal(np.asarray(jraw).astype(np.int64), raw.numpy())
    digits = decompose.signed_digits(raw, s)
    jdigits = jdecompose.signed_digits(jraw, s)
    assert np.array_equal(np.asarray(jdigits), digits.numpy())
    got = decompose.decompose(thw, cfg)        # the kernel's plain version
    assert np.array_equal(np.asarray(jdecompose.decompose(jhw, cfg)),
                          got.numpy().astype(np.int32))
    for i, k in enumerate(scalars):
        assert sum(int(d) << (s * w) for w, d in enumerate(got[:, i])) == k


@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_points_to_mont_matches_jax(name):
    _, _, xs, ys, _ = tw.inputs(name)
    jcurve = tw.jax_config(name).curve
    jx, jy = jdecompose.points_to_mont(jnp.asarray(xs), jnp.asarray(ys),
                                       jcurve)
    tx, ty = decompose.points_to_mont(*tw.tensors(xs, ys),
                                      tw.config(name).curve)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jy), ty.numpy())


# ---------------------------------------------------------------------------
# stage 2: the sort
# ---------------------------------------------------------------------------


def test_sort_matches_jax():
    rng = np.random.default_rng(7)
    digits = rng.integers(-8, 9, (5, 300)).astype(np.int32)
    digits[1] = 3                             # one run the whole window
    keys, neg = sort.bucket_keys(torch.from_numpy(digits))
    jkeys, jneg = jsort.bucket_keys(jnp.asarray(digits))
    assert np.array_equal(np.asarray(jkeys), keys.numpy())
    assert np.array_equal(np.asarray(jneg), neg.numpy())
    skeys, perm = sort.sort_by_bucket(keys)
    jskeys, jperm = jsort.sort_by_bucket(jkeys)
    # stable on both sides: the same permutation, ties in index order
    assert np.array_equal(np.asarray(jperm), perm.numpy())
    assert np.array_equal(np.asarray(jskeys), skeys.numpy())
    ptr = sort.csc_col_ptr(keys, 9)
    assert ptr.dtype == torch.int32
    assert np.array_equal(np.asarray(jsort.csc_col_ptr(jkeys, 9)),
                          ptr.numpy())
    assert (ptr[:, -1] == 300).all()


# ---------------------------------------------------------------------------
# stage 3: the scan order of the stitch, the bucket sums
# ---------------------------------------------------------------------------


def _mix(a, b):
    """A combine that is neither commutative nor associative on values
    in [0, 32749), under segment flags: its results name the exact tree
    of combinations."""
    (av, af), (bv, bf) = a, b
    where = torch.where if isinstance(av, torch.Tensor) else jnp.where
    return where(bf, bv, (av * 181 + bv) % 32749), af | bf


@pytest.mark.parametrize("m", list(range(1, 10)) + [16, 17, 31, 32, 33, 64])
def test_associative_scan_order_matches_jax(m):
    rng = np.random.default_rng(m)
    v = rng.integers(0, 32749, m).astype(np.int32)
    f = rng.random(m) < 0.25
    want = jax.lax.associative_scan(_mix, (jnp.asarray(v), jnp.asarray(f)))

    def nonempty_mix(a, b):
        # a combine is one padd_batch launch, which refuses zero lanes
        assert a[0].numel() and a[0].shape == b[0].shape
        return _mix(a, b)

    got = kernels.associative_scan(nonempty_mix, (torch.from_numpy(v),
                                                  torch.from_numpy(f)))
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert np.array_equal(np.asarray(want[1]), got[1].numpy())


def group_inputs(name):
    """(xm, ym, the first group's digits) of tw.inputs(name)."""
    cfg = tw.config(name)
    _, _, xs, ys, hw = tw.inputs(name)
    xm, ym = decompose.points_to_mont(*tw.tensors(xs, ys), cfg.curve)
    digits = decompose.decompose(torch.from_numpy(hw), cfg)
    return cfg, xm, ym, digits[:cfg.subtask_group].to(torch.int32)


def test_bucket_accumulate_matches_jax_tiny62():
    """Bit for bit: the buckets of the XLA order of the stitch. Each
    window has a run of 40 positions over 8 rows: five columns and more
    continue one bucket."""
    cfg, xm, ym, digits = group_inputs("tiny62")
    kernels.reset_launches()
    got = smvp.bucket_accumulate(xm, ym, digits, cfg)
    assert set(kernels.LAUNCHES.values()) == {0}      # plain on the CPU
    Wg, B = cfg.subtask_group, cfg.half_columns
    assert got.shape == (3, cfg.curve.num_limbs, Wg, B)
    fn = jax.jit(lambda x, y, d: jsmvp.bucket_accumulate(
        x, y, d, tw.jax_config("tiny62")))
    want = fn(*(jnp.asarray(a.numpy()) for a in (xm, ym, digits)))
    assert np.array_equal(np.stack([np.asarray(a) for a in want]),
                          got.numpy())


# ---------------------------------------------------------------------------
# the device program
# ---------------------------------------------------------------------------


def test_windows_device_matches_jax_tiny62():
    cfg = tw.config("tiny62")
    _, _, xs, ys, hw = tw.inputs("tiny62")
    got = _windows_device(*tw.tensors(xs, ys, hw), cfg=cfg)
    want = tw.jax_windows("tiny62", False, xs, ys, hw)
    tw.check_windows(cfg.curve, got, want)
    # the CUDA kernel path's window sums are the same points
    tw.same_points(cfg.curve, tw.decode(got, cfg.curve), tw.decode(
        windows_device(*tw.tensors(xs, ys, hw), cfg), cfg.curve))
    # w_shards = 2: each shard is its block of JAX's windows
    Wl = cfg.padded_windows // 2
    for i in range(2):
        g = _windows_device(*tw.tensors(xs, ys, hw), cfg=cfg, w_shards=2,
                            w_index=i)
        tw.check_windows(cfg.curve, g, want[:, :, i * Wl:(i + 1) * Wl])


@pytest.mark.parametrize("w_shards,w_index", [(3, 0), (8, 0), (0, 0),
                                               (2, 2), (2, -1)])
def test_windows_device_refuses_shards(w_shards, w_index):
    """TINY62 with 4 groups: w must divide them and index a shard."""
    _, _, xs, ys, hw = tw.inputs("tiny62")
    with pytest.raises(ValueError, match="w_"):
        _windows_device(*tw.tensors(xs, ys, hw), cfg=tw.config("tiny62"),
                        w_shards=w_shards, w_index=w_index)


# ---------------------------------------------------------------------------
# the MSM under backend="xla", EXACT against the oracle
# ---------------------------------------------------------------------------


def oracle(c, pts, scalars):
    return ref.msm_pippenger_signed(c, pts, scalars, window=8)


def xla_msm(name, pts, scalars):
    kernels.reset_launches()
    got = tpu_variable_base_msm(pts, scalars, config=tw.config(name),
                                device="cpu")
    assert set(kernels.LAUNCHES.values()) == {0}
    return got


@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_xla_msm_random_and_equal_runs(name):
    c = tc.CURVES[name]
    pts, scalars, _, _, _ = tw.inputs(name)
    assert ref.jac_eq(c, xla_msm(name, pts, scalars),
                      oracle(c, pts, scalars))


def test_xla_msm_adversarial_lanes():
    c = tc.BN254_S12
    rng = random.Random(72)
    pts, scalars = ref.gen_points_scalars(c, 40, seed=72)
    pts = pts + pts[:24]            # duplicate points
    scalars = scalars + [rng.randrange(0, c.scalar_modulus)
                         for _ in range(24)]
    scalars[0] = 0                  # zero scalar
    scalars[1] = 1
    scalars[2] = c.scalar_modulus - 1
    assert ref.jac_eq(c, xla_msm("bn254_s12", pts, scalars),
                      oracle(c, pts, scalars))


def test_xla_msm_equal_scalars_all_lanes():
    """Every point has the same digit in every window: each window is one
    bucket run over all columns."""
    c = tc.TINY62
    pts, _ = ref.gen_points_scalars(c, 48, seed=73)
    k = random.Random(73).randrange(1, c.scalar_modulus)
    assert ref.jac_eq(c, xla_msm("tiny62", pts, [k] * 48),
                      oracle(c, pts, [k] * 48))


@pytest.mark.parametrize("name", ["tiny62", "bn254_s12"])
def test_xla_msm_sum_to_infinity_and_one_point(name):
    c = tc.CURVES[name]
    pts, scalars = ref.gen_points_scalars(c, 2, seed=75)
    got = xla_msm(name, [pts[0], pts[0]], [5, c.scalar_modulus - 5])
    assert ref.is_inf(got)
    got = xla_msm(name, pts[1:], scalars[1:])
    assert ref.jac_eq(c, got, ref.msm_naive(c, pts[1:], scalars[1:]))


# ---------------------------------------------------------------------------
# the backend: validation, dispatch, carried from JAX
# ---------------------------------------------------------------------------


def test_backend_validation_and_dispatch():
    assert MSMConfig().backend == "auto"
    for n in (4, 1 << 12, 1 << 16, 1 << 20):
        cfg = default_config(n)
        assert cfg.backend == "auto"
        assert MSMPipeline.windows_fn(cfg) is windows_device
    for backend, fn in (("auto", windows_device), ("cuda", windows_device),
                        ("xla", _windows_device)):
        assert MSMPipeline.windows_fn(MSMConfig(backend=backend)) is fn
    for bad in ("pallas", "XLA", "", None):
        with pytest.raises(ValueError, match="backend"):
            MSMConfig(backend=bad)


def test_pipeline_runs_the_backends_program(monkeypatch):
    """MSMPipeline._device_program goes through windows_fn: under "xla"
    the twin runs, under "auto" the kernel path."""
    calls = []
    real = pipeline._windows_device
    monkeypatch.setattr(pipeline, "_windows_device",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    c = tc.TINY62
    pts, scalars = ref.gen_points_scalars(c, 20, seed=77)
    want = oracle(c, pts, scalars)
    cfg = tw.config("tiny62")
    assert ref.jac_eq(c, get_pipeline(cfg, "cpu").msm(pts, scalars), want)
    assert len(calls) == 1 and calls[0]["cfg"] == cfg
    auto = dataclasses.replace(cfg, backend="auto")
    assert ref.jac_eq(c, get_pipeline(auto, "cpu").msm(pts, scalars), want)
    assert len(calls) == 1


def test_config_from_fields_maps_backend():
    jcfg = JaxConfig(curve=tw.jax_config("bn254_s12").curve,
                     **tw.FIELDS["bn254_s12"])
    fields = dataclasses.asdict(jcfg)
    for jax_backend, port in (("pallas", "cuda"), ("xla", "xla"),
                              ("auto", "auto")):
        cfg = convert.config_from_fields({**fields, "backend": jax_backend})
        assert cfg == tw.config("bn254_s12", backend=port)
    assert convert.config_from_fields({"curve": "tiny62"}).backend == "auto"
    for bad in ("cuda", "tpu"):
        with pytest.raises(ValueError, match="backend"):
            convert.config_from_fields({"curve": "tiny62", "backend": bad})


@pytest.fixture
def world1(tmp_path):
    """A gloo world of this process alone, met through a file store."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_sharded_runs_the_twin_under_xla(world1, monkeypatch):
    """The sharded pipeline dispatches through MSMPipeline.windows_fn, as
    the JAX package does: under backend="xla" a rank runs
    `_windows_device(..., w_shards, w_index)`."""
    calls = []
    real = pipeline._windows_device
    monkeypatch.setattr(pipeline, "_windows_device",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    c = tc.TINY62
    cfg = tw.config("tiny62")
    mesh = convert.mesh_from_jax({"x": 1, "w": 1}, "cpu")
    pts, scalars = ref.gen_points_scalars(c, 24, seed=78)
    got = sharded.sharded_msm(pts, scalars, mesh, config=cfg, device="cpu")
    assert ref.jac_eq(c, got, oracle(c, pts, scalars))
    assert [(k["w_shards"], k["w_index"]) for k in calls] == [(1, 0)]

"""The port's multi-device MSM pieces in one process, on CPU tensors,
against the JAX package (tpu_msm_torch/parallel/sharded.py, the window
shard of cuzk/pipeline_cuda.windows_device, convert.mesh_from_jax).

The window shard at w = 2 and 4 on TINY62 (W = 8 windows, Wg = 1: 8
groups) and on BN254_S12 with tests/test_sharded.py's config (W = 32,
Wg = 8: 4 groups): the shards concatenated equal the unsharded window
sums, and each shard equals JAX `_windows_device(..., w_shards,
w_index)` (one jit a w, w_index traced; BN254_S12 at w = 2 against
pairs of JAX's w = 4 shards), window by window by group value. `_reduce_gathered` against the JAX `_reduce_gathered` at ndev = 2,
4 and 8 on window sums made from a numpy seed. The sharded pipeline on
a gloo world of one rank, against the oracle and the one-device
pipeline; the mesh's refusals; the device rule. The gloo worlds of
several ranks are in tests/test_torch_sharded_ranks.py."""

import datetime
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharded_ranks as ranks
from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk.pipeline import _windows_device as jax_windows_device
from tpu_msm.ops.complete import ProjPoint
from tpu_msm.parallel.sharded import _reduce_gathered as jax_reduce_gathered
from tpu_msm_torch import convert
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.constants import BN254_S12, TINY62, int_to_limbs
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.cuzk.pipeline import get_pipeline
from tpu_msm_torch.cuzk.pipeline_cuda import windows_device
from tpu_msm_torch.parallel import sharded, spawn
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import planar_signed_to_ints_modp

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

# (port curve, JAX curve, config fields): tests/test_sharded.py's configs
CASES = {
    "tiny62": (TINY62, jc.TINY62, dict(window_size=8, columns=16,
                                       pbpr_threads=8, subtask_group=1)),
    "bn254_s12": (BN254_S12, jc.BN254_S12, dict(window_size=8, columns=32,
                                                 pbpr_threads=16,
                                                 subtask_group=8)),
}
N = 64


def decode(arr, curve):
    """(3, L, k) signed lazy Montgomery limbs -> k Jacobian int tuples."""
    arr = np.asarray(arr)
    out = []
    for x, y, z in zip(*(planar_signed_to_ints_modp(a, curve) for a in arr)):
        if z == 0:
            out.append(ref.INF)
        else:
            zi = pow(z, -1, curve.p)
            out.append((x * zi % curve.p, y * zi % curve.p, 1))
    return out


def same_points(curve, got, want):
    assert len(got) == len(want)
    for w, (a, b) in enumerate(zip(got, want)):
        assert ref.jac_eq(curve, a, b), f"window {w}"


@functools.lru_cache(maxsize=None)
def packed(name):
    """(config, planar xs, ys, halfwords, unsharded window sums) of N
    points of the case's curve."""
    curve, _, fields = CASES[name]
    cfg = MSMConfig(curve=curve, **fields)
    pts, scalars = ref.gen_points_scalars(curve, N, seed=91)
    xs, ys, hw = get_pipeline(cfg, "cpu").pack(pts, scalars)
    full = windows_device(*map(torch.from_numpy, (xs, ys, hw)), cfg)
    return cfg, xs, ys, hw, decode(full, curve)


# ---------------------------------------------------------------------------
# the window shard of windows_device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_shards_match_unsharded_and_jax(name, w):
    cfg, xs, ys, hw, full = packed(name)
    curve = CASES[name][0]
    Wl = cfg.padded_windows // w
    shards = [windows_device(*map(torch.from_numpy, (xs, ys, hw)), cfg,
                             w_shards=w, w_index=i) for i in range(w)]
    for g in shards:
        assert g.shape == (3, curve.num_limbs, Wl) and g.dtype == torch.int32
    same_points(curve, decode(torch.cat(shards, dim=2), curve), full)

    for i, g in enumerate(shards):
        same_points(curve, decode(g, curve), jax_shard(name, w, i))


# BN254_S12's shards at w = 2 are held against JAX's at w = 4, two of
# them a shard: one BN254 compile fewer, minutes on a cold cache.
JAX_SHARDS_FROM = {("bn254_s12", 2): 4}


@functools.lru_cache(maxsize=None)
def jax_shards(name, w):
    """JAX `_windows_device(..., w_shards=w, w_index=i)` of packed(name)
    for every i, decoded: one jit a w, w_index traced."""
    _, xs, ys, hw, _ = packed(name)
    _, jcurve, fields = CASES[name]
    jfn = jax.jit(functools.partial(
        jax_windows_device, cfg=JaxConfig(curve=jcurve, backend="xla",
                                          **fields), w_shards=w))
    out = []
    for i in range(w):
        jg = jfn(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(hw),
                 w_index=jnp.int32(i))
        out.append(decode(np.stack([jg.x, jg.y, jg.z]), CASES[name][0]))
    return out


def jax_shard(name, w, i):
    """The decoded window sums of JAX's shard i of w."""
    wj = JAX_SHARDS_FROM.get((name, w), w)
    k = wj // w                         # JAX shards a shard of this w
    return sum(jax_shards(name, wj)[i * k:(i + 1) * k], [])


def test_window_shard_under_glv_matches_unsharded():
    """GLV goes through the same slice, after apply_glv: W = 17, Wg = 8,
    3 groups on 2n stream lanes."""
    cfg = MSMConfig(curve=BN254_S12, glv=True, **CASES["bn254_s12"][2])
    assert cfg.num_groups == 3
    pts, scalars = ref.gen_points_scalars(BN254_S12, 32, seed=92)
    t = list(map(torch.from_numpy, get_pipeline(cfg, "cpu").pack(
        pts, scalars)))
    full = decode(windows_device(*t, cfg), BN254_S12)
    shards = [windows_device(*t, cfg, w_shards=3, w_index=i)
              for i in range(3)]
    same_points(BN254_S12, decode(torch.cat(shards, dim=2), BN254_S12),
                full)


@pytest.mark.parametrize("w_shards,w_index", [(3, 0), (8, 0), (0, 0),
                                               (2, 2), (2, -1)])
def test_window_shard_refuses(w_shards, w_index):
    """BN254_S12 with 4 groups: w must divide them and index a shard."""
    cfg, xs, ys, hw, _ = packed("bn254_s12")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="w_"):
        windows_device(*map(torch.from_numpy, (xs, ys, hw)), cfg,
                       w_shards=w_shards, w_index=w_index)


# ---------------------------------------------------------------------------
# the reduction tree over the gathered sums
# ---------------------------------------------------------------------------


def random_sums(curve, ndev, Wp, seed):
    """(3, L, ndev, Wp) int32 projective Montgomery points with canonical
    limbs: multiples of the generator with a random Z, from a numpy seed;
    every fifth at infinity, and the first two devices' first sums P and
    -P."""
    rng = np.random.default_rng(seed)
    L, w, p = curve.num_limbs, curve.log_limb_size, curve.p
    g = (curve.gen_x, curve.gen_y, 1)
    aff = [ref.to_affine(curve, ref.scalar_mul(
        curve, g, int(rng.integers(1, 1 << 62)))) for _ in range(ndev * Wp)]
    aff[Wp] = (aff[0][0], -aff[0][1] % p)
    out = np.zeros((3, L, ndev * Wp), np.int32)
    for i, (x, y) in enumerate(aff):
        z = int(rng.integers(1, 1 << 62)) % p or 1
        pt = (0, 1, 0) if i % 5 == 4 else (x * z % p, y * z % p, z)
        for c, v in enumerate(pt):
            out[c, :, i] = int_to_limbs(curve.to_mont(v), L, w)
    return out.reshape(3, L, ndev, Wp)


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reduce_gathered_matches_jax(name, ndev):
    curve, jcurve, _ = CASES[name]
    Wp = 6
    sums = random_sums(curve, ndev, Wp, seed=ndev)
    kernels.reset_launches()
    got = sharded._reduce_gathered(torch.from_numpy(sums), curve, ndev)
    assert got.shape == (3, curve.num_limbs, Wp)
    assert set(kernels.LAUNCHES.values()) == {0}     # plain on the CPU
    moved = [jnp.asarray(np.moveaxis(a, 1, 0)) for a in sums]  # (ndev, L, Wp)
    want = jax.jit(functools.partial(jax_reduce_gathered, curve=jcurve,
                                     ndev=ndev))(ProjPoint(*moved))
    same_points(curve, decode(got, curve),
                decode(np.stack([want.x, want.y, want.z]), curve))
    # and the sum window by window on the host
    host = decode(sums.reshape(3, curve.num_limbs, -1), curve)
    for j in range(Wp):
        acc = ref.INF
        for d in range(ndev):
            acc = ref.add(curve, acc, host[d * Wp + j])
        assert ref.jac_eq(curve, decode(got, curve)[j], acc)


@pytest.mark.parametrize("ndev", [3, 6, 0])
def test_reduce_gathered_refuses_other_counts(ndev):
    sums = torch.zeros((3, TINY62.num_limbs, max(ndev, 1), 2),
                       dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        sharded._reduce_gathered(sums, TINY62, ndev)


def test_reduce_gathered_refuses_a_wrong_shape():
    sums = torch.zeros((3, TINY62.num_limbs, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        sharded._reduce_gathered(sums, TINY62, 2)


# ---------------------------------------------------------------------------
# meshes and the sharded pipeline on a world of one rank
# ---------------------------------------------------------------------------


@pytest.fixture
def world1(tmp_path):
    """A gloo world of this process alone, met through a file store."""
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_mesh_from_jax(world1):
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("x", "w"))
    mesh = convert.mesh_from_jax(dict(jmesh.shape), "cpu")
    assert mesh.mesh_dim_names == ("x", "w") and mesh.shape == (1, 1)
    assert mesh.device_type == "cpu"
    mesh = convert.mesh_from_jax({"x": 1}, "cpu")
    assert mesh.mesh_dim_names == ("x",) and mesh.shape == (1,)
    for bad in ({"y": 1}, {"x": 1, "tp": 1}, {}):
        with pytest.raises(ValueError, match="axes"):
            convert.mesh_from_jax(bad, "cpu")


def test_sharded_one_rank_matches_oracle_and_one_device(world1):
    curve, _, fields = CASES["tiny62"]
    cfg = MSMConfig(curve=curve, **fields)
    mesh = convert.mesh_from_jax({"x": 1, "w": 1}, "cpu")
    pts, scalars = ref.gen_points_scalars(curve, 40, seed=93)
    got = sharded.sharded_msm(pts, scalars, mesh, config=cfg, device="cpu")
    want = ref.msm_pippenger_signed(curve, pts, scalars, window=8)
    assert ref.jac_eq(curve, got, want)
    pipe = sharded.get_sharded_pipeline(cfg, mesh, "cpu")
    one = get_pipeline(cfg, "cpu")
    same_points(curve, pipe.window_sums(*pipe.pack(pts, scalars)),
                one.window_sums(*one.pack(pts, scalars)))
    # the default schedule from the total n, inputs truncated to the
    # shorter length
    got = sharded.sharded_msm(pts + pts[:3], scalars, mesh, curve=curve,
                              device="cpu")
    assert ref.jac_eq(curve, got, want)
    with pytest.raises(ValueError, match="empty"):
        sharded.sharded_msm([], scalars, mesh, device="cpu")


class _Mesh:
    """The two things `make_sharded_windows_fn` reads of a mesh before
    it touches a process group."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes) or None
        self._sizes = list(sizes.values())

    def size(self, dim):
        return self._sizes[dim]


@pytest.mark.parametrize("sizes,match", [
    (dict(x=2, w=3), "divide"), (dict(x=1, w=8), "divide"),
    (dict(x=3), "power of two"), (dict(x=6, w=2), "power of two"),
    (dict(w=2), "expected"), (dict(x=2, tp=2), "expected"), ({}, "expected"),
])
def test_sharded_windows_fn_refuses(sizes, match):
    cfg = MSMConfig(curve=TINY62, **{**CASES["tiny62"][2],
                                     "subtask_group": 2})   # 4 groups
    with pytest.raises(ValueError, match=match):
        sharded.make_sharded_windows_fn(cfg, _Mesh(**sizes))


def test_sharded_default_device_raises_without_gpu(world1, monkeypatch):
    mesh = convert.mesh_from_jax({"x": 1}, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, scalars = ref.gen_points_scalars(TINY62, 4, seed=94)
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.sharded_msm(pts, scalars, mesh, curve=TINY62)
    cfg = MSMConfig(curve=TINY62, **CASES["tiny62"][2])
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.get_sharded_pipeline(cfg, mesh)


# ---------------------------------------------------------------------------
# the spawn harness of the rank processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,error,match", [
    ("ok", None, None),
    ("raise", RuntimeError, r"rank 1 of 3 failed:(.|\n)*rank 1 raised"),
    ("die", RuntimeError, r"ranks \[1\] of 3 died \(exit codes \[3\]\)"),
    ("hang", TimeoutError, r"ranks \[1\] of 3 not done in 10"),
], ids=["ok", "raise", "die", "hang"])
def test_spawn_run_ranks(mode, error, match):
    """Values in rank order; a rank that raises, dies without a value or
    outlives the deadline fails the call, and no rank outlives it."""
    t0 = time.monotonic()
    if error is None:
        assert spawn.run_ranks(ranks.probe, 3, (mode,), 60) == [
            (0, 3), (1, 3), (2, 3)]
        return
    with pytest.raises(error, match=match):
        spawn.run_ranks(ranks.probe, 3, (mode,), 10)
    assert time.monotonic() - t0 < 40

"""The static schedule's window group (`config.static_config`): all of a
call's windows in one group from 2^18 points up, the smaller sizes as
they were; the MSM at one group against one window a group through the
plain versions; and `parallel/sharded.sharded_config`, which splits the
one group over a mesh's window shards. No JAX, no card."""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_msm_torch.config import static_config
from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12, TINY62
from tpu_msm_torch.cuzk import kernels, pipeline
from tpu_msm_torch.parallel import sharded
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils import preprocess, window

torch.set_num_threads(1)

FIELDS = ("window_size", "columns", "pbpr_threads", "subtask_group",
          "max_points_per_pass")
# the schedule below 2^18, (first n, fields) a step, as the JAX package
# has it
BELOW = ((1, (8, 32, 16, 8, 1 << 23)), (1 << 10, (10, 256, 64, 8, 1 << 23)),
         (1 << 14, (13, 2048, 256, 4, 1 << 23)))


@pytest.fixture(autouse=True)
def no_autotune_cache(tmp_path, monkeypatch):
    """`default_config` on the static schedule: no cache file."""
    monkeypatch.setenv(window.CACHE_ENV, str(tmp_path / "absent.json"))


@pytest.mark.parametrize("logn", (18, 20, 22))
@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12),
                         ids=lambda c: c.name)
def test_static_config_one_window_group_from_2p18(curve, logn):
    cfg = static_config(1 << logn, curve)
    assert (cfg.window_size, cfg.columns, cfg.pbpr_threads,
            cfg.max_points_per_pass) == (16, 8192, 512, 1 << 22)
    assert cfg.num_windows == 16
    assert cfg.subtask_group == cfg.num_windows
    assert cfg.num_groups == 1 and cfg.padded_windows == cfg.num_windows


@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12, TINY62),
                         ids=lambda c: c.name)
def test_static_config_below_2p18_unchanged(curve):
    for (lo, fields), hi in zip(BELOW, [b[0] for b in BELOW[1:]] + [1 << 18]):
        for n in (lo, (lo + hi) // 2, hi - 1):
            cfg = static_config(n, curve)
            assert tuple(getattr(cfg, f) for f in FIELDS) == fields, n
            assert cfg.curve == curve and not cfg.glv


def spy_calls(monkeypatch, names):
    """Count the calls of the stage-3 wrappers that windows_device
    makes (on the CPU they run the plain versions)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(kernels, name, counted)
    return calls


@pytest.mark.parametrize("curve,n", ((TINY62, 96), (BN254_S12, 64)),
                         ids=lambda v: getattr(v, "name", v))
def test_one_group_msm_equals_one_window_a_group(curve, n, monkeypatch):
    """s = 8, C = 32: all W windows in one group (prefix_scan, col_prefix
    and extract_buckets once each) against one window a group (W times
    each): the same decoded window sums, and the MSM EXACT."""
    one = static_config(1, curve)                 # s = 8, C = 32, T = 16
    W = one.num_windows
    xs, ys, hw, base = preprocess.gen_planar_inputs(curve, n, seed=26,
                                                    k_base=7)
    hw = np.concatenate([hw, np.zeros((2, n), hw.dtype)])
    want = preprocess.expected_msm(base, hw[:-2], curve)
    calls = spy_calls(monkeypatch, ("prefix_scan", "col_prefix",
                                    "extract_buckets"))
    got = {}
    for Wg in (W, 1):
        cfg = dataclasses.replace(one, subtask_group=Wg)
        assert (cfg.num_groups, cfg.padded_windows) == (W // Wg, W)
        calls.update(dict.fromkeys(calls, 0))
        pipe = pipeline.MSMPipeline(cfg, "cpu")
        got[Wg] = pipe.window_sums(xs, ys, hw)
        assert calls == dict.fromkeys(calls, W // Wg)
        assert ref.jac_eq(curve, pipe.horner(got[Wg]), want)
    assert len(got[W]) == W
    for a, b in zip(got[W], got[1], strict=True):
        assert ref.jac_eq(curve, a, b)


class StubMesh:
    """What `sharded_msm` and `make_sharded_windows_fn` read of a mesh
    before they touch a process group."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, dim):
        return 0


@pytest.mark.parametrize("w", (1, 2, 4))
@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12),
                         ids=lambda c: c.name)
def test_sharded_config_fits_the_window_shards(curve, w):
    n = 1 << 20
    mesh = StubMesh(x=2, w=w) if w > 1 else StubMesh(x=2)
    cfg = sharded.sharded_config(n, w, curve)
    assert cfg.num_groups % w == 0
    assert cfg.subtask_group == 16 // w and cfg.padded_windows == 16
    assert dataclasses.replace(cfg, subtask_group=16) == static_config(
        n, curve)
    sharded.make_sharded_windows_fn(cfg, mesh)        # does not raise
    if w > 1:
        # an explicit config is refused as before
        with pytest.raises(ValueError, match="divide"):
            sharded.make_sharded_windows_fn(static_config(n, curve), mesh)


def test_sharded_config_keeps_a_schedule_the_shards_divide():
    """s = 13 at 2^16: 20 windows in 5 groups of 4; w = 5 divides them,
    w = 2 splits the windows into 2 groups of 10."""
    n = 1 << 16
    assert sharded.sharded_config(n, 5) == static_config(n)
    cfg = sharded.sharded_config(n, 2)
    assert (cfg.subtask_group, cfg.num_groups, cfg.padded_windows) == (
        10, 2, 20)


def test_sharded_msm_without_config_takes_the_sharded_config(monkeypatch):
    """`sharded_msm(config=None)` on a (x = 2, w = 2) mesh at 2^20 builds
    its pipeline from `sharded_config`, where the static schedule's one
    group would be refused; the pipeline's `msm` is not run."""
    seen = []

    class Pipe:
        def msm(self, points, scalars):
            return ref.INF

    def get(config, mesh, device):
        sharded.make_sharded_windows_fn(config, mesh)
        seen.append(config)
        return Pipe()
    monkeypatch.setattr(sharded, "get_sharded_pipeline", get)
    n = 1 << 20
    pts, scalars = [(1, 2)] * n, [3] * n
    mesh = StubMesh(x=2, w=2)
    assert sharded.sharded_msm(pts, scalars, mesh, curve=BLS12_377_S12,
                               device="cpu") == ref.INF
    assert seen == [sharded.sharded_config(n, 2, BLS12_377_S12)]
    with pytest.raises(ValueError, match="divide"):
        sharded.sharded_msm(pts, scalars, mesh,
                            config=static_config(n, BLS12_377_S12),
                            device="cpu")

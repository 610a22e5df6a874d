"""The port's multi-device MSM (`tpu_msm_torch.parallel.sharded`) in gloo
worlds of several processes on the CPU, one rank a process.

The mesh cases of MULTICHIP_r05.json, x = 8, x = 4, x = 2 and
(x = 2, w = 4), on TINY62 with tests/test_sharded.py's 2-D config, and
one BN254_S12 case at x = 2 and one with glv=True: `sharded_msm` on
every rank EXACT against the JAX package's `msm_pippenger_signed` on
the JAX package's points and scalars (the ranks make theirs with the
port's copy of the generator, which the test holds equal). One
(x = 2, w = 2) TINY62 case whose decoded window sums, on every rank, equal JAX
`ShardedMSMPipeline.window_sums` on a 4-device virtual mesh run in this
process, with the persistent compilation cache off (as in
tests/test_sharded.py). The ranks run `tests/_torch_sharded_ranks.py`,
which imports no `jax`; each case has a deadline, and a rank that fails
or hangs fails its test."""

import concurrent.futures

import jax
import numpy as np
import pytest

import _torch_sharded_ranks as ranks
from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.parallel.sharded import ShardedMSMPipeline
from tpu_msm.reference import curve as jref
from tpu_msm_torch.constants import CURVES
from tpu_msm_torch.reference import curve as ref

# A case's ranks must all have finished by then.
DEADLINE_S = 120

TINY = dict(window_size=8, columns=16, pbpr_threads=8, subtask_group=1)
BN = dict(window_size=8, columns=32, pbpr_threads=16, subtask_group=8)


@pytest.fixture(autouse=True, scope="module")
def _no_compilation_cache():
    """The sharded CPU executables do not survive XLA's serialization
    round-trip in this jaxlib: keep them out of the persistent cache, as
    tests/test_sharded.py does."""
    from jax._src import compilation_cache as cc
    cc.reset_cache()
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()


def jax_inputs(name, n, seed):
    """The JAX package's points and scalars of the case, which must be
    the ones the ranks make with the port's copy of the generator."""
    pts, scalars = jref.gen_points_scalars(jc.CURVES[name], n, seed=seed)
    assert (pts, scalars) == ref.gen_points_scalars(CURVES[name], n,
                                                    seed=seed)
    return pts, scalars


def oracle(name, n, seed, window=8):
    """The JAX package's signed-window Pippenger on the case's inputs."""
    return jref.msm_pippenger_signed(jc.CURVES[name],
                                     *jax_inputs(name, n, seed),
                                     window=window)


@pytest.mark.parametrize("mesh,curve,config,n,seed", [
    ({"x": 8}, "tiny62", TINY, 80, 64),
    ({"x": 4}, "tiny62", TINY, 80, 64),
    ({"x": 2}, "tiny62", TINY, 80, 64),
    ({"x": 2, "w": 4}, "tiny62", TINY, 80, 64),
    ({"x": 2}, "bn254_s12", BN, 96, 63),
    ({"x": 2}, "bn254_s12", {**BN, "glv": True}, 64, 66),
], ids=["x8", "x4", "x2", "x2-w4", "bn254-x2", "bn254-glv-x2"])
def test_sharded_msm_ranks_match_oracle(tmp_path, mesh, curve, config, n,
                                        seed):
    case = dict(mesh=mesh, curve=curve, config=config, n=n, seed=seed)
    results = ranks.run_ranks(case, tmp_path, DEADLINE_S)
    want = oracle(curve, n, seed)
    for r, res in enumerate(results):
        assert jref.jac_eq(jc.CURVES[curve], tuple(res["msm"]), want), \
            f"rank {r}"


def test_sharded_window_sums_match_jax_2d_mesh(tmp_path):
    """(x = 2, w = 2): every rank's decoded window sums equal the JAX
    sharded pipeline's on the same inputs, window by window."""
    n, seed = 80, 67
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                              ("x", "w"))
    case = dict(mesh=dict(jmesh.shape), curve="tiny62", config=TINY, n=n,
                seed=seed, windows=True)
    assert case["mesh"] == {"x": 2, "w": 2}
    # the ranks run while this process compiles the JAX program
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        running = pool.submit(ranks.run_ranks, case, tmp_path, DEADLINE_S)
        jpipe = ShardedMSMPipeline(JaxConfig(curve=jc.TINY62, backend="xla",
                                             **TINY), jmesh)
        pts, scalars = jax_inputs("tiny62", n, seed)
        want = jpipe.window_sums(*jpipe.pack(pts, scalars))
        results = running.result()
    for r, res in enumerate(results):
        got = [tuple(w) for w in res["windows"]]
        assert len(got) == len(want) == 8
        for w, (a, b) in enumerate(zip(got, want)):
            assert jref.jac_eq(jc.TINY62, a, b), f"rank {r} window {w}"
    acc = jref.INF                      # Horner by 2^8, as JAX msm does
    for gw in reversed(want):
        for _ in range(TINY["window_size"]):
            acc = jref.dbl(jc.TINY62, acc)
        acc = jref.add(jc.TINY62, acc, gw)
    assert jref.jac_eq(jc.TINY62, acc, oracle("tiny62", n, seed))

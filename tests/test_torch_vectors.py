"""The port's vector files (`tpu_msm_torch/utils/preprocess.py`:
`vector_path`, `save_vectors`, `load_or_gen_vectors`) against the JAX
package's: either package reads the files the other writes."""

import numpy as np
import pytest

from tpu_msm.constants import BN254_S12 as JBN254_S12
from tpu_msm.utils import preprocess as jpre
from tpu_msm_torch.constants import BLS12_377_S12, BN254_S12
from tpu_msm_torch.utils import preprocess as pre


@pytest.fixture
def vector_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(pre, "VECTOR_DIR", str(tmp_path))
    monkeypatch.setattr(jpre, "VECTOR_DIR", str(tmp_path))
    return tmp_path


def test_same_file_names(vector_dir):
    assert pre.vector_path(BN254_S12, 32, 5) == \
        jpre.vector_path(JBN254_S12, 32, 5) == \
        str(vector_dir / "bn254_s12_32x5.npz")


def test_jax_writes_port_reads(vector_dir):
    xs, ys, hw, base = jpre.load_or_gen_vectors(JBN254_S12, 48, seed=3,
                                                k_base=4)
    assert (vector_dir / "bn254_s12_48x3.npz").exists()
    pxs, pys, phw, pbase = pre.load_or_gen_vectors(BN254_S12, 48, seed=3,
                                                   k_base=4)
    for a, b in ((xs, pxs), (ys, pys), (hw, phw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert pbase == base


def test_port_writes_jax_reads(vector_dir):
    xs, ys, hw, base = pre.load_or_gen_vectors(BN254_S12, 40, seed=4,
                                               k_base=4)
    assert (vector_dir / "bn254_s12_40x4.npz").exists()
    jxs, jys, jhw, jbase = jpre.load_or_gen_vectors(JBN254_S12, 40, seed=4,
                                                    k_base=4)
    for a, b in ((xs, jxs), (ys, jys), (hw, jhw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert jbase == base
    # a fresh generation equals what was written
    gxs, gys, ghw, _ = pre.gen_planar_inputs(BN254_S12, 40, 4, 4)
    assert np.array_equal(gxs, xs) and np.array_equal(ghw, hw)


@pytest.mark.parametrize("curve", (BN254_S12, BLS12_377_S12),
                         ids=lambda c: c.name)
def test_checked_mode_rejects_a_flipped_limb(vector_dir, curve):
    xs, ys, hw, _ = pre.load_or_gen_vectors(curve, 32, seed=5, k_base=4)
    pre.load_or_gen_vectors(curve, 32, seed=5, k_base=4)   # valid file
    ys2 = ys.copy()
    ys2[0, 7] ^= 1
    pre.save_vectors(pre.vector_path(curve, 32, 5), xs, ys2, hw)
    with pytest.raises(ValueError, match="point 7: not on curve"):
        pre.load_or_gen_vectors(curve, 32, seed=5, k_base=4)
    got = pre.load_or_gen_vectors(curve, 32, seed=5, k_base=4, check=False)
    assert np.array_equal(got[1], ys2)

"""`kernels.smvp_stitch_plain` against the JAX `bucket_accumulate` at
BN254_S12, bit for bit, and the phases of csrc/smvp_stitch.cu replayed
on the same inputs (tests/test_torch_smvp_stitch.py holds TINY62 and the
rest): 7 columns of one row (odd C, n below the columns) with random
digits, every key equal, every column its own run and every digit 0;
4 columns of 8 rows with random digits and with every column its own
run. One jit of the JAX function a shape, about a minute of XLA's
compile on a cold cache each, so this file runs on a test worker of its
own."""

import pytest
import torch

import _torch_stitch as st

torch.set_num_threads(1)

CASES = ([(7, 1, 4, k) for k in st.KINDS]
         + [(4, 8, 4, "random"), (4, 8, 4, "own")])


@pytest.mark.parametrize("C,R,s,kind", CASES,
                         ids=[f"C{C}-R{R}-{k}" for C, R, _, k in CASES])
def test_stitch_matches_jax_bn254(C, R, s, kind):
    st.check_against_jax("bn254_s12", C, R, s, kind)

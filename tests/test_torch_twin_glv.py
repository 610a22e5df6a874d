"""The port's XLA path under GLV at BN254_S12 against JAX
`_windows_device` with glv=True, bit for bit (so equal by decoded
value): `glv.apply_glv`'s doubled stream of 128 lanes, 43 windows in 3
groups. One jit of JAX's GLV program, two minutes or more of XLA's
compile on a cold cache, alone in this file so that it runs beside the
other compiles."""

import torch

import _torch_twin as tw
from tpu_msm_torch.cuzk.pipeline import _windows_device, tpu_variable_base_msm
from tpu_msm_torch.reference import curve as ref

# The tensors here are tiny: more intra-op threads only make parallel
# test workers fight for the cores, many times slower than one thread.
torch.set_num_threads(1)

NAME = "bn254_s12"


def test_windows_device_glv_matches_jax_bn254():
    cfg = tw.config(NAME, glv=True)
    assert (cfg.num_windows, cfg.num_groups) == (43, 3)
    pts, scalars, xs, ys, hw = tw.inputs(NAME)
    got = _windows_device(*tw.tensors(xs, ys, hw), cfg=cfg)
    assert got.shape[2] == cfg.padded_windows
    tw.check_windows(cfg.curve, got, tw.jax_windows(NAME, True, xs, ys, hw))
    msm = tpu_variable_base_msm(pts, scalars, config=cfg, device="cpu")
    assert ref.jac_eq(cfg.curve, msm, ref.msm_pippenger_signed(
        cfg.curve, pts, scalars, window=8))

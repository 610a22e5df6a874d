"""tpu_msm_torch: the PyTorch/CUDA port of tpu_msm for NVIDIA Hopper.

Variable-base multi-scalar multiplication over BN254 G1 and BLS12-377
G1 (the signed profiles BN254_S12, BN254_S13, BLS12_377_S12 and
BLS12_377_S13; `curve=` of `tpu_variable_base_msm`), the same
algorithm as `tpu_msm` (sorted prefix-scan bucket extraction and the
cuZK parallel bucket reduction) with hand-written CUDA kernels for
`sm_90a` in `csrc/`. Importing the package builds nothing; the kernels
are compiled at first use on a CUDA device (`_build.py`).

Entry points run on "cuda" unless the caller passes `device="cpu"`, which
runs the kernels' plain PyTorch versions.
"""

from .config import MSMConfig, default_config
from .constants import (BLS12_377_S12, BLS12_377_S13, BN254_S12, BN254_S13,
                        CurveParams)
from .cuzk.pipeline import MSMPipeline, get_pipeline, tpu_variable_base_msm
from .cuzk.kernels import batch_inverse, to_affine

__all__ = ["MSMConfig", "default_config", "BN254_S12", "BN254_S13",
           "BLS12_377_S12", "BLS12_377_S13", "CurveParams",
           "MSMPipeline", "get_pipeline", "tpu_variable_base_msm",
           "batch_inverse", "to_affine"]

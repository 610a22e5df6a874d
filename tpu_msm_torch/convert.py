"""Carry the JAX package's MSM parameters across to the port.

For an MSM the "parameters" are a pipeline configuration and the planar
input arrays. `from_jax` takes the field values of a
`tpu_msm.config.MSMConfig` as a plain dict (for example
`dataclasses.asdict(cfg)` or `vars(cfg)`) and the numpy planar arrays,
and returns the port's `MSMConfig` and device tensors. It imports
nothing of `tpu_msm`.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from .config import MSMConfig
from .constants import CURVES
from .cuzk.pipeline import resolve_device

# JAX trace-time choices with no counterpart in the port.
_JAX_ONLY = {"backend", "unroll", "dbl_mode", "group_loop"}
_FIELDS = ("window_size", "columns", "pbpr_threads", "subtask_group",
           "max_points_per_pass", "glv")


def _curve_name(curve) -> str:
    if isinstance(curve, str):
        return curve
    if isinstance(curve, Mapping):
        return curve["name"]
    return curve.name


def config_from_fields(fields: Mapping) -> MSMConfig:
    """Port MSMConfig from the field values of a JAX MSMConfig."""
    unknown = set(fields) - set(_FIELDS) - _JAX_ONLY - {"curve"}
    if unknown:
        raise ValueError(f"unknown MSMConfig fields: {sorted(unknown)}")
    name = _curve_name(fields.get("curve", "bn254_s12"))
    if name not in CURVES:
        raise ValueError(f"curve {name!r} is not in the port's profiles")
    kw = {k: fields[k] for k in _FIELDS if k in fields}
    return MSMConfig(curve=CURVES[name], **kw)


def from_jax(xs: np.ndarray, ys: np.ndarray, halfwords: np.ndarray,
             config_fields: Mapping, device="cuda"
             ) -> Tuple[MSMConfig, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(config, xs, ys, halfwords) for `MSMPipeline.window_sums`: the
    port's config and the planar arrays as int32 tensors on `device`."""
    dev = resolve_device(device)
    cfg = config_from_fields(config_fields)
    L = cfg.curve.num_limbs
    if xs.shape[0] != L or ys.shape != xs.shape:
        raise ValueError(f"expected (L={L}, n) coordinate arrays")
    if halfwords.shape[1] != xs.shape[1]:
        raise ValueError("halfwords and coordinates differ in n")
    to = lambda a: torch.as_tensor(np.asarray(a).astype(np.int32)).to(dev)
    return cfg, to(xs), to(ys), to(halfwords)

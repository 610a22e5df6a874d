"""MSM pipeline configuration and the static window schedule.

The port's own `MSMConfig`: the fields of `tpu_msm/config.py` that shape
the computation (curve, window size, columns, PBPR threads, window group,
points per pass, GLV, backend), with the same validation, derived
properties and default schedule, which a measured winner of
`utils/window.autotune` in the port's autotune cache overrides for its
(card, curve, n). The JAX package's other trace-time choices (unroll,
dbl_mode, group_loop) have no counterpart here.
"""

from __future__ import annotations

import dataclasses

from .constants import BN254_S12, CurveParams


@dataclasses.dataclass(frozen=True)
class MSMConfig:
    """Static parameters of one MSM pipeline.

    window_size (s): signed-window width; num_windows = ceil(scalar_bits/s)
        and 2^(s-1) buckets per window.
    columns (C): the sorted stream of each window is laid out as R rows x
        C columns, column-major; the scan runs one lane per column.
    pbpr_threads (T): bucket-reduction split into T slices per window.
    subtask_group (Wg): windows per scan launch.
    max_points_per_pass: larger inputs run as several device passes whose
        window sums add on the host.
    glv: split every scalar over the curve's cube-root-of-unity
        endomorphism (`glv.py`, `cuzk/glv.py`), so that the pipeline runs
        2n points through about half the windows. Off by default, as in
        the JAX package.
    backend: the device program (`MSMPipeline.windows_fn`). "auto" (the
        default) and "cuda" run the CUDA kernel path
        (`cuzk/pipeline_cuda.py`, the counterpart of the JAX package's
        Pallas path); "xla" runs the port of the JAX package's XLA path
        (`cuzk/pipeline._windows_device`: sort, segmented row walk,
        stitch, two-stage reduction), which the JAX package runs off a
        TPU. Under "xla" the same CUDA kernels run its stages 1 and 4
        and its stitch.
    """

    curve: CurveParams = BN254_S12
    window_size: int = 13
    columns: int = 256
    pbpr_threads: int = 128
    subtask_group: int = 4
    max_points_per_pass: int = 1 << 23
    glv: bool = False
    backend: str = "auto"

    def __post_init__(self):
        self.curve.require_signed("MSMConfig")
        if self.backend not in ("auto", "cuda", "xla"):
            raise ValueError("backend must be auto | cuda | xla")
        s = self.window_size
        if not (2 <= s <= 16):
            raise ValueError("window_size must be in [2, 16]")
        if self.columns & (self.columns - 1):
            raise ValueError("columns must be a power of two")
        if self.pbpr_threads & (self.pbpr_threads - 1):
            raise ValueError("pbpr_threads must be a power of two")
        if self.pbpr_threads > self.half_columns:
            raise ValueError("pbpr_threads must divide the bucket count")
        # top window must not overflow under signed-digit carry
        top_bits = self.effective_scalar_bits - s * (self.num_windows - 1)
        if top_bits >= s and not self.glv:
            # (the GLV window formula below keeps top_bits < s)
            raise ValueError("window_size incompatible with scalar width")

    @property
    def glv_params(self):
        """The derived GLV constants of this curve (`glv.derive`)."""
        from . import glv
        return glv.derive(self.curve)

    @property
    def effective_scalar_bits(self) -> int:
        """Bits the window decomposition must cover: the scalar modulus
        width, or under GLV the bound of the split magnitudes plus one
        headroom bit (|k_i| <= max_abs < 2^max_bits = 2^(eff-1), which the
        carry of the signed digits needs)."""
        if self.glv:
            return self.glv_params.max_bits + 1
        return self.curve.scalar_bits

    @property
    def num_windows(self) -> int:
        """ceil(scalar_bits / s). Under GLV: eff // s + 1, the same except
        where s divides eff; there the extra window takes the signed-digit
        carry out of a full top window (the magnitudes are bounded by
        2^(eff-1) only, not by a modulus with known top bits)."""
        if self.glv:
            return self.effective_scalar_bits // self.window_size + 1
        return -(-self.curve.scalar_bits // self.window_size)

    @property
    def half_columns(self) -> int:
        """Buckets per window: 2^(s-1)."""
        return 1 << (self.window_size - 1)

    @property
    def num_groups(self) -> int:
        return -(-self.num_windows // self.subtask_group)

    @property
    def padded_windows(self) -> int:
        return self.num_groups * self.subtask_group


def default_config(n: int, curve: CurveParams = BN254_S12) -> MSMConfig:
    """The autotuned config for (this CUDA card, curve, n) from the
    port's autotune cache (`utils/window.cached_config`), else the static
    schedule: with no card, no cache file or no entry."""
    from .utils.window import cached_config
    tuned = cached_config(n, curve)
    if tuned is not None:
        return tuned
    return static_config(n, curve)


def static_config(n: int, curve: CurveParams = BN254_S12) -> MSMConfig:
    """Static window/shape schedule by input size (the JAX package's
    schedule, `tpu_msm/config.py:174-194`; not yet retuned for the H100)."""
    if n < (1 << 10):
        return MSMConfig(curve=curve, window_size=8, columns=32,
                         pbpr_threads=16, subtask_group=8)
    if n < (1 << 14):
        return MSMConfig(curve=curve, window_size=10, columns=256,
                         pbpr_threads=64, subtask_group=8)
    if n < (1 << 18):
        return MSMConfig(curve=curve, window_size=13, columns=2048,
                         pbpr_threads=256, subtask_group=4)
    return MSMConfig(curve=curve, window_size=16, columns=8192,
                     pbpr_threads=512, subtask_group=1,
                     max_points_per_pass=1 << 22)

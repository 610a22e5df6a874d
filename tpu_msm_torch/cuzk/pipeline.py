"""End-to-end MSM: host pack, the device program, host decode and Horner.

The port of `tpu_msm/cuzk/pipeline.py` (`MSMPipeline`, `get_pipeline`,
`tpu_variable_base_msm`) with the same semantics: empty input raises,
inputs truncate to the shorter length, pad lanes carry the generator
with zero scalars, inputs above `max_points_per_pass` run as several
device passes whose window sums add on the host, and decode and Horner
run on the host.

The device program is picked by `MSMPipeline.windows_fn` from
`MSMConfig.backend`: "auto" and "cuda" run `pipeline_cuda.windows_device`
(the counterpart of the JAX package's Pallas path), "xla" runs
`_windows_device` below (the counterpart of its XLA path, which the JAX
package runs on every backend but the TPU).

Every entry point takes `device=` and defaults to "cuda". Without a GPU
that raises; nothing falls back to the CPU. `device="cpu"` runs the
kernels' plain versions (the tests use it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import MSMConfig, default_config
from ..constants import BN254_S12, CurveParams
from ..reference import curve as ref
from ..utils.limbs_conversion import (planar_signed_to_ints_modp,
                                      points_to_planar, scalars_to_planar)
from . import kernels, pbpr, smvp
from .pipeline_cuda import stage1, windows_device

JacInt = Tuple[int, int, int]

I32 = torch.int32


def _windows_device(xs: torch.Tensor, ys: torch.Tensor,
                    halfwords: torch.Tensor, cfg: MSMConfig,
                    w_shards: int = 1, w_index: int = 0) -> torch.Tensor:
    """The XLA path's device program (JAX `cuzk/pipeline.py`
    `_windows_device`): Montgomery encoding and the signed digits (the
    main path's `pipeline_cuda.stage1`: the points' (n, 2L) int16 row
    table and the (Wp, n) digits; under GLV the doubled stream's), then
    for each window group the sort, row walk and stitch of
    `smvp.bucket_accumulate`, then the two-stage bucket reduction
    `pbpr.bucket_reduce`. Takes the planar inputs of `windows_device` and
    returns the same (3, L, Wp) int32 window sums, so
    `MSMPipeline._decode_windows` reads both.

    w_shards > 1 keeps the shard's contiguous block of Wp / w_shards
    windows, w_index the shard's index (a plain slice of the digits),
    and returns (3, L, Wp / w_shards); w_shards must divide num_groups.

    On CUDA tensors it launches `encode_rows` and `decompose_digits`
    (under GLV `glv_apply` and `decompose_digits`), per window group
    `bucket_sort` (its launches inside one call), `smvp_rows` (the row
    walk) and `smvp_stitch` (the stitch across columns and the inject),
    then `pbpr_stage1` (stage 1, and stage 2 as one more launch),
    `padd_batch` (the halving tree and the last add) and `pdbl_batch`
    (log2 Bt doublings). At BN254_S12 2^16 (5 groups, T = 256) that is 5
    each of `bucket_sort`, `smvp_rows` and `smvp_stitch`, 2 of
    `pbpr_stage1`, 9 of `padd_batch` and 4 of `pdbl_batch`; at 2^20 (16
    groups, T = 512) 16 of each of the three, 10 of `padd_batch` and 6
    of `pdbl_batch`."""
    curve = cfg.curve
    L = curve.num_limbs
    Wg, G = cfg.subtask_group, cfg.num_groups
    B, Wp = cfg.half_columns, cfg.padded_windows
    if w_shards < 1 or G % w_shards:
        raise ValueError(f"w_shards={w_shards} must divide num_groups={G}")
    if not 0 <= w_index < w_shards:
        raise ValueError(f"w_index={w_index} is not in [0, {w_shards})")

    pts_rows, digits = stage1(xs, ys, halfwords, cfg)
    Wp, G = Wp // w_shards, G // w_shards
    digits = digits[w_index * Wp:(w_index + 1) * Wp]

    buckets = torch.empty((3, L, Wp, B), dtype=I32, device=xs.device)
    for g in range(G):
        sl = slice(g * Wg, (g + 1) * Wg)
        buckets[:, :, sl] = smvp.bucket_accumulate(None, None, digits[sl],
                                                   cfg, pts_rows)
    return pbpr.bucket_reduce(buckets, cfg)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises for CUDA when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class MSMPipeline:
    """An MSM pipeline for one MSMConfig on one device."""

    def __init__(self, config: MSMConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    def padded_size(self, n: int) -> int:
        c = self.config.columns
        return max(c, -(-n // c) * c)

    def pack(self, points: Sequence[Tuple[int, int]], scalars: Sequence[int]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Affine int points + int scalars -> padded planar host inputs.
        Pad lanes carry the curve generator with zero scalars, so every
        lane is a genuine curve point and the G(e) - G(s-1) cancellation
        of the bucket extraction holds."""
        cfg = self.config
        n = len(points)
        n_pad = self.padded_size(n)
        if n_pad > n:
            points = list(points) + [(cfg.curve.gen_x, cfg.curve.gen_y)] * (
                n_pad - n)
            scalars = list(scalars) + [0] * (n_pad - n)
        xs, ys = points_to_planar(points, cfg.curve)
        hw = scalars_to_planar(scalars, cfg.curve)
        # +2 pad halfwords so top-window extraction never reads off the end
        hw = np.concatenate([hw, np.zeros((2, n_pad), np.uint32)], axis=0)
        return xs.astype(np.int32), ys.astype(np.int32), hw.astype(np.int32)

    def _stage(self, arrays):
        """Start the host-to-device copies of one pass's (xs, ys,
        halfwords); returns the device tensors and the event that marks
        their arrival (None on the CPU). Limbs other than int16 or int32
        and halfwords other than uint16 or int32, the dtypes stage 1's
        kernels read, are converted to int32 first (on the host for host
        arrays), on either device."""
        wire = (kernels.LIMB_DTYPES, kernels.LIMB_DTYPES,
                kernels.HALFWORD_DTYPES)
        tensors = [torch.as_tensor(a) for a in arrays]
        tensors = [t if t.dtype in ok else t.to(torch.int32)
                   for t, ok in zip(tensors, wire, strict=True)]
        if self._copy_stream is None:
            return tuple(tensors), None
        with torch.cuda.stream(self._copy_stream):
            out = []
            for t in tensors:
                if t.device.type == "cpu":
                    t = t.contiguous().pin_memory()
                out.append(t.to(self.device, non_blocking=True))
            event = self._copy_stream.record_event()
        return tuple(out), event

    def _run(self, staged) -> torch.Tensor:
        tensors, event = staged
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in tensors:
                t.record_stream(cur)
        return self._device_program(*tensors)

    @staticmethod
    def windows_fn(config: MSMConfig):
        """The device program of `config.backend`: `windows_device` (the
        CUDA kernel path) for "auto" and "cuda", `_windows_device` (the
        XLA path) for "xla". Both take (xs, ys, halfwords, cfg=,
        w_shards=, w_index=) and return (3, L, Wp) window sums."""
        if config.backend == "xla":
            return _windows_device
        return windows_device

    def _device_program(self, xs, ys, halfwords) -> torch.Tensor:
        """Staged planar inputs -> (3, L, Wp) window sums."""
        return self.windows_fn(self.config)(xs, ys, halfwords,
                                            cfg=self.config)

    def window_sums(self, xs, ys, halfwords) -> List[JacInt]:
        """Run the device program on planar inputs (numpy arrays or
        tensors of any integer dtype: int16 or int32 limbs and uint16 or
        int32 halfwords are read as they are, others converted to int32
        while staged) and decode the per-window sums to Jacobian int
        tuples.

        Inputs above cfg.max_points_per_pass run as several passes; the
        next pass's inputs are copied on a side stream while the current
        pass runs, and results are read back after every pass has been
        queued."""
        n = xs.shape[-1]
        # GLV doubles the stream lanes of every input point
        chunk = self.config.max_points_per_pass // (
            2 if self.config.glv else 1)
        spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]

        def stage(span):
            lo, hi = span
            return self._stage([a[:, lo:hi] for a in (xs, ys, halfwords)])

        staged = stage(spans[0])
        parts = []
        for i in range(len(spans)):
            nxt = stage(spans[i + 1]) if i + 1 < len(spans) else None
            parts.append(self._run(staged))
            staged = nxt
        total = None
        for g in parts:
            part = self._decode_windows(g)
            total = part if total is None else [
                ref.add(self.config.curve, a, b) for a, b in zip(total, part)]
        return total

    def _decode_windows(self, g: torch.Tensor) -> List[JacInt]:
        """(3, L, Wp) signed lazy Montgomery limbs -> affine-as-Jacobian
        int tuples, one per window (infinity as ref.INF)."""
        cfg = self.config
        c = cfg.curve
        arr = g.cpu().numpy()
        gx = planar_signed_to_ints_modp(arr[0], c)
        gy = planar_signed_to_ints_modp(arr[1], c)
        gz = planar_signed_to_ints_modp(arr[2], c)
        out = []
        for x, y, z in zip(gx, gy, gz):
            if z == 0:
                out.append(ref.INF)
            else:
                zi = pow(z, -1, c.p)
                out.append(((x * zi) % c.p, (y * zi) % c.p, 1))
        return out[: cfg.num_windows]

    def horner(self, windows: Sequence[JacInt]) -> JacInt:
        """sum_w 2^(s*w) * G_w on the host."""
        cfg = self.config
        acc = ref.INF
        for gw in reversed(windows):
            for _ in range(cfg.window_size):
                acc = ref.dbl(cfg.curve, acc)
            acc = ref.add(cfg.curve, acc, gw)
        return acc

    def msm(self, points: Sequence[Tuple[int, int]],
            scalars: Sequence[int]) -> JacInt:
        xs, ys, hw = self.pack(points, scalars)
        return self.horner(self.window_sums(xs, ys, hw))


_PIPELINE_CACHE: Dict[Tuple[MSMConfig, str], MSMPipeline] = {}


def get_pipeline(config: MSMConfig, device="cuda") -> MSMPipeline:
    dev = resolve_device(device)
    key = (config, str(dev))
    pipe = _PIPELINE_CACHE.get(key)
    if pipe is None:
        pipe = _PIPELINE_CACHE[key] = MSMPipeline(config, dev)
    return pipe


def tpu_variable_base_msm(points: Sequence[Tuple[int, int]],
                          scalars: Sequence[int],
                          config: MSMConfig | None = None,
                          curve: CurveParams = BN254_S12,
                          device="cuda") -> JacInt:
    """Variable-base MSM sum_i scalars[i] * points[i]. Raises on empty
    input, truncates to min(len(points), len(scalars)), picks the window
    size from the static schedule. Returns a Jacobian (x, y, z) int tuple
    in standard form; z == 0 means the point at infinity."""
    if len(points) == 0 or len(scalars) == 0:
        raise ValueError("tpu_variable_base_msm: empty input")
    n = min(len(points), len(scalars))
    points, scalars = points[:n], scalars[:n]
    if config is None:
        config = default_config(n, curve)
    return get_pipeline(config, device).msm(points, scalars)

"""Multi-device MSM: the point stream sharded over a device mesh, one
process a rank.

The port of `tpu_msm/parallel/sharded.py` on `torch.distributed`. The
window sum G_w = sum_b (b+1) * S_{w,b} is linear in the point set, so
each rank runs the whole device program (`MSMPipeline.windows_fn`:
`windows_device`, or `_windows_device` under backend="xla") on its span
of the points, and only the per-window sums, (3, L, Wp) int32 (4,224 B
at BN254_S12 with 16 windows), cross between ranks: one all-gather and
a halving tree of complete adds (`kernels.padd_batch`), replicated on
every rank.

Mesh dims (a `torch.distributed.device_mesh.DeviceMesh` named "x", or
"x" and "w"): "x" shards the point stream; "w" shards the window groups,
each w-shard running stages 2 to 4 on its block of Wp / w windows
(`windows_fn(cfg)(..., w_shards, w_index)`), the blocks reassembled by an
all-gather over "w" in axis-index order.

Every rank calls the entry points with the same inputs, as under
`torchrun`. Under NCCL the exchange moves the CUDA tensors; under any
other backend (gloo) it moves host copies, and the tree runs on the
rank's own device. A failed gather raises; nothing falls back.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MSMConfig, default_config
from ..constants import CurveParams
from ..cuzk import kernels
from ..cuzk.pipeline import JacInt, MSMPipeline, resolve_device


def _reduce_gathered(g: torch.Tensor, curve: CurveParams,
                     ndev: int) -> torch.Tensor:
    """(3, L, ndev, Wp) gathered window sums -> (3, L, Wp) by a halving
    tree of complete adds, in the JAX function's order: each level adds
    the first half to the second, one `padd_batch` on (3, L, h, Wp)."""
    if ndev < 1 or ndev & (ndev - 1):
        raise ValueError(f"ndev={ndev}: the reduction tree needs a power "
                         "of two")
    if g.dim() != 4 or g.shape[2] != ndev:
        raise ValueError(f"expected (3, L, {ndev}, Wp) sums, got "
                         f"{tuple(g.shape)}")
    d = ndev
    while d > 1:
        h = d // 2
        g = kernels.padd_batch(g[:, :, :h], g[:, :, h:d], curve)
        d = h
    return g[:, :, 0]


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, dim: str
                ) -> List[torch.Tensor]:
    """`t` of every rank along mesh dim `dim`, in axis-index order, on
    t's device."""
    group = mesh.get_group(dim)
    if dist.get_group_rank(group, dist.get_rank()) != mesh.get_local_rank(
            dim):
        raise RuntimeError(f"mesh dim {dim!r}: group ranks are not in "
                           "axis-index order")
    on_device = dist.get_backend(group) == "nccl"
    src = t.contiguous() if on_device else t.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return parts if on_device else [p.to(t.device) for p in parts]


def _mesh_sizes(mesh: DeviceMesh) -> Tuple[int, int]:
    """(x, w) of a mesh named "x", or "x" and "w"; w = 1 without "w"."""
    names = mesh.mesh_dim_names
    if names is None or "x" not in names or set(names) - {"x", "w"} \
            or len(set(names)) != len(names):
        raise ValueError(f"mesh dims {names}: expected ('x',) or "
                         "('x', 'w')")
    size = lambda d: mesh.size(names.index(d)) if d in names else 1
    return size("x"), size("w")


def make_sharded_windows_fn(cfg: MSMConfig, mesh: DeviceMesh):
    """This rank's windows function on `mesh`: (L, n/x) / (H, n/x) planar
    inputs of the rank's point span, on its device -> the (3, L, Wp)
    window sums of the whole MSM, the same on every rank."""
    ndev, wdev = _mesh_sizes(mesh)
    if cfg.num_groups % wdev:
        raise ValueError("mesh dim 'w' must divide num_groups "
                         f"({cfg.num_groups} groups, {wdev} shards)")
    if ndev & (ndev - 1):
        raise ValueError(f"mesh dim 'x' of {ndev}: the reduction tree "
                         "needs a power of two")
    w_index = mesh.get_local_rank("w") if wdev > 1 else 0
    windows_fn = MSMPipeline.windows_fn(cfg)

    def windows(xs, ys, halfwords):
        g = windows_fn(xs, ys, halfwords, cfg=cfg, w_shards=wdev,
                       w_index=w_index)
        return exchange(g, mesh, cfg.curve)

    return windows


def exchange(g: torch.Tensor, mesh: DeviceMesh,
             curve: CurveParams) -> torch.Tensor:
    """This rank's (3, L, Wp / w) window sums -> the (3, L, Wp) window
    sums of the whole MSM: the w-shards' blocks gathered over "w" in
    axis-index order, the ranks' sums gathered over "x" and reduced by
    the tree. Every rank of `mesh` calls it."""
    ndev, wdev = _mesh_sizes(mesh)
    if wdev > 1:
        # shard i owns windows [i Wp_l, (i + 1) Wp_l)
        g = torch.cat(_all_gather(g, mesh, "w"), dim=2)
    gathered = torch.stack(_all_gather(g, mesh, "x"), dim=2)
    return _reduce_gathered(gathered, curve, ndev)


class ShardedMSMPipeline(MSMPipeline):
    """MSMPipeline over a device mesh: the same host API, the rank's
    span of the points on its device, the window sums of the whole MSM
    on every rank. The padded size is a multiple of columns x x, so
    every span is a multiple of columns. No multi-pass chunking inside
    a rank."""

    def __init__(self, config: MSMConfig, mesh: DeviceMesh, device="cuda"):
        super().__init__(config, device)
        self.mesh = mesh
        self.ndev = _mesh_sizes(mesh)[0]
        self._fn = make_sharded_windows_fn(config, mesh)

    def padded_size(self, n: int) -> int:
        unit = self.config.columns * self.ndev
        return max(unit, -(-n // unit) * unit)

    def _device_program(self, xs, ys, halfwords) -> torch.Tensor:
        return self._fn(xs, ys, halfwords)

    def window_sums(self, xs, ys, halfwords) -> List[JacInt]:
        """The planar inputs of the whole MSM (numpy arrays or tensors,
        n a multiple of x) -> the decoded window sums; this rank runs
        points [i n/x, (i + 1) n/x), i its index on "x"."""
        n = xs.shape[-1]
        if n % self.ndev:
            raise ValueError(f"n={n} is not a multiple of x={self.ndev}")
        span = n // self.ndev
        lo = self.mesh.get_local_rank("x") * span
        staged = self._stage([a[:, lo:lo + span] for a in (xs, ys,
                                                           halfwords)])
        return self._decode_windows(self._run(staged))


def get_sharded_pipeline(config: MSMConfig, mesh: DeviceMesh,
                         device="cuda") -> ShardedMSMPipeline:
    """The pipeline of (config, mesh, device). Building one is cheap
    (nothing is compiled), so nothing is cached: a mesh built anew, on
    process groups made anew, never meets a pipeline of an old one."""
    return ShardedMSMPipeline(config, mesh, resolve_device(device))


def sharded_msm(points: Sequence[Tuple[int, int]], scalars: Sequence[int],
                mesh: DeviceMesh, config: MSMConfig | None = None,
                curve: CurveParams | None = None, device="cuda") -> JacInt:
    """Multi-device variable-base MSM, the host API of
    `tpu_variable_base_msm`: raises on empty input, truncates to the
    shorter length, picks the schedule from the total n. Every rank of
    `mesh` calls it with the same inputs and gets the same result."""
    if len(points) == 0 or len(scalars) == 0:
        raise ValueError("sharded_msm: empty input")
    n = min(len(points), len(scalars))
    points, scalars = points[:n], scalars[:n]
    if config is None:
        config = default_config(n, curve) if curve else default_config(n)
    return get_sharded_pipeline(config, mesh, device).msm(points, scalars)

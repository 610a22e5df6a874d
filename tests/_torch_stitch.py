"""Shared pieces of the tests of the XLA path's stitch across columns
(tests/test_torch_smvp_stitch*.py): the cases, the stitch's inputs as
`smvp.bucket_accumulate` makes them, one jit of the JAX
`bucket_accumulate` a shape, `replay_levels`, the scan's levels carried
flag by flag, `kernel_replay`, the phases of csrc/smvp_stitch.cu on CPU
tensors, and `check_against_jax`, one case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_msm import constants as jc
from tpu_msm.config import MSMConfig as JaxConfig
from tpu_msm.cuzk import smvp as jsmvp
from tpu_msm_torch import constants as tc
from tpu_msm_torch.config import MSMConfig
from tpu_msm_torch.cuzk import decompose, kernels
from tpu_msm_torch.reference import curve as ref
from tpu_msm_torch.utils.limbs_conversion import points_to_planar

WG = 2
KINDS = ("random", "equal", "own", "zero")


def fields(C: int, R: int, s: int) -> dict:
    """An MSMConfig's fields for C columns of R rows: C = min(columns, n)
    is a power of two where R > 1, else n itself (columns the next power
    of two)."""
    return dict(window_size=s, columns=C if R > 1 else 1 << (C - 1
                                                             ).bit_length(),
                pbpr_threads=2, subtask_group=WG)


@functools.lru_cache(maxsize=None)
def mont_points(name: str, n: int):
    """(xm, ym): n random points of the profile in Montgomery form."""
    curve = tc.CURVES[name]
    pts, _ = ref.gen_points_scalars(curve, n, seed=n)
    xs, ys = points_to_planar(pts, curve)
    return decompose.points_to_mont(torch.from_numpy(xs),
                                    torch.from_numpy(ys), curve)


def make_digits(kind: str, n: int, C: int, B: int, seed: int
                ) -> torch.Tensor:
    """(WG, n) int32 signed digits: "random" (in [-B, B], and a run of
    half the positions in window 0, of a quarter in window 1, so runs
    cross columns); "equal" (one key in each window, one run across all
    its columns); "own" (column c holds key c + 1 throughout, so every
    column is its own run; needs B >= C); "zero" (every digit 0)."""
    rng = np.random.default_rng(seed)
    R = n // C
    if kind == "random":
        d = rng.integers(-B, B + 1, (WG, n))
        d[0, n // 4:n // 4 + max(n // 2, 1)] = min(5, B)
        d[1, :max(n // 4, 1)] = -min(3, B)
    elif kind == "equal":
        d = np.stack([np.full(n, min(3, B)), np.full(n, -min(6, B))])
    elif kind == "own":
        assert B >= C
        keys = np.repeat(np.arange(1, C + 1), R)
        d = np.stack([rng.permutation(keys) for _ in range(WG)])
        d = np.where(rng.random((WG, n)) < 0.5, -d, d)
    else:
        d = np.zeros((WG, n))
    return torch.from_numpy(d.astype(np.int32))


def make_case(name: str, C: int, R: int, s: int, kind: str):
    """(port config, xm, ym, digits) of one case."""
    cfg = MSMConfig(curve=tc.CURVES[name], **fields(C, R, s))
    xm, ym = mont_points(name, C * R)
    digits = make_digits(kind, C * R, C, cfg.half_columns, seed=C + R + s)
    assert min(cfg.columns, C * R) == C
    return cfg, xm, ym, digits


def stitch_inputs(cfg, xm, ym, digits):
    """(bucket, trailing, skeys): what `smvp.bucket_accumulate` hands the
    stitch, the row walk's buckets and trailing sums and the sorted
    keys."""
    n = digits.shape[1]
    C, B = min(cfg.columns, n), cfg.half_columns
    pts_rows = torch.cat([xm, ym]).to(torch.int16).T.contiguous()
    pay, _ = kernels.bucket_sort(digits.to(torch.int16).contiguous(), B)
    skeys = torch.gather(digits.abs(), 1, (pay >> 1).long())
    bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, cfg.curve, C,
                                         B)
    return bucket, trailing, skeys


@functools.lru_cache(maxsize=None)
def _jax_fn(name: str, C: int, R: int, s: int):
    cfg = JaxConfig(curve=jc.CURVES[name], backend="xla", **fields(C, R, s))
    return jax.jit(lambda x, y, d: jsmvp.bucket_accumulate(x, y, d, cfg))


def jax_buckets(name: str, C: int, R: int, s: int, xm, ym, digits
                ) -> np.ndarray:
    """JAX `bucket_accumulate` under jit (one compile a shape) ->
    (3, L, WG, B) int32."""
    out = _jax_fn(name, C, R, s)(*(jnp.asarray(a.numpy())
                                   for a in (xm, ym, digits)))
    return np.stack([np.asarray(a) for a in out])


def replay_levels(scan: torch.Tensor, flags: torch.Tensor, curve, C: int):
    """The scan's levels on CPU tensors, in place, with the flags carried
    level by level as the recursion carries them, from the table the
    kernel reads (`kernels._stitch_schedule`): on every window at once,
    v[b] = padd(v[a], v[b]) and the flag of b becomes a's where b is not
    flagged; nothing where it is. Checks that no level reads a position
    it writes or writes one twice."""
    pairs, starts = kernels._stitch_schedule(C, torch.device("cpu"))
    for lv in range(len(starts) - 1):
        a, b = pairs[starts[lv]:starts[lv + 1], :2].long().T
        assert len(set(b.tolist())) == len(b)
        assert not set(a.tolist()) & set(b.tolist())
        wi, ii = (~flags[:, b]).nonzero(as_tuple=True)
        ai, bi = a[ii], b[ii]
        flags[wi, bi] = flags[wi, ai]
        scan[:, :, wi, bi] = kernels.padd_batch_plain(
            scan[:, :, wi, ai], scan[:, :, wi, bi], curve)


def kernel_replay(bucket, trailing, skeys, curve, C):
    """csrc/smvp_stitch.cu's phases on CPU tensors, from the table the
    kernel reads (`kernels._stitch_schedule`): the pass before the first
    barrier (every pair (a, b, lo, level) decided by the closed form,
    k[lo R - 1] == k[(b + 1) R - 1], and the levels with an add
    collected); where there are any, the scan from the trailing sums and
    those levels alone, each only at its adding pairs, v[b] = padd(v[a],
    v[b]); the inject (column c > 0 whose key before equals its first key
    and which holds more than one run or whose next column does not start
    with its last key: bucket[first] = padd(bucket[first], P), the slot
    below the spare), P the scan at c - 1, or the trailing sum at c - 1
    where no level added. Returns (a new bucket tensor, the levels run).
    Checks that no level reads a position it writes or writes one
    twice."""
    Wg, n = skeys.shape
    R = n // C
    B2 = bucket.shape[-1]
    k = skeys.reshape(Wg, C, R).long()
    keys = skeys.long()
    table, starts = kernels._stitch_schedule(C, torch.device("cpu"))
    table = table.long()
    adds = torch.zeros((Wg, len(table)), dtype=torch.bool)
    for p, (a, b, lo, lv) in enumerate(table.tolist()):
        adds[:, p] = keys[:, lo * R - 1] == keys[:, (b + 1) * R - 1]
    ran = sorted({lv for (_, _, _, lv), col in zip(table.tolist(), adds.T)
                  if bool(col.any())})
    scan = trailing.clone() if ran else trailing
    for lv in ran:
        s0, s1 = int(starts[lv]), int(starts[lv + 1])
        a, b = table[s0:s1, 0], table[s0:s1, 1]
        assert len(set(b.tolist())) == len(b)
        assert not set(a.tolist()) & set(b.tolist())
        wi, ii = adds[:, s0:s1].nonzero(as_tuple=True)
        ai, bi = a[ii], b[ii]
        scan[:, :, wi, bi] = kernels.padd_batch_plain(
            scan[:, :, wi, ai], scan[:, :, wi, bi], curve)
    first, last = k[..., 0], k[..., -1]
    before = torch.cat([torch.full((Wg, 1), -1), last[:, :-1]], dim=1)
    after = torch.cat([first[:, 1:], torch.full((Wg, 1), -1)], dim=1)
    col = torch.arange(C).expand(Wg, C)
    inject = ((col > 0) & (before == first)
              & ((first != last) | (col + 1 == C) | (after != last))
              & (first < B2 - 1))
    wi, ci = inject.nonzero(as_tuple=True)
    slots = first[wi, ci]
    assert len(set(zip(wi.tolist(), slots.tolist()))) == len(wi)
    out = bucket.clone()
    out[:, :, wi, slots] = kernels.padd_batch_plain(
        bucket[:, :, wi, slots], scan[:, :, wi, ci - 1], curve)
    return out, tuple(ran)


def check_against_jax(name, C, R, s, kind):
    """`smvp_stitch_plain` on the row walk's output, as
    `bucket_accumulate` calls it, against the JAX function's buckets;
    the kernel's replay against the plain version, the spare slot
    included."""
    cfg, xm, ym, digits = make_case(name, C, R, s, kind)
    B = cfg.half_columns
    bucket, trailing, skeys = stitch_inputs(cfg, xm, ym, digits)
    replay, ran = kernel_replay(bucket, trailing, skeys, cfg.curve, C)
    assert ran == kernels.stitch_levels_that_add(skeys, C)
    kernels.reset_launches()
    got = kernels.smvp_stitch(bucket, trailing, skeys, cfg.curve, C)
    assert got is bucket and set(kernels.LAUNCHES.values()) == {0}
    want = jax_buckets(name, C, R, s, xm, ym, digits)
    assert np.array_equal(want, got[..., 1:B + 1].numpy())
    assert torch.equal(replay, got)
    assert torch.equal(got[..., B + 1],
                       kernels.inf_stacked(cfg.curve, (WG,)))

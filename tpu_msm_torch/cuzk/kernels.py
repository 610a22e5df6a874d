"""The MSM kernels: one wrapper each.

Every wrapper has a plain PyTorch version built from `ops/rows.py`
(`<name>_plain`), the launch of its hand-written CUDA kernel from
`csrc/` through `_build.library()`, and a launch count in `LAUNCHES`.
A wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises. Each kernel source starts with
a note on the TPU kernel it replaces, what bounds it on the H100 and
what its design does about that.

  wrapper            replaces (tpu_msm/cuzk/kernels.py)   source
  encode_mont        _encode_kernel / encode_mont         csrc/encode_mont.cu
  decompose_digits   _digits_kernel / decompose_digits    csrc/decompose_digits.cu
  prefix_scan        _scan_kernel / prefix_scan           csrc/prefix_scan.cu
  col_prefix         _colprefix_kernel / col_prefix       csrc/col_prefix.cu
  padd_batch         _padd_kernel / padd_batch            csrc/padd_batch.cu
  pbpr_full          _pbpr_full_kernel / pbpr_full        csrc/pbpr_full.cu
  pdbl_batch         _pdbl_kernel / pdbl_batch            csrc/pdbl_batch.cu
  pbpr_stage1        _pbpr_kernel / pbpr_stage1           csrc/pbpr_stage1.cu
  globalize          _globalize_kernel / globalize        csrc/globalize.cu

`decompose_digits`, `prefix_scan`, `col_prefix` and `pbpr_full` are on
the main path (`pipeline_cuda.windows_device`), with `encode_rows`,
`bucket_sort` and `extract_buckets` below; `encode_mont` is left to
`cuzk/decompose.points_to_mont`, the counterpart of the JAX function;
`pbpr_stage1` and `pdbl_batch` serve the two-stage bucket reduction
(`cuzk/pbpr.py`), and `globalize` is the full-stream form of the G = T + S
step that the main path takes only at the bucket-region ends.

Three more kernels replace functions that the JAX package leaves to
XLA, no pallas_call:

  wrapper            replaces                              source
  glv_rows           tpu_msm/cuzk/glv.py apply_glv         csrc/glv_apply.cu
                     (the split and the doubled stream)
  to_affine          tpu_msm/ops/inverse.py to_affine      csrc/to_affine.cu
  batch_inverse      tpu_msm/ops/inverse.py batch_inverse  csrc/batch_inverse.cu

`glv_rows` serves every path under `glv=True` (`pipeline_cuda.stage1`):
the wire limbs encoded and the doubled stream written as the (2n, 2L)
row table in one launch (its launches count as "glv_apply");
`glv_apply`, the JAX function's planar form on Montgomery limbs
(`cuzk/glv.apply_glv`), is its plain counterpart for the tests, on CPU
tensors only; `to_affine` and `batch_inverse` are the public `tpu_msm_torch.to_affine`
and `tpu_msm_torch.batch_inverse`, both the product tree of
csrc/batch_inv.cuh, and their plain versions the same tree in
`ops/inverse.py`.

Three more replace what XLA compiles around the Pallas kernels of the
JAX package's device program (tpu_msm/cuzk/pipeline_pallas.py):

  wrapper            replaces (pipeline_pallas.py)         source
  encode_rows        :141-143, :258, the casts, encode     csrc/encode_mont.cu
                     and the (n, 2L) int16 row table
  bucket_sort        :208-226, lax.sort + _bucket_counts   csrc/bucket_sort.cu
  extract_buckets    :292-304, flat_gather, padd_batch,    csrc/extract_buckets.cu
                     where, psub_batch

`encode_rows` is stage 1's encode (`glv_rows` under GLV, below), and
`decompose_digits` takes XLA's cast and zero digit rows
(pipeline_pallas.py:174-176) into its kernel. `bucket_sort` and
`extract_buckets` are on the main path, stages 2 and 3, so `padd_batch` and
`psub_batch` are not: they serve the reduction path, the XLA twin and
the sharded halving tree. `bucket_sort` sorts by |d| alone, stably, the
sign in the payload; its plain version is torch's stable sort. The XLA
path (`cuzk/pipeline._windows_device`) sorts with it too.

One more replaces the device loop that XLA compiles for the JAX
package's XLA path:

  wrapper            replaces                              source
  smvp_rows          tpu_msm/cuzk/smvp.py:94-110, the      csrc/smvp_rows.cu
                     lax.fori_loop of bucket_accumulate

It walks the rows of `cuzk/smvp.bucket_accumulate`, a column on a lane
of prefix_scan's kind (csrc/scan_lane.cuh); its plain version is the
loop of torch ops on `ops/complete.pmadd` that the port ran before. One more takes the step
after it:

  wrapper            replaces                              source
  smvp_stitch        tpu_msm/cuzk/smvp.py:112-155, the     csrc/smvp_stitch.cu
                     associative_scan across columns and
                     the inject

It runs XLA's scan tree in place, level by level, on the shared add of
csrc/padd_lane.cuh in one cooperative launch; its plain version is the
recursion `associative_scan` on `padd_batch_plain`, which the port ran as
a `padd_batch` launch a level before.

`psub_batch` is `padd_batch` of `pneg_stacked(q)`; on a CUDA tensor the
padd kernel negates q itself as it loads it. `pneg_stacked` and
`inf_stacked` stay plain torch, as the JAX package keeps them in XLA.
Stacked points are (3, L, *batch) tensors: coordinate, limb, lanes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Tuple

import torch

from .. import _build
from ..constants import CurveParams, int_to_limbs
from ..glv import M_SHIFT, GLVParams
from ..ops import complete, lazy, limbs, rows
from ..ops.barrett import mul_wide
from ..ops.inverse import batch_inverse as batch_inverse_plain
from ..ops.inverse import to_affine_plain

I16 = torch.int16
I32 = torch.int32
I64 = torch.int64
# Element widths the dtype-templated kernels are instantiated for.
_BITS = {I16: 16, I32: 32}

# Profiles the CUDA library is instantiated for: (num_limbs, limb bits):
# BN254_S12, BN254_S13, BLS12_377_S12, BLS12_377_S13 and TINY62
# (csrc/field.cuh MSM_DISPATCH_PROFILE).
CUDA_PROFILES = {(22, 12), (21, 13), (32, 12), (30, 13), (6, 12)}

LAUNCHES = {name: 0 for name in ("encode_mont", "encode_rows",
                                 "decompose_digits",
                                 "prefix_scan", "col_prefix", "padd_batch",
                                 "pbpr_full", "pdbl_batch", "pbpr_stage1",
                                 "globalize", "glv_apply", "to_affine",
                                 "batch_inverse", "bucket_sort",
                                 "extract_buckets", "smvp_rows",
                                 "smvp_stitch")}
"""Kernel launches per wrapper, counted where the CUDA kernel launches."""

LAUNCHED = {}
"""The geometry that the last launch of `decompose_digits`,
`prefix_scan`, `col_prefix`, `padd_batch`, `pbpr_full`, `pdbl_batch`,
`pbpr_stage1`, `globalize`, `bucket_sort`, `extract_buckets`,
`smvp_rows` and `smvp_stitch` passed to its kernel, and the plan of the
last call of `to_affine` and `batch_inverse`, written where the kernels
launch; `smvp_stitch`'s also holds "ran_mask", where its kernel writes
the scan levels it ran."""


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors
    (kernel); raises for anything else or for a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "the CPU or all on one CUDA device")


def _profile(name: str, curve: CurveParams) -> Tuple[int, int]:
    curve.require_signed(name)
    prof = (curve.num_limbs, curve.log_limb_size)
    if prof not in CUDA_PROFILES:
        raise ValueError(f"{name}: no CUDA instantiation for profile "
                         f"{curve.name} (L={prof[0]}, w={prof[1]})")
    return prof


def _consts_host(curve: CurveParams) -> list:
    """Flat int32 constants in the layout of `Consts<L>` (csrc/field.cuh)."""
    L, w = curve.num_limbs, curve.log_limb_size
    b3 = 3 * curve.b_coeff
    limbs = lambda v, n=L: int_to_limbs(v, n, w)
    return ([curve.n0, b3] + limbs(curve.p, L + 1) + limbs(curve.r_mod_p)
            + limbs(curve.r2_mod_p) + limbs(curve.to_mont(b3))
            + limbs(2 * curve.p) + limbs(4 * curve.p) + limbs(6 * curve.p)
            + limbs(2 * b3 * curve.p))


@functools.lru_cache(maxsize=None)
def _consts(curve: CurveParams, device: torch.device) -> torch.Tensor:
    return torch.tensor(_consts_host(curve), dtype=I32, device=device)


def _wide_consts_host(curve: CurveParams) -> list:
    """The words of `WideConsts<L, W>` (csrc/mul_wide.cuh): p in the
    floor(L w / 32) whole words that the multiply reduces one at a time,
    n0 = -p^-1 mod 2^32, and R^2 mod p (R = 2^(L w)) in ceil(L w / 32)
    words. Where L w is a multiple of 32 (BLS12_377_S12) both counts are
    L w / 32 and the multiply has no last partial step. Refuses a profile
    whose p is too wide for the whole words."""
    bits = curve.num_limbs * curve.log_limb_size
    nf, n = bits // 32, -(-bits // 32)
    if curve.p >> (32 * nf):
        raise ValueError(f"{curve.name}: the word-wide multiply needs "
                         "p < 2^(32 floor(L*w/32))")
    n0 = -pow(curve.p, -1, 1 << 32) % (1 << 32)
    return _words(curve.p, nf) + [n0] + _words(curve.r2_mod_p, n)


def _words(v: int, k: int) -> list:
    """The k little-endian 32-bit words of a non-negative int."""
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(k)]


@functools.lru_cache(maxsize=None)
def _wide_consts(curve: CurveParams) -> ctypes.Array:
    """`_wide_consts_host` in host memory; the C entry copies it into the
    kernel's parameter struct. Cached, so its address stays valid."""
    words = _wide_consts_host(curve)
    return (ctypes.c_uint32 * len(words))(*words)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, rc: int) -> None:
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError_t {rc})")


def _need(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# helpers kept in plain torch (XLA helpers in the JAX package)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _one_limbs(curve: CurveParams, device: torch.device) -> torch.Tensor:
    """The L canonical limbs of 1 in Montgomery form (R mod p) on
    `device`, made once: a CUDA tensor made from host values waits for
    its stream."""
    return torch.tensor(int_to_limbs(curve.r_mod_p, curve.num_limbs,
                                     curve.log_limb_size),
                        dtype=I32, device=device)


def inf_stacked(curve: CurveParams, batch_shape, device="cpu") -> torch.Tensor:
    """(3, L, *batch) stacked infinity (0 : 1m : 0), canonical limbs."""
    L = curve.num_limbs
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.zeros((3, L) + tuple(batch_shape), dtype=I32, device=dev)
    out[1] = _one_limbs(curve, dev).reshape((L,) + (1,) * len(batch_shape))
    return out


def pneg_stacked(p: torch.Tensor, curve: CurveParams, k: int = 4
                 ) -> torch.Tensor:
    """y -> k*p - y on a stacked (3, L, ...) batch; keeps an int16 dtype
    (k*p limbs < 2^w and y limbs > -2^(w+1) stay inside 16 bits)."""
    L = p.shape[1]
    kp = torch.tensor(int_to_limbs(k * curve.p, L, curve.log_limb_size),
                      dtype=p.dtype, device=p.device
                      ).reshape((L,) + (1,) * (p.dim() - 2))
    return torch.stack([p[0], kp - p[1], p[2]])


def _unstack(p: torch.Tensor) -> rows.ProjRows:
    p = p.to(I32)
    return rows.ProjRows(p[0], p[1], p[2])


def _stack(p: rows.ProjRows) -> torch.Tensor:
    return torch.stack([p.x, p.y, p.z])


# ---------------------------------------------------------------------------
# 1. Montgomery encode
# ---------------------------------------------------------------------------


def encode_mont_plain(xs: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    return rows.to_mont_rows(xs, curve)


def encode_mont(xs: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """(L, n) int32 canonical standard-form limbs -> Montgomery form
    (canonical limbs, value < 2p)."""
    if not _on_cuda("encode_mont", xs):
        return encode_mont_plain(xs, curve)
    L, w = _profile("encode_mont", curve)
    _need("encode_mont", xs, I32, 2)
    out = torch.empty_like(xs)
    rc = _build.library().msm_encode_mont(
        L, w, xs.data_ptr(), out.data_ptr(), xs.shape[1],
        ctypes.addressof(_wide_consts(curve)), _stream(xs))
    _check("encode_mont", rc)
    return out


# The dtypes stage 1's kernels read as staged: limbs of the wire (int16
# or int32) and scalar halfwords (uint16 or int32). The kernels refuse
# others; the plain versions cast any integer dtype, and the pipelines
# convert any other to int32 while they stage it.
LIMB_DTYPES = (I16, I32)
HALFWORD_DTYPES = (torch.uint16, I32)


def _lanes(name: str, t: torch.Tensor, dtypes, rows: int | None = None
           ) -> int:
    """The row stride of a (rows, n) lane-major operand that a stage-1
    kernel reads in place: any dtype of `dtypes`, the lanes contiguous
    (a slice of the columns of a wider array is fine)."""
    if (t.dim() != 2 or t.dtype not in dtypes
            or (rows is not None and t.shape[0] != rows)
            or (t.shape[1] > 1 and t.stride(1) != 1)
            or (t.shape[0] > 1 and t.stride(0) < t.shape[1])):
        raise ValueError(f"{name}: expected a ({rows or 'H'}, n) tensor of "
                         f"{[str(d) for d in dtypes]} with contiguous lanes, "
                         f"got {t.dtype} {tuple(t.shape)} strides "
                         f"{t.stride()}")
    return max(t.stride(0), t.shape[1])


def row_table(xm: torch.Tensor, ym: torch.Tensor) -> torch.Tensor:
    """(L, n) Montgomery x and y limbs (canonical, < 2^w) -> the points'
    (n, 2L) int16 row table, x limbs then y limbs: the torch ops of the
    JAX package's pipeline_pallas.py:258, for the plain versions and the
    callers that start from Montgomery planes."""
    return torch.cat([xm, ym]).to(I16).T.contiguous()


def encode_rows_plain(xs: torch.Tensor, ys: torch.Tensor,
                      curve: CurveParams) -> torch.Tensor:
    return row_table(encode_mont_plain(xs.to(I32), curve),
                     encode_mont_plain(ys.to(I32), curve))


def encode_rows(xs: torch.Tensor, ys: torch.Tensor, curve: CurveParams
                ) -> torch.Tensor:
    """(L, n) canonical standard-form x and y limbs, int16 or int32 as
    staged -> the (n, 2L) int16 row table of their Montgomery forms:
    `encode_mont` of each, cast and laid out points-major, in one launch
    that reads the limbs in place (any row stride). On the card the limbs
    are `LIMB_DTYPES` only."""
    if not _on_cuda("encode_rows", xs, ys):
        return encode_rows_plain(xs, ys, curve)
    L, w = _profile("encode_rows", curve)
    ldx = _lanes("encode_rows", xs, LIMB_DTYPES, L)
    ldy = _lanes("encode_rows", ys, LIMB_DTYPES, L)
    n = xs.shape[1]
    if ys.dtype != xs.dtype or ys.shape[1] != n:
        raise ValueError(f"encode_rows: x {xs.dtype} {tuple(xs.shape)} and "
                         f"y {ys.dtype} {tuple(ys.shape)} differ")
    out = torch.empty((n, 2 * L), dtype=I16, device=xs.device)
    if n:
        rc = _build.library().msm_encode_rows(
            L, w, xs.data_ptr(), ys.data_ptr(), xs.element_size(), ldx, ldy,
            out.data_ptr(), n, ctypes.addressof(_wide_consts(curve)),
            _stream(xs))
        _check("encode_rows", rc)
    return out


# ---------------------------------------------------------------------------
# 2. Signed-digit decomposition
# ---------------------------------------------------------------------------


def decompose_digits_plain(halfwords: torch.Tensor, s: int, W: int,
                           Wp: int | None = None) -> torch.Tensor:
    halfwords = halfwords.to(I32)
    H = halfwords.shape[0]
    mask, full, half = (1 << s) - 1, 1 << s, 1 << (s - 1)
    out = torch.zeros((W if Wp is None else Wp,) + halfwords.shape[1:],
                      dtype=I16, device=halfwords.device)
    carry = None
    for w in range(W):
        bit = w * s
        i, off = bit >> 4, bit & 15
        val = halfwords[i] >> off if off else halfwords[i]
        if off and i + 1 < H:
            val = val | (halfwords[i + 1] << (16 - off))
        val = val & mask
        if carry is not None:
            val = val + carry
        ge = val >= half
        out[w] = (val - ge.to(I32) * full).to(I16)
        carry = ge.to(I32)
    return out


DIGITS_THREADS = 128
"""Threads a block of csrc/decompose_digits.cu (kThreads)."""
DIGITS_WORD_BYTES = (8, 4)
"""The words a thread of decompose_digits can read of each row, widest
first: P = word / element size scalars a thread. 16-byte words were
slower on the H100 at 2^20 and 2^22 (twice the registers a thread, fewer
threads resident)."""
DIGITS_MIN_THREADS = 1 << 17
"""The threads a launch should have to fill the card: the widest word
that leaves at least this many, else the narrowest."""


class DigitsGeometry(NamedTuple):
    points_per_thread: int
    head: int
    threads: int
    blocks: int
    rows: int
    vector_loads: bool
    vector_stores: bool


def digits_rows(H: int, s: int, W: int) -> int:
    """The halfword rows of H that W windows of s bits read: the top
    window's first and, off a halfword's start, the next (0 for no
    window)."""
    if W < 1:
        return 0
    top = (W - 1) * s
    return min(H, (top >> 4) + 1 + (top % 16 > 0))


def decompose_digits_geometry(n: int, ld: int, elem_bytes: int,
                              misalign: int, H: int, s: int, W: int,
                              points_per_thread: int | None = None
                              ) -> DigitsGeometry:
    """One decompose_digits launch on n scalars of (H, n) halfwords of
    `elem_bytes` each, row stride `ld` elements, the data pointer
    `misalign` bytes past a 16-byte boundary: a pure function, so the
    CPU tests can hold it (`digits_points` gives each thread's scalars).

    A thread takes P consecutive scalars, one word of each row: the
    wider of `DIGITS_WORD_BYTES` where it leaves DIGITS_MIN_THREADS
    threads, else the narrower (`points_per_thread` sets it, for the
    tests to cover both at any n). Where the row
    stride is a multiple of the word, every row starts on the same
    phase: thread 0 takes the `head` scalars before the first word
    boundary, and every later full thread loads whole words (none where
    n ends before the boundary). Stores are whole words of 2P bytes
    where head is 0 and n is a multiple of P. A thread that is not full,
    and every thread where a flag is off, goes element by element."""
    if elem_bytes not in (2, 4) or misalign % elem_bytes or n < 1:
        raise ValueError(f"decompose_digits_geometry: n={n}, "
                         f"elem_bytes={elem_bytes}, misalign={misalign}")
    widths = [b // elem_bytes for b in DIGITS_WORD_BYTES]
    P = points_per_thread or next(
        (p for p in widths if -(-n // p) >= DIGITS_MIN_THREADS), widths[-1])
    if P not in widths:
        raise ValueError(f"decompose_digits_geometry: {P} scalars a thread "
                         f"of {elem_bytes}-byte halfwords")
    word = P * elem_bytes
    head = (word - misalign % word) % word // elem_bytes
    loads = (ld * elem_bytes) % word == 0 and head < n
    head = head if loads else 0
    threads = (head > 0) + -(-(n - head) // P)
    return DigitsGeometry(P, head, threads, -(-threads // DIGITS_THREADS),
                          digits_rows(H, s, W), loads,
                          head == 0 and n % P == 0)


def digits_points(geo: DigitsGeometry, n: int, t: int) -> Tuple[int, int]:
    """[f0, f1): the scalars of thread t of a launch, as the kernel
    takes them (empty past n)."""
    first = int(geo.head > 0)
    if t < first:
        return 0, geo.head
    f0 = geo.head + (t - first) * geo.points_per_thread
    return min(f0, n), min(n, f0 + geo.points_per_thread)


@functools.lru_cache(maxsize=256)
def _digits_launch(n: int, ld: int, elem_bytes: int, misalign: int, H: int,
                   s: int, W: int) -> Tuple[dict, tuple]:
    """`decompose_digits_geometry` as the wrapper hands it on: the report
    for LAUNCHED and the kernel's geometry arguments, built once a
    shape."""
    geo = decompose_digits_geometry(n, ld, elem_bytes, misalign, H, s, W)
    return geo._asdict(), (geo.rows, geo.points_per_thread, geo.head,
                           geo.threads, int(geo.vector_loads),
                           int(geo.vector_stores))


def decompose_digits(halfwords: torch.Tensor, s: int, W: int,
                     Wp: int | None = None) -> torch.Tensor:
    """(H, n) 16-bit halfwords, uint16 or int32 as staged -> (Wp, n) int16
    signed digits in [-2^(s-1), 2^(s-1)), carry-chained across the W
    windows, rows W to Wp - 1 zero (Wp defaults to W). Reads the
    halfwords in place (any row stride); on the card they are
    `HALFWORD_DTYPES` only. `decompose_digits_geometry` picks the
    launch."""
    if Wp is not None and Wp < W:
        raise ValueError(f"decompose_digits: Wp={Wp} < W={W}")
    if not _on_cuda("decompose_digits", halfwords):
        return decompose_digits_plain(halfwords, s, W, Wp)
    ld = _lanes("decompose_digits", halfwords, HALFWORD_DTYPES)
    H, n = halfwords.shape
    if (W - 1) * s // 16 >= H:
        raise ValueError("decompose_digits: too few halfwords for W windows")
    Wp = W if Wp is None else Wp
    out = torch.empty((Wp, n), dtype=I16, device=halfwords.device)
    if n:
        eb, ptr = halfwords.element_size(), halfwords.data_ptr()
        launched, geo = _digits_launch(n, ld, eb, ptr % 16, H, s, W)
        rc = _build.library().msm_decompose_digits(
            ptr, eb, ld, out.data_ptr(), H, n, s, W, Wp, *geo,
            _stream(halfwords))
        _check("decompose_digits", rc)
        LAUNCHED["decompose_digits"] = launched
    return out


# ---------------------------------------------------------------------------
# 3. Prefix scan over the sorted point stream
# ---------------------------------------------------------------------------


def prefix_scan_plain(pts_rows: torch.Tensor, pay: torch.Tensor,
                      curve: CurveParams, C: int) -> torch.Tensor:
    L = curve.num_limbs
    Wg, n = pay.shape
    R = n // C
    F = Wg * C
    out = torch.empty((3, L, R, F), dtype=I16, device=pay.device)
    col0 = torch.arange(C, device=pay.device) * R
    acc = rows.proj_infinity_rows(
        curve, torch.zeros((L, F), dtype=I32, device=pay.device))
    for r in range(R):
        v = pay[:, col0 + r].reshape(F)                       # lane order f
        row = pts_rows[(v >> 1).long()].to(I32).T             # (2L, F)
        x, y = row[:L], row[L:]
        y = rows.select_rows((v & 1) != 0, rows.neg_rows(y, curve, 2), y)
        acc = rows.pmadd_rows(acc, x, y, curve)
        out[:, :, r] = _stack(acc).to(I16)
    return out


SCAN_THREADS = 128
"""Threads a block of the scan kernel (csrc/scan_lane.cuh kThreads)."""
SCAN_THREADS_PER_LANE = (2, 6)
"""The values of G the scan kernel is built for."""


class ScanSmem(NamedTuple):
    piece_bytes: int
    shared_bytes: int


def prefix_scan_smem(num_limbs: int, threads_per_lane: int) -> ScanSmem:
    """The row piece and the dynamic shared bytes of a scan block: a pure
    function, so the CPU tests can hold it; the launch refuses a count
    other than its kernel's own (csrc/scan_lane.cuh `scan_smem_bytes`).

    A row of the table is 2 L int16, 4 L bytes, copied by cp.async in
    8-byte pieces where L is even and in 4-byte pieces where it is odd
    (BN254_S13's L = 21); the table must be aligned to the piece. A block
    of SCAN_THREADS // 32 warps holds 32 // G lanes a warp, each with a
    double buffer of rows and of payloads and its state, 19 segments of
    L | 1 int32 words (an odd count, csrc/scan_lane.cuh LaneMem) padded
    to an odd count."""
    L, G = num_limbs, threads_per_lane
    if L < 1 or G not in SCAN_THREADS_PER_LANE:
        raise ValueError(f"prefix_scan_smem: no block for L={L}, G={G}")
    lanes = (SCAN_THREADS // 32) * (32 // G)
    shared = lanes * (2 * 4 * L + 2 * 4 + 4 * (19 * (L | 1) | 1))
    return ScanSmem(8 if L % 2 == 0 else 4, shared)


SCAN_G2_MAX_LIMBS = 22
"""The widest limb count at which `prefix_scan_geometry` may pick G = 2."""


def prefix_scan_geometry(lanes: int, sms: int, threads_per_lane=None,
                         num_limbs: int = 22) -> Tuple[int, int, int]:
    """(G, blocks, lanes a block) of one scan launch over `lanes` lanes of
    `num_limbs` limbs on a card of `sms` SMs: a pure function, so the CPU
    tests can hold it.

    G threads of one warp share a lane (32 // G lanes a warp; with G = 6
    the last two threads of a warp idle), so a block of four warps holds
    64 lanes with G = 2 and 20 with G = 6. A step is six word-wide
    multiplies deep at G = 2 and two at G = 6. On the H100 the time of a
    launch goes up in steps with the blocks an SM gets, each block one
    more warp on each of its four schedulers (PERF.md, `[scan-lanes]`):
    by the whole of G = 2's time for each of its blocks, by about a
    fifth to a third of that for each of G = 6's. The rule: G = 6; but
    G = 2 where its blocks come one to an SM while G = 6 would need four
    to an SM (from 3 * sms * 20 + 1 to sms * 64 lanes: 7,921 to 8,448 on
    132 SMs, the default schedule's 8,192 among them), at L <= 22. There,
    on an NVIDIA H100 80GB HBM3 at 700 W, G = 2 took 0.90 ms against 0.97
    at BN254_S12 (8,192 lanes, R = 128) and 0.236 against 0.261 at
    BN254_S13 (R = 32); at BLS12_377_S12 G = 6 was 3 % faster (1.49
    against 1.53 ms) and at BLS12_377_S13 level. `threads_per_lane`
    names G outright: for a measurement of one G against the other, not
    for the MSM."""
    if lanes < 1 or sms < 1 or num_limbs < 1:
        raise ValueError("prefix_scan_geometry: lanes, sms and num_limbs "
                         "must be >= 1")
    per_block = lambda G: (SCAN_THREADS // 32) * (32 // G)
    blocks = lambda G: -(-lanes // per_block(G))
    if threads_per_lane is None:
        G = (2 if num_limbs <= SCAN_G2_MAX_LIMBS and blocks(2) <= sms
             and blocks(6) > 3 * sms else 6)
    elif threads_per_lane in SCAN_THREADS_PER_LANE:
        G = threads_per_lane
    else:
        raise ValueError("prefix_scan: threads_per_lane must be one of "
                         f"{SCAN_THREADS_PER_LANE}")
    return G, blocks(G), per_block(G)


def prefix_scan(pts_rows: torch.Tensor, pay: torch.Tensor,
                curve: CurveParams, C: int, *, _threads_per_lane=None
                ) -> torch.Tensor:
    """Inclusive per-lane running sums of the sorted, sign-folded stream.

    pts_rows: (n, 2L) int16 points-major table, row i = Montgomery
        (x limbs, y limbs) of point i.
    pay: (Wg, n) int32 sorted payload idx << 1 | sign of each window.
    Lane f = wl * C + c walks sorted positions c*R .. c*R + R-1 of
    window wl (R = n / C). Returns T (3, L, R, Wg*C) int16.
    `prefix_scan_geometry` picks the threads per lane of the launch;
    `_threads_per_lane` overrides it, for a measurement only."""
    if _threads_per_lane not in (None,) + SCAN_THREADS_PER_LANE:
        raise ValueError("prefix_scan: the kernel is built for "
                         f"{SCAN_THREADS_PER_LANE} threads per lane")
    if curve.log_limb_size > 13:
        raise ValueError("prefix_scan: int16 output needs w <= 13")
    if pay.shape[1] % C:
        raise ValueError("prefix_scan: n must be a multiple of C")
    if not _on_cuda("prefix_scan", pts_rows, pay):
        return prefix_scan_plain(pts_rows, pay, curve, C)
    L, w = _profile("prefix_scan", curve)
    _need("prefix_scan", pts_rows, I16, 2)
    _need("prefix_scan", pay, I32, 2)
    Wg, n = pay.shape
    R = n // C
    sms = torch.cuda.get_device_properties(pay.device).multi_processor_count
    G, _, _ = prefix_scan_geometry(Wg * C, sms, _threads_per_lane, L)
    smem = prefix_scan_smem(L, G)
    if pts_rows.data_ptr() % smem.piece_bytes:
        raise ValueError(f"prefix_scan: the row table must be "
                         f"{smem.piece_bytes}-byte aligned")
    out = torch.empty((3, L, R, Wg * C), dtype=I16, device=pay.device)
    rc = _build.library().msm_prefix_scan(
        L, w, pts_rows.data_ptr(), pay.data_ptr(), out.data_ptr(), Wg, C, R,
        n, G, smem.shared_bytes,
        _consts(curve, pay.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(pay))
    _check("prefix_scan", rc)
    LAUNCHED["prefix_scan"] = dict(threads_per_lane=G,
                                   shared_bytes=smem.shared_bytes)
    return out


# ---------------------------------------------------------------------------
# 4. Exclusive column prefix
# ---------------------------------------------------------------------------


def _levels(C: int) -> int:
    return max(C.bit_length() - 1, 1)


def col_prefix_plain(coltot: torch.Tensor, curve: CurveParams
                     ) -> torch.Tensor:
    _, L, Wg, C = coltot.shape
    inf = inf_stacked(curve, (Wg, C), coltot.device)
    v = torch.cat([inf[..., :1], coltot[..., :-1].to(I32)], dim=-1)
    for lv in range(_levels(C)):
        k = 1 << lv
        sh = torch.cat([inf[..., :k], v[..., :C - k]], dim=-1)[..., :C]
        v = _stack(rows.padd_rows(_unstack(v), _unstack(sh), curve))
    return v.to(I16)


COL_PREFIX_THREADS_PER_LANE = 6
"""Threads of a warp that share a column's add in the col_prefix kernel
(csrc/padd_lane.cuh kAddG)."""


class ColPrefixGeometry(NamedTuple):
    threads_per_lane: int
    columns_per_warp: int
    warps: int
    lanes_per_block: int
    blocks: int
    columns_per_lane: int
    threads: int
    shared_bytes: int


def col_prefix_geometry(Wg: int, C: int, sms: int, blocks_per_sm: int,
                        threads: int,
                        threads_per_lane: int = COL_PREFIX_THREADS_PER_LANE,
                        num_limbs: int = 22, limb_bits: int = 12
                        ) -> ColPrefixGeometry:
    """One col_prefix launch over the Wg * C columns on a card of `sms`
    SMs that holds `blocks_per_sm` blocks of `threads` threads each
    (`msm_col_prefix_limits`): a pure function, so the CPU tests can hold
    it.

    A column is a lane of `threads_per_lane` threads of one warp
    (32 // threads_per_lane columns a warp, its last threads idle), and
    keeps 15 L + 1 int32 words in shared memory (csrc/col_prefix.cu,
    `msm::PaddLane`), beside the block's copies of `Consts<L>` and
    `WideConsts<L, w>`. The kernel synchronises the whole grid between
    levels, so every block must be resident at once: never more than
    sms * blocks_per_sm blocks. With more columns than that many lanes,
    lane l of block b takes columns b * lanes_per_block + l, then that
    plus blocks * lanes_per_block, and so on; `columns_per_lane` is the
    most any lane takes."""
    G = threads_per_lane
    if (min(Wg, C, sms, threads, G, num_limbs, limb_bits) < 1
            or blocks_per_sm < 1 or threads % 32 or G > 32):
        raise ValueError("col_prefix_geometry: no resident block "
                         f"(Wg={Wg}, C={C}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}, "
                         f"threads_per_lane={G})")
    per_warp = 32 // G
    warps = threads // 32
    lanes = warps * per_warp
    total = Wg * C
    blocks = min(-(-total // lanes), sms * blocks_per_sm)
    shared = 4 * (lanes * (15 * num_limbs | 1)
                  + _static_shared_words(num_limbs, limb_bits))
    _fits_block("col_prefix_geometry", shared)
    return ColPrefixGeometry(G, per_warp, warps, lanes, blocks,
                             -(-total // (blocks * lanes)), threads, shared)


@functools.lru_cache(maxsize=None)
def _col_prefix_limits(curve: CurveParams, device: torch.device
                       ) -> Tuple[int, int, int, int]:
    """(SMs, resident blocks an SM, threads a block, threads a column) of
    the kernel."""
    L, w = _profile("col_prefix", curve)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = _build.library().msm_col_prefix_limits(
            L, w, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError("col_prefix: occupancy query failed "
                           f"(cudaError_t {rc})")
    per_sm, sms, threads, per_lane = (v.value for v in out)
    return sms, per_sm, threads, per_lane


def column_totals(tbuf: torch.Tensor, Wg: int) -> torch.Tensor:
    """The (3, L, Wg, C) column totals of a window group, row R - 1 of
    its (3, L, R, Wg C) scan output: a view, no copy."""
    _, L, R, F = tbuf.shape
    return tbuf.select(2, R - 1).view(3, L, Wg, F // Wg)


def col_prefix_row_stride(coltot: torch.Tensor, num_limbs: int) -> int:
    """The elements between the (coordinate, limb) rows of (3, L, Wg, C)
    int16 column totals that the col_prefix kernel reads in place (Wg C
    for a contiguous array, R Wg C for `column_totals`); refuses totals
    whose (Wg, C) planes are not contiguous or whose rows are not one
    stride apart. A pure function, so the CPU tests can hold it; strides
    only, no view made, as it runs once a window group."""
    L = num_limbs
    if coltot.dtype != I16 or coltot.dim() != 4 or coltot.shape[:2] != (3, L):
        raise ValueError(f"col_prefix: expected (3, {L}, Wg, C) int16 column "
                         f"totals, got {coltot.dtype} {tuple(coltot.shape)}")
    _, _, Wg, C = coltot.shape
    plane, row, sw, sc = coltot.stride()
    if ((C > 1 and sc != 1) or (Wg > 1 and sw != C) or plane != L * row
            or row < Wg * C):
        raise ValueError("col_prefix: the (Wg, C) planes of the totals must "
                         "be contiguous, one stride between their rows; "
                         f"got strides {coltot.stride()}")
    return row


def col_prefix(coltot: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """(3, L, Wg, C) int16 column totals -> (3, L, Wg, C) int16 EXCLUSIVE
    prefix points along the last axis (S[c] = sum of columns < c).
    `col_prefix_geometry` picks the launch. The totals may be a view
    whose (Wg, C) planes are contiguous with any stride between its
    (coordinate, limb) rows: `column_totals` of the scan output, read in
    place."""
    if not _on_cuda("col_prefix", coltot):
        return col_prefix_plain(coltot, curve)
    L, w = _profile("col_prefix", curve)
    row = col_prefix_row_stride(coltot, L)
    _, _, Wg, C = coltot.shape
    geo = col_prefix_geometry(
        Wg, C, *_col_prefix_limits(curve, coltot.device), L, w)
    out = torch.empty((3, L, Wg, C), dtype=I16, device=coltot.device)
    scratch = torch.empty_like(out)
    rc = _build.library().msm_col_prefix(
        L, w, coltot.data_ptr(), row, out.data_ptr(), scratch.data_ptr(),
        Wg, C, _levels(C), geo.threads_per_lane, geo.blocks,
        _consts(curve, coltot.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(coltot))
    _check("col_prefix", rc)
    LAUNCHED["col_prefix"] = geo._asdict()
    return out


# ---------------------------------------------------------------------------
# 5. Batched complete add / subtract
# ---------------------------------------------------------------------------


def padd_batch_plain(p: torch.Tensor, q: torch.Tensor, curve: CurveParams,
                     out_dtype=I32) -> torch.Tensor:
    return _stack(rows.padd_rows(_unstack(p), _unstack(q), curve)
                  ).to(out_dtype)


def psub_batch_plain(p: torch.Tensor, q: torch.Tensor, curve: CurveParams,
                     out_dtype=I32) -> torch.Tensor:
    return padd_batch_plain(p, pneg_stacked(q, curve), curve, out_dtype)


# What an SM of the H100 holds at once (compute capability 9.0): the
# residency that the geometry functions below reckon with. A launch of
# more than 48 KB of shared memory needs the kernel's opt-in
# (cudaFuncSetAttribute), which every launcher of csrc/ sets.
SM_SHARED_BYTES = 233_472         # 228 KB of shared memory
BLOCK_SHARED_BYTES = 232_448      # 227 KB a block at most
BLOCK_RESERVED_SHARED = 1_024     # taken by the system for each block
SM_BLOCKS, SM_WARPS, SM_REGISTERS = 32, 64, 65_536

PADD_THREADS_PER_LANE = 6
"""Threads of a warp that share a lane of the padd kernel
(csrc/padd_batch.cu kG)."""
PADD_MAX_WARPS = 4
"""Warps a block of the padd kernel at most (csrc/padd_batch.cu kMaxWarps)."""


class PaddGeometry(NamedTuple):
    threads_per_lane: int
    warps: int
    lanes_per_block: int
    blocks: int
    threads: int
    shared_bytes: int


def padd_batch_geometry(F: int, sms: int, num_limbs: int = 22,
                        limb_bits: int = 12) -> PaddGeometry:
    """One padd_batch launch over F lanes on a card of `sms` SMs: a pure
    function, so the CPU tests can hold it.

    PADD_THREADS_PER_LANE (6) threads of one warp share a lane, 5 lanes a
    warp (its last two threads idle). A lane keeps 15 L + 1 int32 words
    in shared memory (csrc/padd_batch.cu LaneMem), beside the block's
    copies of `Consts<L>` and `WideConsts<L, w>`. The rule: the fewest
    warps a block, from 1 to PADD_MAX_WARPS, that keep to one block an SM.
    So up to PADD_MAX_WARPS * 5 * sms lanes (2,640 on 132 SMs: the
    reduction path's launches, F = 1) a launch is one block on each of at
    most `sms` SMs and at most one warp a scheduler; above, blocks of four
    warps (the main path's 16,388 and 32,769 lanes)."""
    if F < 1 or sms < 1 or num_limbs < 1 or limb_bits < 1:
        raise ValueError("padd_batch_geometry: F, sms, num_limbs and "
                         "limb_bits must be >= 1")
    G = PADD_THREADS_PER_LANE
    per_warp = 32 // G
    warps = min(PADD_MAX_WARPS, -(-F // (per_warp * sms)))
    lanes = warps * per_warp
    # dynamic (the lanes) + static (Consts<L>, WideConsts<L, w>)
    shared = 4 * (lanes * (15 * num_limbs | 1)
                  + _static_shared_words(num_limbs, limb_bits))
    _fits_block("padd_batch_geometry", shared)
    return PaddGeometry(G, warps, lanes, -(-F // lanes), 32 * warps, shared)


def _fits_block(name: str, shared: int) -> None:
    if shared > BLOCK_SHARED_BYTES:
        raise ValueError(f"{name}: {shared} bytes of shared memory, more "
                         f"than the {BLOCK_SHARED_BYTES} a block can have")


def _static_shared_words(num_limbs: int, limb_bits: int) -> int:
    """int32 words of a block's copies of `Consts<L>` and
    `WideConsts<L, w>`."""
    bits = num_limbs * limb_bits
    return (8 * num_limbs + 3) + (bits // 32 + 1 + -(-bits // 32))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _padd_launch(name: str, p: torch.Tensor, q: torch.Tensor,
                 curve: CurveParams, out_dtype, negate: bool) -> torch.Tensor:
    L, w = _profile(name, curve)
    if p.dtype not in _BITS or out_dtype not in _BITS:
        raise ValueError(f"{name}: dtypes must be int16 or int32")
    p, q = p.contiguous(), q.contiguous()
    F = p[0, 0].numel()
    geo = padd_batch_geometry(F, _sm_count(p.device), L, w)
    out = torch.empty(p.shape, dtype=out_dtype, device=p.device)
    rc = _build.library().msm_padd_batch(
        L, w, _BITS[p.dtype], _BITS[out_dtype], p.data_ptr(), q.data_ptr(),
        out.data_ptr(), F, int(negate), geo.threads_per_lane, geo.warps,
        geo.blocks, _consts(curve, p.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(p))
    _check("padd_batch", rc)
    LAUNCHED["padd_batch"] = geo._asdict()
    return out


def _same_points(name: str, p: torch.Tensor, q: torch.Tensor) -> None:
    if p.shape != q.shape or p.dtype != q.dtype:
        raise ValueError(f"{name}: p and q must share shape and dtype")


def padd_batch(p: torch.Tensor, q: torch.Tensor, curve: CurveParams,
               out_dtype=I32) -> torch.Tensor:
    """Complete projective add on stacked (3, L, *batch) int16 or int32
    lazy points (values < 4p); returns the same shape in `out_dtype`.
    `padd_batch_geometry` picks the launch."""
    _same_points("padd_batch", p, q)
    if not _on_cuda("padd_batch", p, q):
        return padd_batch_plain(p, q, curve, out_dtype)
    return _padd_launch("padd_batch", p, q, curve, out_dtype, False)


def psub_batch(p: torch.Tensor, q: torch.Tensor, curve: CurveParams,
               out_dtype=I32) -> torch.Tensor:
    """p - q on stacked batches (q.y must be < 4p): `padd_batch` of
    `pneg_stacked(q)`. On a CUDA tensor the padd kernel computes y -> 4p -
    y in q's dtype as it loads q, and no negated copy is made."""
    _same_points("psub_batch", p, q)
    if not _on_cuda("psub_batch", p, q):
        return padd_batch(p, pneg_stacked(q, curve), curve, out_dtype)
    return _padd_launch("psub_batch", p, q, curve, out_dtype, True)


# ---------------------------------------------------------------------------
# 6. Whole bucket reduction
# ---------------------------------------------------------------------------


def _pbpr_threads(name: str, B: int, threads: int) -> int:
    T = min(threads, B)
    if T & (T - 1) or B % T:
        raise ValueError(f"{name}: threads must be a power of two dividing "
                         "the bucket count")
    return T


def pbpr_stage1_plain(buckets: torch.Tensor, curve: CurveParams,
                      threads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _, L, Wp, B = buckets.shape
    T = min(threads, B)
    Bt = B // T
    slices = buckets.reshape(3, L, Wp, T, Bt)
    inf = inf_stacked(curve, (Wp, T), buckets.device)
    m, g = inf, inf
    for j in range(Bt):
        m = _stack(rows.padd_rows(_unstack(m), _unstack(slices[..., Bt - 1 - j]),
                                  curve))
        g = _stack(rows.padd_rows(_unstack(g), _unstack(m), curve))
    return m, g


def pbpr_full_plain(buckets: torch.Tensor, curve: CurveParams,
                    threads: int) -> torch.Tensor:
    _, L, Wp, B = buckets.shape
    T = min(threads, B)
    Bt = B // T
    bits = max(T.bit_length() - 1, 0)
    inf = inf_stacked(curve, (Wp, T), buckets.device)
    m, g = pbpr_stage1_plain(buckets, curve, threads)
    mg = torch.cat([m, g], dim=2)                    # (3, L, 2Wp, T)
    inf2 = torch.cat([inf, inf], dim=2)

    def scan(mg):
        for lv in range(bits):
            k = 1 << lv
            sh = torch.cat([mg[..., k:], inf2[..., :k]], dim=-1)
            mg = _stack(rows.padd_rows(_unstack(mg), _unstack(sh), curve))
        return mg

    mg = scan(mg)
    lane0 = torch.zeros(T, dtype=torch.bool, device=buckets.device)
    lane0[0] = True
    m = torch.where(lane0, inf, mg[:, :, :Wp])
    g = torch.where(lane0, mg[:, :, Wp:], inf)
    mg = scan(torch.cat([m, g], dim=2))
    m, g = _unstack(mg[..., :Wp, 0]), _unstack(mg[..., Wp:, 0])
    for _ in range(max(Bt.bit_length() - 1, 0)):
        m = rows.pdbl_rows(m, curve)
    return _stack(rows.padd_rows(m, g, curve))


def pbpr_scan_levels(T: int) -> list:
    """(shift k, lane stride of the m half, lane stride of the g half) of
    each level of the two lane scans of `pbpr_full`'s kernel, phase A then
    phase B, as many levels each; the kernel reads this table
    (`_pbpr_levels`) and takes the mask on phase B's first level. A level
    computes the lanes t of each half that are multiples of its stride. Only the sums that a later step reads are computed,
    and these are the plain version's sums at those lanes: phase B reads
    every m lane of phase A, so phase A computes them all; the rest feeds
    lane 0 alone, which at the level of shift k reads lanes 0 and 2k of
    the level before (and so on down), so there every 2k-th lane."""
    bits = max(T.bit_length() - 1, 0)
    return ([(1 << lv, 1, 2 << lv) for lv in range(bits)]
            + [(1 << lv, 2 << lv, 2 << lv) for lv in range(bits)])


class PbprFullGeometry(NamedTuple):
    stage1: "Stage1Geometry"
    scan_blocks: int
    threads_per_add: int
    chains_per_block: int
    adds_per_chain: int


def pbpr_full_geometry(Wp: int, B: int, T: int, sms: int,
                       blocks_per_sm: int, threads: int,
                       threads_per_add: int, num_limbs: int = 22,
                       limb_bits: int = 12) -> PbprFullGeometry:
    """The two launches of one pbpr_full call: a pure function, so the
    CPU tests can hold it.

    Stage 1 is `pbpr_stage1`'s launch over the Wp * T lanes
    (`pbpr_stage1_geometry`: 12 threads a lane, 2 lanes a warp, its last
    8 threads idle). The scans and the tail are one cooperative launch, so
    every block must be resident at once: never more than
    sms * blocks_per_sm blocks of `threads` threads. An add is a chain of
    `threads_per_add` threads of one warp, 32 // threads_per_add chains a
    warp (at 6 threads, 5 chains and 2 idle threads); chain c of a level
    takes adds c, c + chains, ... of it (the widest level is phase A's
    first; with T = 1 the tail's Wp)."""
    G = threads_per_add
    if (min(Wp, B, T, sms, blocks_per_sm, G) < 1 or B % T
            or threads % 32 or G > 32):
        raise ValueError("pbpr_full_geometry: no launch for "
                         f"(Wp={Wp}, B={B}, T={T}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}, "
                         f"threads_per_add={G})")
    stage1 = pbpr_stage1_geometry(Wp, B, T, sms, num_limbs, limb_bits)
    chains_per_block = threads // 32 * (32 // G)
    widest = max([Wp * (T // sm + T // sg)
                  for _, sm, sg in pbpr_scan_levels(T)] + [Wp])
    scan = min(-(-widest // chains_per_block), sms * blocks_per_sm)
    return PbprFullGeometry(stage1, scan, G, chains_per_block,
                            -(-widest // (scan * chains_per_block)))


@functools.lru_cache(maxsize=None)
def _pbpr_full_limits(curve: CurveParams, device: torch.device
                      ) -> Tuple[int, int, int, int]:
    """(SMs, resident blocks an SM, threads a block, threads an add) of
    the scan kernel of pbpr_full."""
    L, w = _profile("pbpr_full", curve)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = _build.library().msm_pbpr_full_limits(
            L, w, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError("pbpr_full: occupancy query failed "
                           f"(cudaError_t {rc})")
    per_sm, sms, threads, per_add = (v.value for v in out)
    return sms, per_sm, threads, per_add


@functools.lru_cache(maxsize=None)
def _pbpr_levels(T: int, device: torch.device) -> torch.Tensor:
    """`pbpr_scan_levels(T)` flattened to int32 on the device: the table
    the kernel's scan levels run from."""
    return torch.tensor(pbpr_scan_levels(T), dtype=I32,
                        device=device).reshape(-1)


def pbpr_full(buckets: torch.Tensor, curve: CurveParams,
              threads: int) -> torch.Tensor:
    """Whole PBPR: (3, L, Wp, B) int16 buckets (slot b = multiplier b+1)
    -> (3, L, Wp) int32 window sums G_w = sum_b (b+1) * bucket_b."""
    _, _, Wp, B = buckets.shape
    T = _pbpr_threads("pbpr_full", B, threads)
    if not _on_cuda("pbpr_full", buckets):
        return pbpr_full_plain(buckets, curve, threads)
    L, w = _profile("pbpr_full", curve)
    _need("pbpr_full", buckets, I16, 4)
    if buckets.data_ptr() % 4 or buckets.numel() % 2:
        raise ValueError("pbpr_full: the buckets must be 4-byte aligned and "
                         "of an even element count")
    if buckets.numel() >> 31:
        raise ValueError("pbpr_full: the kernel indexes the buckets in 31 "
                         "bits")
    geo = pbpr_full_geometry(Wp, B, T, *_pbpr_full_limits(
        curve, buckets.device), L, w)
    levels = _pbpr_levels(T, buckets.device)
    out = torch.empty((3, L, Wp), dtype=I32, device=buckets.device)
    xchg = torch.empty((2, 3, L, 2 * Wp * T), dtype=I16,
                       device=buckets.device)
    rc = _build.library().msm_pbpr_full(
        L, w, buckets.data_ptr(), out.data_ptr(), xchg.data_ptr(),
        levels.data_ptr(), levels.numel() // 3, Wp, B, T,
        geo.threads_per_add, geo.stage1.warps, geo.stage1.blocks,
        geo.scan_blocks, _consts(curve, buckets.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(buckets))
    _check("pbpr_full", rc)
    LAUNCHED["pbpr_full"] = pbpr_full_launched(geo)
    return out


def pbpr_full_launched(geo: PbprFullGeometry) -> dict:
    """What `LAUNCHED["pbpr_full"]` records of a launch."""
    return dict(stage1_warps=geo.stage1.warps,
                stage1_blocks=geo.stage1.blocks,
                stage1_waves=geo.stage1.waves, scan_blocks=geo.scan_blocks,
                threads_per_add=geo.threads_per_add,
                adds_per_chain=geo.adds_per_chain)


# ---------------------------------------------------------------------------
# 7. Batched complete doubling
# ---------------------------------------------------------------------------


def pdbl_batch_plain(p: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    return _stack(rows.pdbl_rows(_unstack(p), curve))


PDBL_THREADS_PER_DOUBLING = 4
"""Threads of a warp that share a doubling (csrc/padd_lane.cuh kDblG)."""
PDBL_MAX_WARPS = 4
"""Warps a block of the doubling kernel at most (csrc/pdbl_batch.cu
kMaxWarps)."""


class PdblGeometry(NamedTuple):
    threads_per_doubling: int
    warps: int
    lanes_per_block: int
    blocks: int
    threads: int
    shared_bytes: int


def pdbl_batch_geometry(F: int, sms: int, num_limbs: int = 22,
                        limb_bits: int = 12) -> PdblGeometry:
    """One pdbl_batch launch over F lanes on a card of `sms` SMs: a pure
    function, so the CPU tests can hold it.

    PDBL_THREADS_PER_DOUBLING (4) threads of one warp share a lane, 8
    lanes a warp. A lane keeps 11 L + 1 int32 words in shared memory
    (csrc/pdbl_batch.cu DblLane), beside the block's copies of
    `Consts<L>` and `WideConsts<L, w>`. The rule, `padd_batch_geometry`'s:
    the fewest warps a block, from 1 to PDBL_MAX_WARPS, that keep to one
    block an SM. So a small batch (the reduction path's 16 lanes) is
    spread one warp a block over the SMs, and a large one (32,769 lanes)
    fills blocks of four warps."""
    if F < 1 or sms < 1 or num_limbs < 1 or limb_bits < 1:
        raise ValueError("pdbl_batch_geometry: F, sms, num_limbs and "
                         "limb_bits must be >= 1")
    G = PDBL_THREADS_PER_DOUBLING
    per_warp = 32 // G
    warps = min(PDBL_MAX_WARPS, -(-F // (per_warp * sms)))
    lanes = warps * per_warp
    shared = 4 * (lanes * (11 * num_limbs | 1)
                  + _static_shared_words(num_limbs, limb_bits))
    _fits_block("pdbl_batch_geometry", shared)
    return PdblGeometry(G, warps, lanes, -(-F // lanes), 32 * warps, shared)


def pdbl_batch(p: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Complete projective doubling on a stacked (3, L, *batch) int32 lazy
    point batch (values < 4p); returns the same shape in int32.
    `pdbl_batch_geometry` picks the launch."""
    if not _on_cuda("pdbl_batch", p):
        return pdbl_batch_plain(p, curve)
    L, w = _profile("pdbl_batch", curve)
    if p.dtype != I32 or p.dim() < 2:
        raise ValueError("pdbl_batch: expected a (3, L, *batch) int32 tensor, "
                         f"got {p.dtype} {tuple(p.shape)}")
    p = p.contiguous()
    F = p[0, 0].numel()
    geo = pdbl_batch_geometry(F, _sm_count(p.device), L, w)
    out = torch.empty_like(p)
    rc = _build.library().msm_pdbl_batch(
        L, w, p.data_ptr(), out.data_ptr(), F, geo.threads_per_doubling,
        geo.warps, geo.blocks, _consts(curve, p.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(p))
    _check("pdbl_batch", rc)
    LAUNCHED["pdbl_batch"] = geo._asdict()
    return out


# ---------------------------------------------------------------------------
# 8. Bucket reduction, stage 1 alone
# ---------------------------------------------------------------------------


PBPR_STAGE1_THREADS_PER_CHAIN = 6
"""Threads of a warp that share each of a lane's two add chains in the
stage-1 kernel (csrc/padd_lane.cuh kAddG); a lane is twice as many."""
PBPR_STAGE1_MAX_WARPS = 4
"""Warps a block of the stage-1 kernels at most (csrc/pbpr_lane.cuh
kStage1MaxWarps)."""
PBPR_STAGE1_REGISTERS = 64
"""Registers a thread of the stage-1 kernels at most at L <= 22
(csrc/pbpr_lane.cuh stage1_registers, held by the kernels'
__launch_bounds__); PBPR_STAGE1_REGISTERS_WIDE above."""
PBPR_STAGE1_REGISTERS_WIDE = 96


def pbpr_stage1_registers(num_limbs: int) -> int:
    return (PBPR_STAGE1_REGISTERS if num_limbs <= 22
            else PBPR_STAGE1_REGISTERS_WIDE)


class Stage1Geometry(NamedTuple):
    threads_per_chain: int
    lanes_per_warp: int
    warps: int
    lanes_per_block: int
    blocks: int
    threads: int
    shared_bytes: int
    blocks_per_sm: int
    waves: int


def pbpr_stage1_geometry(Wp: int, B: int, T: int, sms: int,
                         num_limbs: int = 22, limb_bits: int = 12
                         ) -> Stage1Geometry:
    """One pbpr_stage1 launch over the Wp * T lanes on a card of `sms`
    SMs: a pure function, so the CPU tests can hold it.

    A lane is 12 threads of one warp (PBPR_STAGE1_THREADS_PER_CHAIN for
    the m add, as many for the g add), 2 lanes a warp, and keeps 36 L + 1
    int32 words in shared memory (csrc/pbpr_lane.cuh Stage1Lane), beside
    the block's copies of `Consts<L>` and `WideConsts<L, w>`. A lane is a
    chain of Bt + 1 steps, so the launch takes as many waves of blocks as
    the card needs to hold every lane once: the blocks an SM holds are
    bounded by its shared memory (each block also takes
    BLOCK_RESERVED_SHARED), its registers (pbpr_stage1_registers a
    thread), and its block and warp slots. The rule: the fewest waves,
    then the fewest warps a block (1 to PBPR_STAGE1_MAX_WARPS), which
    spreads the lanes most evenly over the SMs."""
    G = PBPR_STAGE1_THREADS_PER_CHAIN
    if min(Wp, B, T, sms, num_limbs, limb_bits) < 1 or B % T:
        raise ValueError("pbpr_stage1_geometry: no launch for "
                         f"(Wp={Wp}, B={B}, T={T}, sms={sms}, "
                         f"num_limbs={num_limbs}, limb_bits={limb_bits})")
    per_warp = 32 // (2 * G)
    lanes = Wp * T
    best = None
    for warps in range(1, PBPR_STAGE1_MAX_WARPS + 1):
        per_block = warps * per_warp
        shared = 4 * (per_block * (36 * num_limbs | 1)
                      + _static_shared_words(num_limbs, limb_bits))
        if shared > BLOCK_SHARED_BYTES:
            break
        per_sm = min(SM_BLOCKS, SM_WARPS // warps,
                     SM_REGISTERS // (pbpr_stage1_registers(num_limbs) * 32
                                      * warps),
                     SM_SHARED_BYTES // (shared + BLOCK_RESERVED_SHARED))
        blocks = -(-lanes // per_block)
        waves = -(-blocks // (sms * per_sm))
        geo = Stage1Geometry(G, per_warp, warps, per_block, blocks,
                             32 * warps, shared, per_sm, waves)
        if best is None or waves < best.waves:
            best = geo
    if best is None:
        raise ValueError("pbpr_stage1_geometry: a lane does not fit a block's "
                         f"shared memory (num_limbs={num_limbs})")
    return best


def pbpr_stage1(buckets: torch.Tensor, curve: CurveParams,
                threads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cuZK Alg. 4 stage 1: (3, L, Wp, B) int16 or int32 buckets (slot b =
    multiplier b+1) -> (m, g), each (3, L, Wp, T) int32, T = min(threads,
    B). Slice t holds buckets t*Bt .. t*Bt + Bt-1 (Bt = B / T), walked from
    the top down: m_t is the slice sum, g_t = sum_j (j+1) * bucket_{t,j}.
    `pbpr_stage1_geometry` picks the launch."""
    _, _, Wp, B = buckets.shape
    T = _pbpr_threads("pbpr_stage1", B, threads)
    if not _on_cuda("pbpr_stage1", buckets):
        return pbpr_stage1_plain(buckets, curve, threads)
    L, w = _profile("pbpr_stage1", curve)
    if buckets.dtype not in _BITS or buckets.dim() != 4:
        raise ValueError("pbpr_stage1: expected a 4-d int16 or int32 tensor, "
                         f"got {buckets.dtype} {tuple(buckets.shape)}")
    buckets = buckets.contiguous()
    if buckets.dtype == I16 and (buckets.data_ptr() % 4
                                 or buckets.numel() % 2):
        raise ValueError("pbpr_stage1: int16 buckets must be 4-byte aligned "
                         "and of an even element count")
    if buckets.numel() >> 31:
        raise ValueError("pbpr_stage1: the kernel indexes the buckets in 31 "
                         "bits")
    geo = pbpr_stage1_geometry(Wp, B, T, _sm_count(buckets.device), L, w)
    m = torch.empty((3, L, Wp, T), dtype=I32, device=buckets.device)
    g = torch.empty_like(m)
    rc = _build.library().msm_pbpr_stage1(
        L, w, _BITS[buckets.dtype], buckets.data_ptr(), m.data_ptr(),
        g.data_ptr(), Wp, B, T, geo.threads_per_chain, geo.warps, geo.blocks,
        _consts(curve, buckets.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(buckets))
    _check("pbpr_stage1", rc)
    LAUNCHED["pbpr_stage1"] = geo._asdict()
    return m, g


# ---------------------------------------------------------------------------
# 9. Full-stream globalisation G = T + S
# ---------------------------------------------------------------------------


def globalize_plain(tbuf: torch.Tensor, s: torch.Tensor, curve: CurveParams,
                    out_dtype=I32) -> torch.Tensor:
    return padd_batch_plain(tbuf, s[:, :, None].expand_as(tbuf), curve,
                            out_dtype)


def globalize(tbuf: torch.Tensor, s: torch.Tensor, curve: CurveParams,
              out_dtype=I32) -> torch.Tensor:
    """G[:, :, r, f] = T[:, :, r, f] + S[:, :, f]: one complete add per
    stream position, the per-lane exclusive column prefix broadcast over
    the R rows. tbuf: (3, L, R, F) from `prefix_scan`; s: (3, L, F), the
    flattened (3, L, Wg, C) of `col_prefix`; both int16 or both int32.
    Returns (3, L, R, F) in `out_dtype`. The kernel is padd_batch's over
    the R * F positions (`padd_batch_geometry` picks the launch), reading
    S at position mod F."""
    if (tbuf.dim() != 4 or s.dim() != 3 or s.shape != tbuf.shape[:2]
            + tbuf.shape[3:] or s.dtype != tbuf.dtype):
        raise ValueError("globalize: expected T (3, L, R, F) and S (3, L, F) "
                         f"of one dtype, got {tuple(tbuf.shape)} {tbuf.dtype} "
                         f"and {tuple(s.shape)} {s.dtype}")
    if not _on_cuda("globalize", tbuf, s):
        return globalize_plain(tbuf, s, curve, out_dtype)
    L, w = _profile("globalize", curve)
    if tbuf.dtype not in _BITS or out_dtype not in _BITS:
        raise ValueError("globalize: dtypes must be int16 or int32")
    tbuf, s = tbuf.contiguous(), s.contiguous()
    _, _, R, F = tbuf.shape
    if R * F >> 32:
        raise ValueError("globalize: the kernel takes fewer than 2^32 "
                         "positions")
    geo = padd_batch_geometry(R * F, _sm_count(tbuf.device), L, w)
    out = torch.empty(tbuf.shape, dtype=out_dtype, device=tbuf.device)
    rc = _build.library().msm_globalize(
        L, w, _BITS[tbuf.dtype], _BITS[out_dtype], tbuf.data_ptr(),
        s.data_ptr(), out.data_ptr(), R * F, F, geo.threads_per_lane,
        geo.warps, geo.blocks, _consts(curve, tbuf.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(tbuf))
    _check("globalize", rc)
    LAUNCHED["globalize"] = geo._asdict()
    return out


# ---------------------------------------------------------------------------
# 10. GLV split and the doubled point stream
# ---------------------------------------------------------------------------

# working width of the lattice combination: 12 halfwords = 192 bits of
# two's complement, which hold |k_i| <= 2^127 and a sign
B_LIMBS = 12
_B_BITS = 16 * B_LIMBS

# Profiles with an endomorphism that csrc/glv_apply.cu is built for:
# BN254_S12, BN254_S13, BLS12_377_S12, BLS12_377_S13.
GLV_PROFILES = {(22, 12), (21, 13), (32, 12), (30, 13)}


def _const(value: int, num_limbs: int, device) -> torch.Tensor:
    """Non-negative int -> (num_limbs, 1) int64 halfwords, broadcastable
    over the lanes."""
    return torch.tensor(int_to_limbs(value, num_limbs, 16), dtype=I64,
                        device=device)[:, None]


def split_scalars(halfwords: torch.Tensor, glvp: GLVParams
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """(H, n) scalar halfwords -> (neg1, mag1, neg2, mag2).

    The mags are (B_LIMBS, n) int32 halfword magnitudes |k1|, |k2|; the
    negs are (n,) bool sign masks. Bit for bit `GLVParams.decompose`: two
    mul-shift Babai roundings, two lattice combinations in two's
    complement mod 2^192, then sign and magnitude. The halfword
    arithmetic runs on int64 limbs (`ops/limbs.py` says why)."""
    dev = halfwords.device
    n = halfwords.shape[1]
    r = glvp.curve.scalar_modulus
    hs = (r.bit_length() + 15) // 16
    k = halfwords[:hs].to(I64)
    shift_limbs = M_SHIFT // 16                       # 17

    cs = []
    for g in (glvp.g1, glvp.g2):
        gh = max(1, (g.bit_length() + 15) // 16)
        prod = mul_wide(k, _const(g, gh, dev))        # (hs + gh, n)
        # rounding addend 2^(M_SHIFT-1): bit 15 of halfword 16
        rnd = _const(1 << (M_SHIFT - 1), prod.shape[0], dev)
        prod = limbs.add_unsafe(prod, rnd)
        c = prod[shift_limbs:]                        # >> M_SHIFT
        # c < 2^129 (k < 2^255, g < 2^147): pad or trim to 9 limbs
        if c.shape[0] < 9:
            c = torch.cat([c, c.new_zeros((9 - c.shape[0], n))])
        cs.append(c[:9])
    c1, c2 = cs

    def mul_mod_b(c: torch.Tensor, const: int) -> torch.Tensor:
        """c * const mod 2^_B_BITS (a negative const by its two's
        complement representative)."""
        return mul_wide(c, _const(const % (1 << _B_BITS), B_LIMBS, dev)
                        )[:B_LIMBS]

    zero = torch.zeros((B_LIMBS, n), dtype=I64, device=dev)
    # k[:B_LIMBS] drops the top halfwords of k on purpose: mod 2^192
    k1 = limbs.sub(limbs.sub(k[:B_LIMBS], mul_mod_b(c1, glvp.a1)),
                   mul_mod_b(c2, glvp.a2))
    k2 = limbs.sub(zero, limbs.add_unsafe(mul_mod_b(c1, glvp.b1),
                                          mul_mod_b(c2, glvp.b2)))

    def sign_mag(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        neg = (x[B_LIMBS - 1] >> 15) == 1             # two's complement sign
        mag = limbs.select(neg, limbs.sub(zero, x), x)
        return neg, mag.to(I32)

    neg1, mag1 = sign_mag(k1)
    neg2, mag2 = sign_mag(k2)
    return neg1, mag1, neg2, mag2


def glv_apply_plain(xm: torch.Tensor, ym: torch.Tensor,
                    halfwords: torch.Tensor, curve: CurveParams,
                    glvp: GLVParams):
    neg1, mag1, neg2, mag2 = split_scalars(halfwords, glvp)
    # phi(P) = (beta * x, y); the signs fold into y (-P = (x, -y))
    xb = rows.mont_mul_rows(
        xm, rows.const_rows(curve.to_mont(glvp.beta), curve, xm), curve)
    # 2p - y, rippled again: the int16 row table needs canonical limbs
    yn = rows.canon_rows(rows.neg_rows(ym, curve, 2), curve)
    y1 = rows.select_rows(neg1, yn, ym)
    y2 = rows.select_rows(neg2, yn, ym)
    return (torch.cat([xm, xb], dim=-1), torch.cat([y1, y2], dim=-1),
            torch.cat([mag1, mag2], dim=-1), neg1, neg2)


def _glv_consts_host(curve: CurveParams, glvp: GLVParams) -> list:
    """The words of `GlvConsts<L, W>` (csrc/glv_apply.cu): the
    `WideConsts` of the multiply, beta R mod p in ceil(L w / 32) words,
    2p in L canonical limbs, then `_glv_split_words`."""
    n = -(-curve.num_limbs * curve.log_limb_size // 32)
    return (_wide_consts_host(curve) + _words(curve.to_mont(glvp.beta), n)
            + int_to_limbs(2 * curve.p, curve.num_limbs, curve.log_limb_size)
            + _glv_split_words(glvp))


def _glv_split_words(glvp: GLVParams) -> list:
    """The words of `GlvSplit` (csrc/glv_split.cuh): g1 and g2 in 5
    words, a1, a2, b1, b2 mod 2^192 in 6. Refuses a Babai multiplier of
    2^159 or more, where k g + 2^271 could pass the 13 words of the
    product."""
    if max(glvp.g1, glvp.g2) >> 159:
        raise ValueError(f"{glvp.curve.name}: a GLV multiplier is too wide "
                         "for the kernel's 5 words")
    mod_b = lambda v: _words(v % (1 << _B_BITS), 6)
    return (_words(glvp.g1, 5) + _words(glvp.g2, 5) + mod_b(glvp.a1)
            + mod_b(glvp.a2) + mod_b(glvp.b1) + mod_b(glvp.b2))


@functools.lru_cache(maxsize=None)
def _glv_consts(curve: CurveParams, glvp: GLVParams) -> ctypes.Array:
    words = _glv_consts_host(curve, glvp)
    return (ctypes.c_uint32 * len(words))(*words)


def glv_rows_plain(xs: torch.Tensor, ys: torch.Tensor,
                   halfwords: torch.Tensor, curve: CurveParams,
                   glvp: GLVParams):
    xm, ym = (encode_mont_plain(v.to(I32), curve) for v in (xs, ys))
    x2, y2, mags, neg1, neg2 = glv_apply_plain(xm, ym, halfwords.to(I32),
                                               curve, glvp)
    return row_table(x2, y2), mags, neg1, neg2


def glv_rows(xs: torch.Tensor, ys: torch.Tensor, halfwords: torch.Tensor,
             curve: CurveParams, glvp: GLVParams):
    """(L, n) standard-form x and y limbs (encoded here), int16 or int32
    as staged, and raw (H, n) 16-bit scalar halfwords, uint16 or int32
    (`LIMB_DTYPES`, `HALFWORD_DTYPES`) -> (table, mags, neg1, neg2): the
    doubled stream's (2n, 2L) int16 row table, rows [0, n) sign1 * P
    and rows [n, 2n) sign2 * phi(P) (canonical limbs, y negated as
    2p - y, rippled), the (B_LIMBS, 2n) int32 halfword magnitudes |k1|
    then |k2|, and the (n,) bool signs of k1 and k2. One launch, the
    inputs read in place (any row stride)."""
    if glvp.curve != curve:
        raise ValueError(f"glv_apply: GLV parameters of {glvp.curve.name} "
                         f"for {curve.name}")
    if not _on_cuda("glv_apply", xs, ys, halfwords):
        return glv_rows_plain(xs, ys, halfwords, curve, glvp)
    L, w = _profile("glv_apply", curve)
    if (L, w) not in GLV_PROFILES:
        raise ValueError(f"glv_apply: no GLV kernel for {curve.name}")
    ldx = _lanes("glv_apply", xs, LIMB_DTYPES, L)
    ldy = _lanes("glv_apply", ys, LIMB_DTYPES, L)
    ldh = _lanes("glv_apply", halfwords, HALFWORD_DTYPES)
    n = xs.shape[1]
    if ys.dtype != xs.dtype or ys.shape[1] != n or halfwords.shape[1] != n:
        raise ValueError(f"glv_apply: shapes {tuple(xs.shape)}, "
                         f"{tuple(ys.shape)}, {tuple(halfwords.shape)}")
    hs = (curve.scalar_modulus.bit_length() + 15) // 16
    dev = xs.device
    table = torch.empty((2 * n, 2 * L), dtype=I16, device=dev)
    mags = torch.empty((B_LIMBS, 2 * n), dtype=I32, device=dev)
    neg1 = torch.empty(n, dtype=torch.bool, device=dev)
    neg2 = torch.empty_like(neg1)
    if n:
        consts = _glv_consts(curve, glvp)
        rc = _build.library().msm_glv_apply(
            L, w, xs.data_ptr(), ys.data_ptr(), xs.element_size(), ldx, ldy,
            halfwords.data_ptr(), halfwords.element_size(), ldh,
            min(hs, halfwords.shape[0]), n, table.data_ptr(),
            mags.data_ptr(), neg1.data_ptr(), neg2.data_ptr(),
            ctypes.addressof(consts), len(consts), _stream(xs))
        _check("glv_apply", rc)
    return table, mags, neg1, neg2


def glv_apply(xm: torch.Tensor, ym: torch.Tensor, halfwords: torch.Tensor,
              curve: CurveParams, glvp: GLVParams):
    """Montgomery-encoded (L, n) points and raw (H, n) 16-bit scalar
    halfwords -> (x2, y2, mags, neg1, neg2): the doubled stream of 2n
    lanes, sign1 * P then sign2 * phi(P), as (L, 2n) int32 canonical
    limbs (y negated as 2p - y, rippled), the (B_LIMBS, 2n) int32 halfword
    magnitudes |k1| then |k2|, and the (n,) bool signs of k1 and k2: the
    JAX function's planar layout, for the tests that hold the port
    against it: CPU tensors only. The card runs `glv_rows` (the same
    split from the wire, written as rows)."""
    if glvp.curve != curve:
        raise ValueError(f"glv_apply: GLV parameters of {glvp.curve.name} "
                         f"for {curve.name}")
    if _on_cuda("glv_apply", xm, ym, halfwords):
        raise ValueError("glv_apply: the planar form runs on CPU tensors "
                         "only; on the card call glv_rows")
    return glv_apply_plain(xm, ym, halfwords, curve, glvp)


# ---------------------------------------------------------------------------
# 11. projective -> affine and batched inversion: one product tree
# ---------------------------------------------------------------------------

# What a launch of the tree does (csrc/batch_inv.cuh kTreeUp, kTreeRoot,
# kTreeDown).
TREE_UP, TREE_ROOT, TREE_DOWN = 1, 2, 4
TREE_THREADS_LOG = 8
"""Threads a block of the tree kernels, log2 (kTreeThreadsLog)."""
TREE_REG_LOG = 2
"""Leaves of a thread's register subtree at most, log2 (kTreeRegLog)."""


class TreeLaunch(NamedTuple):
    roles: int     # TREE_UP | TREE_ROOT | TREE_DOWN
    lo: int        # level of the launch's leaves
    n: int         # levels a block covers: 2^n leaves a block
    d: int         # levels a thread covers in registers: 2^d leaves
    blocks: int


class TreeGeometry(NamedTuple):
    K: int
    Kp: int                   # K padded to a power of two
    levels: int               # log2 Kp
    block_log: int            # leaves a block of an up or down launch, log2
    launches: Tuple[TreeLaunch, ...]
    scratch_nodes: int        # 2 Kp nodes of N words a plane


def batch_inverse_geometry(K: int, threads_log: int = TREE_THREADS_LOG,
                           reg_log: int = TREE_REG_LOG) -> TreeGeometry:
    """The launches of one product-tree call on K elements
    (csrc/batch_inv.cuh): a pure function, so the CPU tests can hold it.

    The tree is `ops/inverse.batch_inverse`'s on Kp leaves, Kp the next
    power of two. A block of an up or a down launch owns 2^b leaves, b =
    threads_log + reg_log, 2^reg_log a thread. While more than b levels
    are left above a launch's leaves, an up launch of Kp / 2^(lo + b)
    blocks takes b of them; the top levels, n <= b, go to one launch of
    one block that runs up, the root's chain and down, its threads at
    2^d = 2^max(0, n - threads_log) leaves each; then the down launches
    of the up launches, in reverse order. So Kp <= 2^b is one launch
    and Kp <= 2^(2b) (2^20) three."""
    if K < 1 or threads_log < 0 or not 0 <= reg_log <= TREE_REG_LOG:
        raise ValueError("batch_inverse_geometry: K >= 1, threads_log >= 0 "
                         f"and 0 <= reg_log <= {TREE_REG_LOG}")
    Kp = 1 << (K - 1).bit_length()
    levels = Kp.bit_length() - 1
    b = threads_log + reg_log
    if b < 1:
        raise ValueError("batch_inverse_geometry: a block needs 2 leaves")
    ups, lo = [], 0
    while levels - lo > b:
        ups.append(TreeLaunch(TREE_UP, lo, b, reg_log, Kp >> (lo + b)))
        lo += b
    n = levels - lo
    top = TreeLaunch(TREE_UP | TREE_ROOT | TREE_DOWN, lo, n,
                     max(0, n - threads_log), 1)
    downs = [u._replace(roles=TREE_DOWN) for u in reversed(ups)]
    return TreeGeometry(K, Kp, levels, b, tuple(ups + [top] + downs),
                        2 * Kp)


def _affine_consts_host(curve: CurveParams) -> list:
    """The words of `TreeConsts<L, W>` (csrc/batch_inv.cuh): the
    `WideConsts` of the multiply, R mod p, the exponent p - 2 and
    -p^-1 mod 2^(32 n) (the warp multiply's) in n = ceil(L w / 32) words
    each, and the exponent's bit length."""
    n = -(-curve.num_limbs * curve.log_limb_size // 32)
    e = curve.p - 2
    pinv = -pow(curve.p, -1, 1 << (32 * n)) % (1 << (32 * n))
    return (_wide_consts_host(curve) + _words(curve.r_mod_p, n)
            + _words(e, n) + _words(pinv, n) + [e.bit_length()])


@functools.lru_cache(maxsize=None)
def _affine_consts(curve: CurveParams) -> ctypes.Array:
    words = _affine_consts_host(curve)
    return (ctypes.c_uint32 * len(words))(*words)


def _tree(name: str, curve: CurveParams, K: int, device: torch.device,
          launch) -> None:
    """Every launch of the tree for K elements: launch(lib, scratch,
    Kp, TreeLaunch, consts) returns its cudaError_t. The scratch: the
    tree's 2 Kp nodes in N word planes."""
    geo = batch_inverse_geometry(K)
    N = -(-curve.num_limbs * curve.log_limb_size // 32)
    scratch = torch.empty((N, geo.scratch_nodes), dtype=I32, device=device)
    consts = _affine_consts(curve)
    lib = _build.library()
    for ln in geo.launches:
        _check(name, launch(lib, scratch.data_ptr(), geo.Kp, ln, consts))
    LAUNCHED[name] = dict(K=K, Kp=geo.Kp, launches=len(geo.launches),
                          plan=[tuple(ln) for ln in geo.launches])


def batch_inverse(a: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Elementwise Montgomery-domain inverse of (L, *batch) int16 or
    int32 limbs, zeros to zero: canonical limbs, value < 2p, int32.

    On CPU tensors `ops/inverse.batch_inverse` (`batch_inverse_plain`);
    on CUDA tensors the launches of csrc/batch_inverse.cu, the same
    product tree (`batch_inverse_geometry`), which give its bits."""
    if not _on_cuda("batch_inverse", a):
        return batch_inverse_plain(a, curve)
    L, w = _profile("batch_inverse", curve)
    if a.dim() < 1 or a.shape[0] != L:
        raise ValueError(f"batch_inverse: limbs of shape {tuple(a.shape)} "
                         f"for L = {L}")
    flat = a.to(I32).reshape(L, -1).contiguous()
    K = flat.shape[1]
    out = torch.empty((L, K), dtype=I32, device=flat.device)
    if K:
        zero = torch.empty(K, dtype=torch.uint8, device=flat.device)
        stream = _stream(flat)
        _tree("batch_inverse", curve, K, flat.device,
              lambda lib, scratch, Kp, ln, consts: lib.msm_batch_inverse(
                  L, w, flat.data_ptr(), K, out.data_ptr(), zero.data_ptr(),
                  scratch, Kp, ln.lo, ln.n, ln.d, ln.roles, ln.blocks,
                  ctypes.addressof(consts), len(consts), stream))
    return out.reshape(a.shape)


def to_affine(p, curve: CurveParams
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projective (X : Y : Z), a `rows.ProjRows` or a stacked (3, L, ...)
    tensor (int16 or int32 lazy limbs), -> affine (X/Z, Y/Z), fully
    reduced (< p) in the Montgomery domain, and the infinity mask.

    On CPU tensors `to_affine_plain` (`ops/inverse.py`); on CUDA tensors
    the launches of csrc/to_affine.cu, the same product tree
    (`batch_inverse_geometry`) with Z one at the leaves and X zinv, Y
    zinv reduced at the ends, which give its bits."""
    px, py, pz = p
    if not _on_cuda("to_affine", px, py, pz):
        return to_affine_plain(p, curve)
    L, w = _profile("to_affine", curve)
    batch = px.shape[1:]
    if px.shape[0] != L or py.shape != px.shape or pz.shape != px.shape:
        raise ValueError(f"to_affine: coordinates of shapes "
                         f"{tuple(px.shape)}, {tuple(py.shape)}, "
                         f"{tuple(pz.shape)} for L = {L}")
    x, y, z = (c.to(I32).reshape(L, -1).contiguous() for c in (px, py, pz))
    K = x.shape[1]
    ax = torch.empty((L, K), dtype=I32, device=x.device)
    ay = torch.empty_like(ax)
    inf = torch.empty(K, dtype=torch.bool, device=x.device)
    if K:
        stream = _stream(x)
        _tree("to_affine", curve, K, x.device,
              lambda lib, scratch, Kp, ln, consts: lib.msm_to_affine(
                  L, w, x.data_ptr(), y.data_ptr(), z.data_ptr(), K,
                  ax.data_ptr(), ay.data_ptr(), inf.data_ptr(), scratch, Kp,
                  ln.lo, ln.n, ln.d, ln.roles, ln.blocks,
                  ctypes.addressof(consts), len(consts), stream))
    return (ax.reshape((L,) + batch), ay.reshape((L,) + batch),
            inf.reshape(batch))


# ---------------------------------------------------------------------------
# 12. Stage 2: the stable bucket sort and its boundary counts
# ---------------------------------------------------------------------------

SORT_RADIX_BITS = 8
"""Bits of the key that one pass of csrc/bucket_sort.cu sorts on."""
SORT_TILE = 4096
"""Stream elements a block of the sort's pass kernel ranks at once
(csrc/bucket_sort.cu kTile: 8 warps of 32 threads, 16 elements a
thread)."""
SORT_UPSWEEP_THREADS = 1024
"""Threads a block of the sort's upsweep (csrc/bucket_sort.cu
kUpThreads)."""


def bucket_counts(skeys2: torch.Tensor, B: int) -> torch.Tensor:
    """cnt[w, j] = #(keys2[w] < 2(j+1)) for j = 0..B, from the sorted keys:
    the end of the digit-0 region (j = 0) and of each bucket's region."""
    Wp = skeys2.shape[0]
    q = (torch.arange(1, B + 2, dtype=I32, device=skeys2.device) * 2)
    return torch.searchsorted(skeys2, q.expand(Wp, B + 1).contiguous()
                              ).to(I32)


def bucket_sort_plain(digits: torch.Tensor, B: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    key = digits.to(I32).abs()
    skey, perm = torch.sort(key, dim=-1, stable=True)
    sign = (torch.gather(digits, 1, perm) < 0).to(I32)
    return (perm.to(I32) << 1) | sign, bucket_counts(skey << 1, B)


def sort_passes(B: int) -> int:
    """Passes of SORT_RADIX_BITS over the key |d| <= B."""
    return max(-(-B.bit_length() // SORT_RADIX_BITS), 1)


class SortGeometry(NamedTuple):
    passes: int
    tiles: int
    key_max: int
    chunks: int
    upsweep_blocks: int
    upsweep_shared_bytes: int
    upsweep_blocks_per_sm: int
    count_blocks: int
    launches: int
    work_words: int


def bucket_sort_geometry(Wp: int, n: int, B: int, sms: int) -> SortGeometry:
    """One bucket_sort call on (Wp, n) digits with |d| <= B on a card of
    `sms` SMs: a pure function, so the CPU tests can hold it.

    Launches: the upsweep, the counts, and one pass kernel a pass
    (csrc/bucket_sort.cu). The upsweep's block counts a chunk of one
    window's keys min(|d|, key_max) in a histogram of key_max + 1 bins,
    rounded up to whole segments of 256, in shared memory; it takes
    `chunks` blocks a window, as many as are resident beside each other
    on the card (SORT_UPSWEEP_THREADS threads, the histogram, the SM's
    shared memory), at least one and never more than a chunk a tile of
    the window. The counts take a block a segment of 256 bins of a
    window. A pass takes a block a tile of SORT_TILE elements. work_words:
    the int32 temporaries of csrc/bucket_sort.cu msm_bucket_sort."""
    if min(Wp, n, B, sms) < 1:
        raise ValueError("bucket_sort_geometry: Wp, n, B and sms must be "
                         ">= 1")
    passes = sort_passes(B)
    radix = 1 << SORT_RADIX_BITS
    key_max = min(B + 1, (1 << (SORT_RADIX_BITS * passes)) - 1)
    bins = ((key_max >> SORT_RADIX_BITS) + 1) * radix
    shared = 4 * bins
    _fits_block("bucket_sort_geometry", shared)
    per_sm = min(SM_WARPS // (SORT_UPSWEEP_THREADS // 32),
                 SM_SHARED_BYTES // (shared + BLOCK_RESERVED_SHARED))
    tiles = -(-n // SORT_TILE)
    chunks = max(1, min(sms * per_sm // Wp, tiles))
    work = (Wp * chunks * (B + 1) + Wp * chunks * passes * radix
            + passes * Wp * radix + passes * Wp * (tiles * radix + 1))
    return SortGeometry(passes, tiles, key_max, chunks,
                        Wp * chunks, shared, per_sm,
                        Wp * ((B >> SORT_RADIX_BITS) + 1), 2 + passes, work)


def bucket_sort(digits: torch.Tensor, B: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Wp, n) int16 signed digits with |d| <= B -> (pay, cnt).

    pay: (Wp, n) int32, idx << 1 | sign in the order of a STABLE sort of
    each window by the key |d| (ties in index order); the sign rides in
    the payload, as stage 3 reads only the |d| boundaries. cnt: (Wp, B+1)
    int32, cnt[w, j] = #(|d| <= j in window w), `bucket_counts` of the
    sorted keys. The kernel is a one-sweep LSD radix sort of
    `sort_passes(B)` passes of SORT_RADIX_BITS bits after an upsweep that
    counts the keys and a launch that scans them into cnt
    (`bucket_sort_geometry`); deterministic. Its temporaries are torch
    tensors on the current stream."""
    if digits.dim() != 2 or digits.dtype != I16:
        raise ValueError("bucket_sort: expected (Wp, n) int16 digits, got "
                         f"{digits.dtype} {tuple(digits.shape)}")
    Wp, n = digits.shape
    if not 1 <= B <= 1 << 15 or n < 1 or n >> 30:
        raise ValueError(f"bucket_sort: needs 1 <= B <= 2^15 and "
                         f"1 <= n < 2^30, got B={B}, n={n}")
    if not _on_cuda("bucket_sort", digits):
        return bucket_sort_plain(digits, B)
    digits = digits.contiguous()
    dev = digits.device
    pay = torch.empty((Wp, n), dtype=I32, device=dev)
    cnt = torch.empty((Wp, B + 1), dtype=I32, device=dev)
    if Wp:
        geo = bucket_sort_geometry(Wp, n, B, _sm_count(dev))
        # the keys and payloads between the passes (uint16 keys in the
        # kernel), and the int32 temporaries
        mid = (Wp, n) if geo.passes > 1 else (1,)
        keys_mid = torch.empty(mid, dtype=I16, device=dev)
        pay_mid = torch.empty(mid, dtype=I32, device=dev)
        work = torch.empty(geo.work_words, dtype=I32, device=dev)
        rc = _build.library().msm_bucket_sort(
            digits.data_ptr(), Wp, n, B, geo.passes, geo.chunks,
            pay.data_ptr(), cnt.data_ptr(), keys_mid.data_ptr(),
            pay_mid.data_ptr(), work.data_ptr(), _stream(digits))
        _check("bucket_sort", rc)
        LAUNCHED["bucket_sort"] = geo._asdict()
    return pay, cnt


# ---------------------------------------------------------------------------
# 13. Stage 3: bucket extraction at the region ends
# ---------------------------------------------------------------------------


def boundary_lanes(cnt: torch.Tensor, Wg: int, C: int, R: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, jt) of a window group's (Wg, B+1) counts: f, the lane of the
    last position below each boundary, and jt, that position's element
    r * F + f of the flattened (3, L, R * F) scan output (F = Wg C). Both
    are clamped to position 0 where cnt == 0."""
    p = (cnt - 1).clamp(min=0)
    f = (torch.arange(cnt.shape[0], dtype=I32, device=cnt.device) % Wg
         )[:, None] * C + p // R
    return f, (p % R) * (Wg * C) + f


def extract_buckets_plain(tbuf: torch.Tensor, s: torch.Tensor,
                          cnt: torch.Tensor, buckets: torch.Tensor, g: int,
                          Wg: int, C: int, R: int, curve: CurveParams
                          ) -> torch.Tensor:
    L, F = curve.num_limbs, Wg * C
    sl = slice(g * Wg, (g + 1) * Wg)
    cnt_g = cnt[sl]
    f, jt = boundary_lanes(cnt_g, Wg, C, R)
    Tall = tbuf.reshape(3, L, R * F)[:, :, jt.long()]
    Sall = s.reshape(3, L, F)[:, :, f.long()]             # (3, L, Wg, B+1)
    Gall = padd_batch_plain(Tall, Sall, curve)
    # cnt == 0: nothing sorts below this boundary, G(-1) = infinity
    Gp = torch.where(cnt_g == 0, inf_stacked(curve, (Wg, 1), tbuf.device),
                     Gall)
    # bucket b (multiplier b+1) = G(end of its region) - G(previous end)
    buckets[:, :, sl] = psub_batch_plain(Gp[..., 1:], Gp[..., :-1], curve,
                                         out_dtype=I16)
    return buckets


EXTRACT_ADD_WARPS = 8
"""Warps of lanes a block of csrc/extract_buckets.cu (kAddWarps); one
loader warp more."""
EXTRACT_LANES = EXTRACT_ADD_WARPS * (32 // PADD_THREADS_PER_LANE)
EXTRACT_THREADS = 32 * (EXTRACT_ADD_WARPS + 1)


class ExtractGeometry(NamedTuple):
    lanes_per_block: int
    buckets_per_run: int
    runs_per_window: int
    runs: int
    blocks: int
    runs_per_block: int
    blocks_per_sm: int
    waves: int
    threads: int
    shared_bytes: int


def extract_buckets_geometry(Wg: int, B: int, sms: int, blocks_per_sm: int,
                             num_limbs: int = 22, limb_bits: int = 12
                             ) -> ExtractGeometry:
    """One extract_buckets launch for a window group of Wg windows of B
    buckets on a card of `sms` SMs that holds `blocks_per_sm` blocks of
    the kernel (`msm_extract_buckets_limits`): a pure function, so the CPU
    tests can hold it.

    A block is EXTRACT_ADD_WARPS warps of padd_lane.cuh's lanes, 6
    threads a lane and 5 lanes a warp (40 lanes), and a loader warp. A run
    is 39 = lanes - 1 consecutive buckets b0 .. b0 + 38 of one window
    (the last run of a window shorter): G_j = T + S at the 40 region ends
    b0 .. b0 + 39 (the halo lane b0 is the run before's last), then
    bucket b = G_{b+1} - G_b on 39 lanes. The grid is persistent, as many
    blocks as are resident and no more than the runs, one wave; block k
    takes runs k, k + blocks, ..., at most runs_per_block of them.
    Shared memory: each lane's 15 L + 1 words (PaddLane), the loader's
    staging of T and S (3 L int16 a lane each) and the run's gather
    positions, and the block's copies of the constants."""
    if min(Wg, B, sms, blocks_per_sm, num_limbs, limb_bits) < 1:
        raise ValueError("extract_buckets_geometry: Wg, B, sms, "
                         "blocks_per_sm, num_limbs and limb_bits must be "
                         ">= 1")
    lanes = EXTRACT_LANES
    J = lanes - 1
    rpw = -(-B // J)
    runs = Wg * rpw
    resident = sms * blocks_per_sm
    blocks = min(runs, resident)
    shared = 4 * (lanes * (15 * num_limbs | 1) + lanes * 3 * num_limbs
                  + 2 * lanes + 12 + _static_shared_words(num_limbs,
                                                          limb_bits))
    _fits_block("extract_buckets_geometry", shared)
    return ExtractGeometry(lanes, J, rpw, runs, blocks, -(-runs // blocks),
                           blocks_per_sm, -(-blocks // resident),
                           EXTRACT_THREADS, shared)


def fast_div(d: int) -> Tuple[int, int]:
    """(m, s) with x // d == (x * m) >> s for 0 <= x < 2^31 and
    1 <= d < 2^31: Granlund and Montgomery's multiply for a division,
    m = floor(2^(32 + l) / d) + 1 where 2^(l - 1) < d <= 2^l and
    s = 32 + l; csrc/extract_buckets.cu `fast_div` divides so."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"fast_div: divisor {d} out of range")
    lg = (d - 1).bit_length()
    return (1 << (32 + lg)) // d + 1, 32 + lg


@functools.lru_cache(maxsize=None)
def _extract_limits(curve: CurveParams, device: torch.device
                    ) -> Tuple[int, int]:
    """(SMs, resident blocks an SM) of the extract_buckets kernel."""
    L, w = _profile("extract_buckets", curve)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = _build.library().msm_extract_buckets_limits(
            L, w, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError("extract_buckets: occupancy query failed "
                           f"(cudaError_t {rc})")
    per_sm, sms, threads, lanes = (v.value for v in out)
    if (threads, lanes) != (EXTRACT_THREADS, EXTRACT_LANES):
        raise RuntimeError(f"extract_buckets: the kernel has {threads} "
                           f"threads and {lanes} lanes a block, the wrapper "
                           f"{EXTRACT_THREADS} and {EXTRACT_LANES}")
    if per_sm < 1:
        raise RuntimeError("extract_buckets: no block of the kernel is "
                           "resident")
    return sms, per_sm


def extract_buckets(tbuf: torch.Tensor, s: torch.Tensor, cnt: torch.Tensor,
                    buckets: torch.Tensor, g: int, Wg: int, C: int, R: int,
                    curve: CurveParams) -> torch.Tensor:
    """Window group g's buckets, written into buckets[:, :, g Wg:(g+1) Wg]
    in place; returns `buckets`.

    tbuf: (3, L, R, F) int16 scan output of the group (F = Wg C); s: its
    exclusive column prefix, (3, L, Wg, C) or (3, L, F) int16; cnt: the
    (Wp, B+1) int32 counts of `bucket_sort` for every window; buckets:
    (3, L, Wp, B) int16. For each window w of the group and j = 0..B,
    G_j = T + S at the last position below cnt[w, j] (`boundary_lanes`),
    infinity where cnt == 0; bucket b = G_{b+1} - G_b, the subtrahend's
    y taken as 4p - y, as `psub_batch` computes it. The kernel keeps G
    in shared memory, its persistent blocks walking runs of 39 buckets
    (`extract_buckets_geometry`)."""
    L = curve.num_limbs
    F = Wg * C
    Wp = cnt.shape[0]
    B = cnt.shape[1] - 1
    if (tbuf.shape != (3, L, R, F) or s.numel() != 3 * L * F
            or cnt.dim() != 2 or buckets.shape != (3, L, Wp, B)
            or not 0 <= g < Wp // Wg or B < 1):
        raise ValueError(f"extract_buckets: shapes T {tuple(tbuf.shape)}, "
                         f"S {tuple(s.shape)}, cnt {tuple(cnt.shape)}, "
                         f"buckets {tuple(buckets.shape)} for g={g}, "
                         f"Wg={Wg}, C={C}, R={R}, L={L}")
    if not _on_cuda("extract_buckets", tbuf, s, cnt, buckets):
        return extract_buckets_plain(tbuf, s, cnt, buckets, g, Wg, C, R,
                                     curve)
    L, w = _profile("extract_buckets", curve)
    for t, dt, nd in ((tbuf, I16, 4), (cnt, I32, 2), (buckets, I16, 4)):
        _need("extract_buckets", t, dt, nd)
    if s.dtype != I16 or not s.is_contiguous():
        raise ValueError("extract_buckets: S must be contiguous int16")
    if R * F >> 31:
        raise ValueError("extract_buckets: the kernel takes fewer than "
                         "2^31 positions a group")
    geo = extract_buckets_geometry(
        Wg, B, *_extract_limits(curve, tbuf.device), L, w)
    rc = _build.library().msm_extract_buckets(
        L, w, tbuf.data_ptr(), s.data_ptr(), cnt.data_ptr(),
        buckets.data_ptr(), Wp, B, g * Wg, Wg, C, R, EXTRACT_THREADS,
        geo.blocks, _consts(curve, tbuf.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(tbuf))
    _check("extract_buckets", rc)
    LAUNCHED["extract_buckets"] = geo._asdict()
    return buckets


# ---------------------------------------------------------------------------
# 14. The XLA path's row walk
# ---------------------------------------------------------------------------


def smvp_rows_plain(pts_rows: torch.Tensor, pay: torch.Tensor,
                    skeys: torch.Tensor, curve: CurveParams, C: int, B: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    L = curve.num_limbs
    dev = pay.device
    Wg, n = pay.shape
    R = n // C
    perm = (pay >> 1).long()
    ssign = (pay & 1) != 0
    pts = pts_rows[perm].to(I32).movedim(-1, 0)                  # (2L,Wg,n)
    sy_all = torch.where(ssign, lazy.neg(pts[L:], curve, 2), pts[L:])

    # column-major: global position g = c R + r
    def rows_first(a):                          # (..., Wg, n) -> (R, ...)
        return a.reshape(a.shape[:-1] + (C, R)).movedim(-1, 0).contiguous()

    sx = rows_first(pts[:L])                                     # (R,L,Wg,C)
    sy = rows_first(sy_all)
    kt = rows_first(skeys.long())                                # (R,Wg,C)

    # run boundaries in global order: down each column, then the next
    first_next = torch.cat([kt[0, :, 1:], kt.new_full((Wg, 1), -1)], dim=-1)
    next_keys = torch.cat([kt[1:], first_next[None]])
    ends = kt != next_keys
    brk = torch.cat([torch.ones((1, Wg, C), dtype=torch.bool, device=dev),
                     kt[1:] != kt[:-1]])                         # run starts

    one_m = lazy.mont_one(curve, 2, dev)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    carry = complete.proj_infinity(curve, (Wg, C), dev)
    bucket = inf_stacked(curve, (Wg, B + 2), dev)            # + spare slot
    for r in range(R):
        summed = complete.pmadd(carry, sx[r], sy[r], curve)
        carry = complete.select(
            brk[r], complete.ProjPoint(sx[r], sy[r], one_m), summed)
        idx = torch.where(ends[r], kt[r], spare)
        bucket[:, :, w_idx, idx] = torch.stack(
            torch.broadcast_tensors(*carry))

    # the kernel writes no spare slot: infinity, as the wrapper fills it
    bucket[..., spare] = inf_stacked(curve, (Wg,), dev)
    return bucket, torch.stack(torch.broadcast_tensors(*carry))


SMVP_THREADS_PER_LANE = 6
"""Threads of a row-walk lane (csrc/smvp_rows.cu kG); a block is one warp
of 32 // 6 = 5 lanes."""
SMVP_LANES_PER_BLOCK = 32 // SMVP_THREADS_PER_LANE


class SmvpGeometry(NamedTuple):
    blocks: int               # a lane a column, one warp a block
    lanes_per_block: int
    shared_bytes: int


def smvp_rows_smem(num_limbs: int) -> int:
    """The dynamic shared bytes of a row-walk block: a pure function, so
    the CPU tests can hold it; the launch refuses a count other than its
    kernel's own (csrc/smvp_rows.cu `rows_smem_bytes`). A block is one
    warp of 5 lanes, each with a double buffer of its row (4 L bytes) and
    its state, 14 segments of L | 1 int32 words (csrc/scan_lane.cuh
    RunMem) padded to an odd count."""
    L = num_limbs
    if L < 1:
        raise ValueError(f"smvp_rows_smem: no block for L={L}")
    return SMVP_LANES_PER_BLOCK * (2 * 4 * L + 4 * (14 * (L | 1) | 1))


def smvp_rows_geometry(lanes: int, num_limbs: int = 22) -> SmvpGeometry:
    """One smvp_rows launch over `lanes` columns (Wg C) of `num_limbs`
    limbs: a pure function, so the CPU tests can hold it. A lane a
    column, 5 lanes a one-warp block; the launch refuses another count of
    blocks."""
    if min(lanes, num_limbs) < 1:
        raise ValueError("smvp_rows_geometry: lanes and num_limbs must be "
                         ">= 1")
    per_block = SMVP_LANES_PER_BLOCK
    return SmvpGeometry(-(-lanes // per_block), per_block,
                        smvp_rows_smem(num_limbs))


def smvp_rows(pts_rows: torch.Tensor, pay: torch.Tensor, skeys: torch.Tensor,
              curve: CurveParams, C: int, B: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row walk of `cuzk/smvp.bucket_accumulate` (the lax.fori_loop of
    tpu_msm/cuzk/smvp.py:94-110) on one window group.

    pts_rows: (n, 2L) int16 points-major table, row i = Montgomery
        (x limbs, y limbs) of point i.
    pay: (Wg, n) int32 payload idx << 1 | sign in each window's stable
        order by |d| (`bucket_sort`); skeys: (Wg, n) int32, the sorted
        keys |d| <= B beside it.
    Lane f = wl * C + c walks sorted positions c*R .. c*R + R-1 of window
    wl (R = n / C) with a complete mixed add a row, restarted with the
    point itself at each run of equal keys. Returns (bucket, trailing):
    bucket (3, L, Wg, B + 2) int32, slot k the sum of window wl's run of
    key k that ends in the walk's global order (infinity where none ends,
    and in the spare slot B + 1, which the caller's stitch writes into);
    trailing (3, L, Wg, C) int32, each lane's sum after its last row.
    `smvp_rows_geometry` picks the launch."""
    if curve.log_limb_size > 13:
        raise ValueError("smvp_rows: int16 rows need w <= 13")
    if (pay.dim() != 2 or skeys.shape != pay.shape or C < 1
            or pay.shape[1] % C or B < 1):
        raise ValueError(f"smvp_rows: pay {tuple(pay.shape)}, keys "
                         f"{tuple(skeys.shape)} for C={C}, B={B}")
    if not _on_cuda("smvp_rows", pts_rows, pay, skeys):
        return smvp_rows_plain(pts_rows, pay, skeys, curve, C, B)
    L, w = _profile("smvp_rows", curve)
    _need("smvp_rows", pts_rows, I16, 2)
    _need("smvp_rows", pay, I32, 2)
    _need("smvp_rows", skeys, I32, 2)
    Wg, n = pay.shape
    R = n // C
    geo = smvp_rows_geometry(Wg * C, L)
    if pts_rows.data_ptr() % prefix_scan_smem(L, 2).piece_bytes:
        raise ValueError("smvp_rows: the row table is not aligned to the "
                         "kernel's copy piece")
    bucket = inf_stacked(curve, (Wg, B + 2), pay.device)
    trailing = torch.empty((3, L, Wg, C), dtype=I32, device=pay.device)
    rc = _build.library().msm_smvp_rows(
        L, w, pts_rows.data_ptr(), pay.data_ptr(), skeys.data_ptr(),
        bucket.data_ptr(), trailing.data_ptr(), Wg, C, R, n, B + 2,
        geo.blocks, geo.shared_bytes,
        _consts(curve, pay.device).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(pay))
    _check("smvp_rows", rc)
    LAUNCHED["smvp_rows"] = geo._asdict()
    return bucket, trailing


# ---------------------------------------------------------------------------
# 15. The XLA path's cross-column stitch
# ---------------------------------------------------------------------------

Flagged = Tuple[torch.Tensor, torch.Tensor]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along the last axis (len(a) - len(b) in
    {0, 1})."""
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def associative_scan(combine: Callable[[Flagged, Flagged], Flagged],
                     elems: Flagged) -> Flagged:
    """Inclusive scan along the last axis of (points, flags) with the
    recursion of `jax.lax.associative_scan`: pairs are combined, the
    halved sequence is scanned, then the even positions are combined
    with the odd results. A non-commutative `combine` (a point sum under
    segment flags) then sees its operands in XLA's order, level by
    level."""
    pts, flags = elems
    m = pts.shape[-1]
    if m < 2:
        return elems
    odd = associative_scan(combine, combine(
        (pts[..., 0:-1:2], flags[..., 0:-1:2]),
        (pts[..., 1::2], flags[..., 1::2])))
    # at m == 2 XLA combines two empty slices; no combine runs here, and
    # the even part is the first element alone
    even = (pts[..., :1], flags[..., :1])
    if m > 2:
        left = odd if m % 2 else (odd[0][..., :-1], odd[1][..., :-1])
        rest = combine(left, (pts[..., 2::2], flags[..., 2::2]))
        even = (torch.cat([even[0], rest[0]], dim=-1),
                torch.cat([even[1], rest[1]], dim=-1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def smvp_stitch_plain(bucket: torch.Tensor, trailing: torch.Tensor,
                      skeys: torch.Tensor, curve: CurveParams, C: int
                      ) -> torch.Tensor:
    dev = bucket.device
    Wg, n = skeys.shape
    R = n // C
    B = bucket.shape[-1] - 2

    # each column's first and last key; keys are sorted, so a column
    # holds one run throughout where the two are equal
    kc = skeys.reshape(Wg, C, R).long()
    key_first, key_last = kc[..., 0], kc[..., -1]
    allsame = key_first == key_last                              # (Wg, C)
    w_idx = torch.arange(Wg, device=dev)[:, None]
    spare = B + 1

    no = torch.zeros((Wg, 1), dtype=torch.bool, device=dev)
    cont = torch.cat([no, key_last[:, :-1] == key_first[:, 1:]], dim=-1)

    def comb(a: Flagged, b: Flagged) -> Flagged:
        s = padd_batch_plain(a[0], b[0], curve)
        return torch.where(b[1], b[0], s), a[1] | b[1]

    scanned, _ = associative_scan(comb, (trailing, (~allsame) | (~cont)))
    # exclusive prefix: the trailing-chain sum arriving at column c
    P = torch.cat([inf_stacked(curve, (Wg, 1), dev),
                   scanned[..., :-1]], dim=-1)

    cont_next = torch.cat([cont[:, 1:], no], dim=-1)
    inject = cont & ((~allsame) | (~cont_next))
    cur = bucket[:, :, w_idx, key_first]
    fixed = padd_batch_plain(cur, P, curve)
    bucket[:, :, w_idx, torch.where(inject, key_first, spare)] = \
        torch.where(inject, fixed, cur)
    # the kernel writes no spare slot: infinity, as the row walk left it
    bucket[..., spare] = inf_stacked(curve, (Wg,), dev)
    return bucket


@functools.lru_cache(maxsize=None)
def smvp_stitch_levels(C: int) -> tuple:
    """`associative_scan` over C elements as in-place levels, in the
    order the kernel runs them: a tuple of levels, each a tuple of (a, b)
    positions, the level setting v[b] = combine(v[a], v[b]) at all its
    pairs at once (a < b; no level reads a position it writes).

    The recursion at depth j holds C >> j elements; element e lives at
    position (e + 1) 2^j - 1, where its right operand of depth j - 1
    lived. Going down (j = 0, 1, ... while C >> j >= 2) the pairs of
    depth j combine into depth j + 1: a = (2e + 1) 2^j - 1, b = (2e + 2)
    2^j - 1. Coming back up (j from the deepest, while C >> j >= 3) the
    even element 2e >= 2 of depth j takes the scanned depth-(j + 1)
    element e - 1 before it: a = e 2^(j+1) - 1, b = (2e + 1) 2^j - 1,
    whose value there is still depth j's; the odd elements are the
    depth-(j + 1) results already in place, element 0 stays as it is
    (and at C >> j == 2 there is nothing else)."""
    up, down = [], []
    j = 0
    while C >> j >= 2:
        m = C >> j
        up.append(tuple((((2 * e + 1) << j) - 1, ((2 * e + 2) << j) - 1)
                        for e in range(m // 2)))
        if m >= 3:
            down.append(tuple(((e << (j + 1)) - 1, ((2 * e + 1) << j) - 1)
                              for e in range(1, (m - 1) // 2 + 1)))
        j += 1
    return tuple(up + down[::-1])


@functools.lru_cache(maxsize=None)
def smvp_stitch_pairs(C: int) -> tuple:
    """Every pair of `smvp_stitch_levels(C)`, level by level, as the
    kernel reads it: (a, b, lo, level). [lo, b] are the columns whose
    trailing sums b's value holds at that level, lo = a + 1 (the
    recursion's element at depth j covers 2^j columns, and a's ends
    where b's begins; a >= 0, so column 0, always flagged, is never
    b's). b is flagged where one of those columns is, so, the keys of
    each window sorted, the pair adds exactly where k[lo R - 1] ==
    k[(b + 1) R - 1] (`stitch_pairs_add`)."""
    return tuple((a, b, a + 1, lv)
                 for lv, level in enumerate(smvp_stitch_levels(C))
                 for a, b in level)


def stitch_pairs_add(skeys: torch.Tensor, C: int) -> list:
    """Which pairs of each scan level of the stitch add on the (Wg, n)
    keys, sorted in each window (column c holds positions c R .. c R +
    R - 1): a (Wg, pairs of the level) bool tensor a level, by the
    closed form of `smvp_stitch_pairs`, as csrc/smvp_stitch.cu decides
    them; a pure function of the keys."""
    Wg, n = skeys.shape
    R = n // C
    table = torch.tensor(smvp_stitch_pairs(C), dtype=torch.int64,
                         device=skeys.device).reshape(-1, 4)
    out, p = [], 0
    for level in smvp_stitch_levels(C):
        t = table[p:p + len(level)]
        p += len(level)
        lo, b = t[:, 2], t[:, 1]
        out.append(skeys[:, lo * R - 1] == skeys[:, (b + 1) * R - 1])
    return out


def stitch_levels_that_add(skeys: torch.Tensor, C: int) -> Tuple[int, ...]:
    """The scan levels of the stitch that hold an add on these keys: the
    levels that csrc/smvp_stitch.cu runs, each behind a grid barrier."""
    return tuple(lv for lv, adds in enumerate(stitch_pairs_add(skeys, C))
                 if bool(adds.any()))


@functools.lru_cache(maxsize=None)
def _stitch_schedule(C: int, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`smvp_stitch_pairs(C)` on the device, as the kernel reads it: the
    (pairs, 4) int32 (a, b, lo, level) of every level in order, and each
    level's first pair, one more entry at the end (levels + 1 int32)."""
    levels = smvp_stitch_levels(C)
    starts = [0]
    for lv in levels:
        starts.append(starts[-1] + len(lv))
    pairs = torch.tensor(smvp_stitch_pairs(C), dtype=I32).reshape(-1, 4)
    return pairs.to(device), torch.tensor(starts, dtype=I32, device=device)


class StitchGeometry(NamedTuple):
    threads_per_lane: int
    lanes_per_block: int
    blocks: int
    items_per_lane: int
    levels: int
    threads: int
    shared_bytes: int
    pair_items: int
    pairs_per_thread: int


@functools.lru_cache(maxsize=256)
def smvp_stitch_geometry(Wg: int, C: int, sms: int, blocks_per_sm: int,
                         threads: int,
                         threads_per_lane: int = PADD_THREADS_PER_LANE,
                         num_limbs: int = 22, limb_bits: int = 12
                         ) -> StitchGeometry:
    """One smvp_stitch launch on Wg windows of C columns on a card of
    `sms` SMs that holds `blocks_per_sm` blocks of `threads` threads each
    (`msm_smvp_stitch_limits`): a pure function, so the CPU tests can
    hold it; cached, as the wrapper calls it a window group.

    An add is a lane of `threads_per_lane` threads of one warp (32 //
    threads_per_lane lanes a warp, its last threads idle), as in
    col_prefix, with 15 L + 1 int32 words of shared memory and two
    words of its item's positions. The widest level is the inject's,
    one item a column: Wg C items (the scan's first level has Wg
    floor(C / 2)). The kernel synchronises the whole grid between
    levels, so every block must be resident at once: never more than
    sms * blocks_per_sm blocks; with more items than lanes, a lane takes
    every (blocks * lanes_per_block)-th, `items_per_lane` at most.
    `levels` counts the scan's levels (`smvp_stitch_levels`), of which
    the kernel runs those with an add (`stitch_levels_that_add`). Before
    its first barrier every thread decides `pairs_per_thread` of the
    `pair_items` (Wg times the schedule's pairs), one key comparison
    each, and each block ORs the levels that add into a word of its
    own."""
    G = threads_per_lane
    if (min(Wg, C, sms, threads, G, num_limbs, limb_bits) < 1
            or blocks_per_sm < 1 or threads % 32 or G > 32):
        raise ValueError("smvp_stitch_geometry: no resident block "
                         f"(Wg={Wg}, C={C}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}, "
                         f"threads_per_lane={G})")
    lanes = (threads // 32) * (32 // G)
    total = Wg * C
    blocks = min(-(-total // lanes), sms * blocks_per_sm)
    shared = 4 * (lanes * ((15 * num_limbs | 1) + 2) + 2
                  + _static_shared_words(num_limbs, limb_bits))
    _fits_block("smvp_stitch_geometry", shared)
    items = Wg * len(smvp_stitch_pairs(C))
    return StitchGeometry(G, lanes, blocks, -(-total // (blocks * lanes)),
                          len(smvp_stitch_levels(C)), threads, shared,
                          items, -(-items // (blocks * threads)))


@functools.lru_cache(maxsize=None)
def _smvp_stitch_limits(curve: CurveParams, device: torch.device
                        ) -> Tuple[int, int, int, int]:
    """(SMs, resident blocks an SM, threads a block, threads an add) of
    the kernel."""
    L, w = _profile("smvp_stitch", curve)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        rc = _build.library().msm_smvp_stitch_limits(
            L, w, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError("smvp_stitch: occupancy query failed "
                           f"(cudaError_t {rc})")
    per_sm, sms, threads, per_lane = (v.value for v in out)
    return sms, per_sm, threads, per_lane


def smvp_stitch(bucket: torch.Tensor, trailing: torch.Tensor,
                skeys: torch.Tensor, curve: CurveParams, C: int
                ) -> torch.Tensor:
    """The cross-column stitch of `cuzk/smvp.bucket_accumulate` (the
    associative_scan and inject of tpu_msm/cuzk/smvp.py:112-155) on one
    window group, in place.

    bucket: (3, L, Wg, B + 2) int32, `smvp_rows`' buckets (slot B + 1
        the spare, at infinity); trailing: (3, L, Wg, C) int32, its
        lanes' trailing sums; skeys: (Wg, n) int32 sorted keys, n a
        multiple of C (column c holds positions c R .. c R + R - 1).
    A column whose first key equals the last key of the column before
    continues that column's run; the flagged inclusive scan of the
    trailing sums (a flag where a column does not continue, or holds
    more than one run), in XLA's tree and operand order, gives each
    column the sum P arriving at it, and the first run of each column
    that continues a run and ends in it (or holds more than one) gets
    bucket[w, first key] = padd(bucket[w, first key], P). Returns
    `bucket`, written in place; the spare slot stays infinity.
    `smvp_stitch_geometry` picks the launch; the kernel runs only the
    scan levels that hold an add (`stitch_levels_that_add`), and its
    block 0 writes those it ran as bits of a one-element int64 tensor,
    `LAUNCHED["smvp_stitch"]["ran_mask"]`."""
    if (bucket.dim() != 4 or trailing.dim() != 4 or skeys.dim() != 2
            or C < 1 or skeys.shape[1] % C or bucket.shape[3] < 2
            or trailing.shape != bucket.shape[:3] + (C,)
            or bucket.shape[:2] != (3, curve.num_limbs)
            or skeys.shape[0] != bucket.shape[2]):
        raise ValueError(f"smvp_stitch: bucket {tuple(bucket.shape)}, "
                         f"trailing {tuple(trailing.shape)}, keys "
                         f"{tuple(skeys.shape)} for C={C}")
    if not _on_cuda("smvp_stitch", bucket, trailing, skeys):
        return smvp_stitch_plain(bucket, trailing, skeys, curve, C)
    L, w = _profile("smvp_stitch", curve)
    _need("smvp_stitch", bucket, I32, 4)
    _need("smvp_stitch", trailing, I32, 4)
    _need("smvp_stitch", skeys, I32, 2)
    dev = bucket.device
    Wg, n = skeys.shape
    geo = smvp_stitch_geometry(Wg, C, *_smvp_stitch_limits(curve, dev), L, w)
    pairs, starts = _stitch_schedule(C, dev)
    scan = torch.empty_like(trailing)
    masks = torch.empty(geo.blocks + 1, dtype=torch.int64, device=dev)
    rc = _build.library().msm_smvp_stitch(
        L, w, bucket.data_ptr(), trailing.data_ptr(), skeys.data_ptr(),
        scan.data_ptr(), masks.data_ptr(), pairs.data_ptr(),
        starts.data_ptr(), Wg, C, n // C, bucket.shape[3], geo.levels,
        geo.threads_per_lane, geo.blocks, _consts(curve, dev).data_ptr(),
        ctypes.addressof(_wide_consts(curve)), _stream(bucket))
    _check("smvp_stitch", rc)
    launched = LAUNCHED["smvp_stitch"] = geo._asdict()
    launched["ran_mask"] = masks[-1:]
    return bucket

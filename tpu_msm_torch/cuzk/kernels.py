"""The nine MSM kernels: one wrapper each.

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

The first six are the main path (`pipeline_cuda.windows_device`);
`pbpr_stage1` and `pdbl_batch` serve the two-stage bucket reduction
(`cuzk/pbpr.py`), and `globalize` is the full-stream form of the G = T + S
step that the main path takes only at the bucket-region ends.

`psub_batch` is `padd_batch` of `pneg_stacked(q)`; on a CUDA tensor the
padd kernel negates q itself as it loads it. `pneg_stacked` and
`inf_stacked` stay plain torch, as the JAX package keeps them in XLA.
Stacked points are (3, L, *batch) tensors: coordinate, limb, lanes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import _build
from ..constants import CurveParams, int_to_limbs
from ..ops import rows

I16 = torch.int16
I32 = torch.int32
# Element widths the dtype-templated kernels are instantiated for.
_BITS = {I16: 16, I32: 32}

# Profiles the CUDA library is instantiated for: (num_limbs, limb bits).
CUDA_PROFILES = {(22, 12), (6, 12)}

LAUNCHES = {name: 0 for name in ("encode_mont", "decompose_digits",
                                 "prefix_scan", "col_prefix", "padd_batch",
                                 "pbpr_full", "pdbl_batch", "pbpr_stage1",
                                 "globalize")}
"""Kernel launches per wrapper, counted where the CUDA kernel launches."""

LAUNCHED = {}
"""The geometry that the last launch of `prefix_scan`, `col_prefix`,
`padd_batch`, `pbpr_full`, `pbpr_stage1` and `globalize` passed to its
kernel, written where the kernel launches."""


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
    words. Refuses a profile the word-wide multiply cannot take: L w a
    multiple of 32 (no last partial step) or p too wide for the words."""
    bits = curve.num_limbs * curve.log_limb_size
    nf, n = bits // 32, -(-bits // 32)
    if bits % 32 == 0 or curve.p >> (32 * nf):
        raise ValueError(f"{curve.name}: the word-wide multiply needs L*w "
                         "not a multiple of 32 and p < 2^(32 floor(L*w/32))")
    words = lambda v, k: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(k)]
    n0 = -pow(curve.p, -1, 1 << 32) % (1 << 32)
    return words(curve.p, nf) + [n0] + words(curve.r2_mod_p, n)


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


def inf_stacked(curve: CurveParams, batch_shape, device="cpu") -> torch.Tensor:
    """(3, L, *batch) stacked infinity (0 : 1m : 0), canonical limbs."""
    L = curve.num_limbs
    shape = (L,) + tuple(batch_shape)
    out = torch.zeros((3,) + shape, dtype=I32, device=device)
    one = torch.tensor(int_to_limbs(curve.r_mod_p, L, curve.log_limb_size),
                       dtype=I32, device=device)
    out[1] = one.reshape((L,) + (1,) * len(batch_shape))
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


# ---------------------------------------------------------------------------
# 2. Signed-digit decomposition
# ---------------------------------------------------------------------------


def decompose_digits_plain(halfwords: torch.Tensor, s: int, W: int
                           ) -> torch.Tensor:
    H = halfwords.shape[0]
    mask, full, half = (1 << s) - 1, 1 << s, 1 << (s - 1)
    out = torch.empty((W,) + halfwords.shape[1:], dtype=I16,
                      device=halfwords.device)
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


def decompose_digits(halfwords: torch.Tensor, s: int, W: int) -> torch.Tensor:
    """(H, n) int32 16-bit halfwords -> (W, n) int16 signed digits in
    [-2^(s-1), 2^(s-1)), carry-chained across windows."""
    if not _on_cuda("decompose_digits", halfwords):
        return decompose_digits_plain(halfwords, s, W)
    _need("decompose_digits", halfwords, I32, 2)
    H, n = halfwords.shape
    if (W - 1) * s // 16 >= H:
        raise ValueError("decompose_digits: too few halfwords for W windows")
    out = torch.empty((W, n), dtype=I16, device=halfwords.device)
    rc = _build.library().msm_decompose_digits(
        halfwords.data_ptr(), out.data_ptr(), H, n, s, W,
        _stream(halfwords))
    _check("decompose_digits", rc)
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
"""Threads a block of the scan kernel (csrc/prefix_scan.cu kThreads)."""
SCAN_THREADS_PER_LANE = (2, 6)
"""The values of G the scan kernel is built for."""


def prefix_scan_geometry(lanes: int, sms: int, threads_per_lane=None
                         ) -> Tuple[int, int, int]:
    """(G, blocks, lanes a block) of one scan launch over `lanes` lanes on
    a card of `sms` SMs: a pure function, so the CPU tests can hold it.

    G threads of one warp share a lane (32 // G lanes a warp; with G = 6
    the last two threads of a warp idle), so a block of four warps holds
    64 lanes with G = 2 and 20 with G = 6. On the H100 the time of a
    launch goes up in steps with the blocks an SM gets, each block one
    more warp on each of its four schedulers (PERF.md, `[scan-lanes]`):
    by the whole of G = 2's time for each of its blocks, by about a
    quarter of that for each of G = 6's. The rule: G = 6, which has the
    shorter step (two multiplies deep) and the higher rate on a full
    card; but G = 2 where its blocks come one to an SM while G = 6 would
    need more than two to an SM. Measured on 132 SMs about both edges
    (5,280 and 8,448 lanes): G = 2 is level with G = 6 from 5,281 to
    7,920 lanes (three blocks of G = 6 an SM) and a fifth faster from
    there to 8,448 (four). `threads_per_lane` names G outright: for a
    measurement of one G against the other, not for the MSM."""
    if lanes < 1 or sms < 1:
        raise ValueError("prefix_scan_geometry: lanes and sms must be >= 1")
    per_block = lambda G: (SCAN_THREADS // 32) * (32 // G)
    blocks = lambda G: -(-lanes // per_block(G))
    if threads_per_lane is None:
        G = 2 if blocks(2) <= sms and blocks(6) > 2 * sms else 6
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
    if pts_rows.data_ptr() % 8:
        raise ValueError("prefix_scan: the row table must be 8-byte aligned")
    Wg, n = pay.shape
    R = n // C
    sms = torch.cuda.get_device_properties(pay.device).multi_processor_count
    G, _, _ = prefix_scan_geometry(Wg * C, sms, _threads_per_lane)
    out = torch.empty((3, L, R, Wg * C), dtype=I16, device=pay.device)
    rc = _build.library().msm_prefix_scan(
        L, w, pts_rows.data_ptr(), pay.data_ptr(), out.data_ptr(), Wg, C, R,
        n, G,
        _consts(curve, pay.device).data_ptr(), _stream(pay))
    _check("prefix_scan", rc)
    LAUNCHED["prefix_scan"] = dict(threads_per_lane=G)
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


def col_prefix_geometry(Wg: int, C: int, sms: int, blocks_per_sm: int,
                        threads: int) -> Tuple[int, int]:
    """(blocks, columns a thread) of one col_prefix launch: a pure
    function, so the CPU tests can hold it.

    The kernel runs one thread per (window, column) and synchronises the
    whole grid between levels, so every block must be resident at once:
    never more than sms * blocks_per_sm blocks. With more columns than
    that many threads, thread t takes columns t, t + blocks * threads,
    ..."""
    if min(Wg, C, sms, threads) < 1 or blocks_per_sm < 1:
        raise ValueError("col_prefix_geometry: no resident block "
                         f"(Wg={Wg}, C={C}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads})")
    blocks = min(-(-Wg * C // threads), sms * blocks_per_sm)
    return blocks, -(-Wg * C // (blocks * threads))


@functools.lru_cache(maxsize=None)
def _col_prefix_limits(curve: CurveParams, device: torch.device
                       ) -> Tuple[int, int, int]:
    """(SMs, resident blocks an SM, threads a block) of the kernel."""
    L, w = _profile("col_prefix", curve)
    per_sm, sms, threads = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().msm_col_prefix_limits(
            L, w, ctypes.byref(per_sm), ctypes.byref(sms),
            ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError("col_prefix: occupancy query failed "
                           f"(cudaError_t {rc})")
    return sms.value, per_sm.value, threads.value


def col_prefix(coltot: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """(3, L, Wg, C) int16 column totals -> (3, L, Wg, C) int16 EXCLUSIVE
    prefix points along the last axis (S[c] = sum of columns < c)."""
    if not _on_cuda("col_prefix", coltot):
        return col_prefix_plain(coltot, curve)
    L, w = _profile("col_prefix", curve)
    _need("col_prefix", coltot, I16, 4)
    _, _, Wg, C = coltot.shape
    blocks, per_thread = col_prefix_geometry(
        Wg, C, *_col_prefix_limits(curve, coltot.device))
    out = torch.empty_like(coltot)
    scratch = torch.empty_like(coltot)
    rc = _build.library().msm_col_prefix(
        L, w, coltot.data_ptr(), out.data_ptr(), scratch.data_ptr(), Wg, C,
        _levels(C), blocks,
        _consts(curve, coltot.device).data_ptr(), _stream(coltot))
    _check("col_prefix", rc)
    LAUNCHED["col_prefix"] = dict(blocks=blocks, columns_per_thread=per_thread)
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
    return PaddGeometry(G, warps, lanes, -(-F // lanes), 32 * warps, shared)


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


def pbpr_full_geometry(Wp: int, B: int, T: int, sms: int,
                       blocks_per_sm: int, threads: int,
                       threads_per_add: int) -> Tuple[int, int, int]:
    """(stage-1 blocks, scan blocks, adds a chain) of one pbpr_full call:
    a pure function, so the CPU tests can hold it.

    Stage 1 gives each of the Wp * T lanes 2 * threads_per_add threads of
    one warp (the m add and the g add run at once): an ordinary launch of
    as many one-warp blocks as that takes. The scans and the
    tail are one cooperative launch, so every block must be resident at
    once: never more than sms * blocks_per_sm blocks of threads /
    threads_per_add add chains. Chain c of a level takes adds c,
    c + chains, ... of it (the widest level is phase A's first; with
    T = 1 the tail's Wp)."""
    G = threads_per_add
    if (min(Wp, B, T, sms, blocks_per_sm, G) < 1 or B % T
            or threads % 32 or 32 % (2 * G)):
        raise ValueError("pbpr_full_geometry: no launch for "
                         f"(Wp={Wp}, B={B}, T={T}, sms={sms}, "
                         f"blocks_per_sm={blocks_per_sm}, threads={threads}, "
                         f"threads_per_add={G})")
    chains_per_block = threads // G
    stage1 = -(-Wp * T // (32 // (2 * G)))
    widest = max([Wp * (T // sm + T // sg)
                  for _, sm, sg in pbpr_scan_levels(T)] + [Wp])
    scan = min(-(-widest // chains_per_block), sms * blocks_per_sm)
    return stage1, scan, -(-widest // (scan * chains_per_block))


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
    if buckets.data_ptr() % 4:
        raise ValueError("pbpr_full: the buckets must be 4-byte aligned")
    sms, per_sm, nthreads, G = _pbpr_full_limits(curve, buckets.device)
    stage1, scan, per_chain = pbpr_full_geometry(
        Wp, B, T, sms, per_sm, nthreads, G)
    levels = _pbpr_levels(T, buckets.device)
    out = torch.empty((3, L, Wp), dtype=I32, device=buckets.device)
    xchg = torch.empty((2, 3, L, 2 * Wp * T), dtype=I16,
                       device=buckets.device)
    rc = _build.library().msm_pbpr_full(
        L, w, buckets.data_ptr(), out.data_ptr(), xchg.data_ptr(),
        levels.data_ptr(), levels.numel() // 3, Wp, B, T, stage1, scan,
        _consts(curve, buckets.device).data_ptr(), _stream(buckets))
    _check("pbpr_full", rc)
    LAUNCHED["pbpr_full"] = dict(stage1_blocks=stage1, scan_blocks=scan,
                                 threads_per_add=G, adds_per_chain=per_chain)
    return out


# ---------------------------------------------------------------------------
# 7. Batched complete doubling
# ---------------------------------------------------------------------------


def pdbl_batch_plain(p: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    return _stack(rows.pdbl_rows(_unstack(p), curve))


def pdbl_batch(p: torch.Tensor, curve: CurveParams) -> torch.Tensor:
    """Complete projective doubling on a stacked (3, L, *batch) int32 lazy
    point batch (values < 4p); returns the same shape in int32."""
    if not _on_cuda("pdbl_batch", p):
        return pdbl_batch_plain(p, curve)
    L, w = _profile("pdbl_batch", curve)
    if p.dtype != I32 or p.dim() < 2:
        raise ValueError("pdbl_batch: expected a (3, L, *batch) int32 tensor, "
                         f"got {p.dtype} {tuple(p.shape)}")
    p = p.contiguous()
    out = torch.empty_like(p)
    rc = _build.library().msm_pdbl_batch(
        L, w, p.data_ptr(), out.data_ptr(), p[0, 0].numel(),
        _consts(curve, p.device).data_ptr(), _stream(p))
    _check("pdbl_batch", rc)
    return out


# ---------------------------------------------------------------------------
# 8. Bucket reduction, stage 1 alone
# ---------------------------------------------------------------------------


PBPR_STAGE1_THREADS_PER_CHAIN = 6
"""Threads of a warp that share each of a lane's two add chains in the
stage-1 kernel (csrc/padd_lane.cuh kAddG); a lane is twice as many."""
PBPR_STAGE1_MAX_WARPS = 4
"""Warps a block of the stage-1 kernel at most (csrc/pbpr_stage1.cu
kMaxWarps)."""
PBPR_STAGE1_REGISTERS = 64
"""Registers a thread of the stage-1 kernel at most (csrc/pbpr_stage1.cu
kRegisters, held by its __launch_bounds__)."""

# What an SM of the H100 holds at once (compute capability 9.0): the
# residency that pbpr_stage1_geometry reckons with.
SM_SHARED_BYTES = 233_472         # 228 KB of shared memory
BLOCK_SHARED_BYTES = 232_448      # 227 KB a block at most
BLOCK_RESERVED_SHARED = 1_024     # taken by the system for each block
SM_BLOCKS, SM_WARPS, SM_REGISTERS = 32, 64, 65_536


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
    int32 words in shared memory (csrc/pbpr_stage1.cu LaneMem), beside
    the block's copies of `Consts<L>` and `WideConsts<L, w>`. A lane is a
    chain of Bt + 1 steps, so the launch takes as many waves of blocks as
    the card needs to hold every lane once: the blocks an SM holds are
    bounded by its shared memory (each block also takes
    BLOCK_RESERVED_SHARED), its registers (PBPR_STAGE1_REGISTERS a
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
                     SM_REGISTERS // (PBPR_STAGE1_REGISTERS * 32 * warps),
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

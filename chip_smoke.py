#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. print the card's name and power limit; require CUDA;
  2. build the kernels of tpu_msm_torch/csrc (timed as set-up); print
     what ptxas said of the redesigned kernels at BN254_S12 and at every
     profile of PROFILES (`[ptxas]`: registers, stack frame, spills)
     and, for the eight on the word-wide multiply and for every form of
     `decompose_digits`, their instructions by kind from cuobjdump -sass
     (`[sass]`), and the multiply's own
     (`msm::mul_wide` in prefix_scan's object; `encode_mont` inlines it)
     beside the parent's counts before its rows were carry chains;
  3. per kernel, at the shapes its path gives it for BN254_S12 at 2^16
     and 2^20 (captured from a warm-up run of the device program on the
     wire dtypes, int16 limbs and uint16 halfwords, without GLV and with
     it; `col_prefix` on the scan output in place, the captured view's
     strides kept; `encode_mont`, off the path, on the int32
     x limbs): the CUDA kernel against its plain PyTorch version
     on the same CUDA inputs, bit-identical, with times from CUDA events
     (a kernel under QUEUE_BELOW_MS back to back is timed again queued
     behind a busy call, which leaves out its wrapper's host cost; both
     times are printed; the nine kernels on the word-wide multiply,
     `encode_mont`, `prefix_scan`, `col_prefix`, `padd_batch`,
     `pdbl_batch`, `pbpr_stage1`, `globalize`, `pbpr_full` and
     `extract_buckets`, also print their bound by the 12-bit multiply's
     count, mont_mul_ops, beside their own).
     The seven kernels of the main path at both configurations
     (`extract_buckets` on the first window group, the whole bucket
     tensor compared); `padd_batch` and `psub_batch` (the padd kernel
     negating q on load; against its own plain version, `padd_batch` of
     `pneg_stacked`) at the shapes of the stage-3 chain that
     `extract_buckets` replaced, run on the first group after the
     capture; `[yardstick]`: `bucket_sort` beside torch.sort (stable,
     by |d|) and the stage-2 chain it replaced, `extract_buckets` beside
     the nine launches it replaced, on the same inputs;
     `pbpr_stage1` on the buckets `pbpr_full` received; `pdbl_batch` on
     one (3, L, Wg, B+1) batch and on the (3, L, Wp) sum that
     `bucket_reduce` doubles; `globalize` on the first window group's
     scan output and column prefix; `prefix_scan` once more for every
     number of threads per lane its launcher can pick, bit-identical to
     the first and timed (`[scan-G]`); `decompose_digits` beside a
     PyTorch copy of the same bytes (its `[kernel]` line); and, at 2^16,
     both redesigned
     kernels at shapes the two sizes do not reach (`[edge]`):
     `bucket_sort` on all-zero digits, every digit equal, one point,
     +-2^(s-1) in a partial last tile, s = 8 (one pass), s = 16 at
     +-2^15 and a shard of the windows; `extract_buckets` with cnt == 0
     lanes (j = 0, a window, a run's halo) and cnt == n lanes, at the
     last group and with a last run of one bucket a window; with the
     `[kernel]` lines of both, `[occupancy]`: each of their kernels'
     blocks, the blocks an SM holds (from [ptxas] and the launch
     geometry) and its waves, and the sort's launches a call; `col_prefix`
     at (Wg, C) = (1, 1), (3, 32), (4, 2048) with half the columns at
     infinity, equal neighbours and a column followed by its negative,
     (5, 64) with int16 limbs at both ends of the ledger, and (16, 8192),
     more columns than resident lanes; `prefix_scan` at R = 1 and at 111
     lanes with a point twice in a row and a point followed by its
     negative (the running sum through infinity and on from it), and at
     111 lanes with row limbs at both ends of the ledger, for every
     number of threads per lane and the launcher's pick;
     `padd_batch` and `psub_batch` at F = 1, 37 and 333 with infinity on
     either side, P + P, P + (-P) and int16 limbs at the ends of the
     ledger, and `encode_mont` on 0, 1 and p - 1; `encode_rows` on 0, 1,
     p - 1 (int32 and int16), 1, 127, 129 and 1,000 lanes and a slice of
     the wire's columns, `decompose_digits` on uint16, int32 and sliced
     halfwords, 1, 127 and 129 lanes of each and of a slice at an odd
     column, at s = 13 (20 windows) and s = 16, with three zero rows;
     `pbpr_stage1` at (Wp, B, T) = STAGE1_EDGES (T = 1 with an odd lane
     count, T = B, a slice of 3 buckets) with infinity and P + P in the
     chains, int16 and int32 buckets; `globalize` at (R, F) =
     GLOBALIZE_EDGES (F = 1, R = 1, F no multiple of a block's lanes) with
     S = T (P + P), S = -T (P + (-P)) and S at infinity, every dtype pair;
     `pdbl_batch` at F = 1, 7, 8, 9 (about the 8 lanes of a warp) and 16,
     on all-infinity lanes and on limbs at the ends of the ledger;
     at 2^20, `pbpr_full` at PBPR_EDGES (T = 1, T = B, T = 1024 and 2048,
     one window, B = 2^15 with T = 32), with the geometry it launched
     (the narrow ones are held against plain versions run on the CPU
     after every timed phase, so that they share the host with no timing);
  4. the two-stage reduction path: `pbpr.bucket_reduce` on the same
     buckets, equal in the group to `pbpr_full` window by window, its
     launch counts reset before and read after: two `pbpr_stage1`
     (stage 1, and stage 2 as one launch), log2 T + 1 `padd_batch`;
  5. the globalisation check: `globalize(T, S)` at the bucket-region ends
     of the first window group (from `bucket_sort`'s counts),
     bit-identical to the stage-3 chain's G, and the buckets made from it
     bit-identical to those the main path's `extract_buckets` wrote;
  6. the main path, `tpu_variable_base_msm` on the card, at 2^16 and 2^20
     with inputs from gen_planar_inputs(seed=99, k_base=64): EXACT against
     the O(k_base) linearity oracle, every kernel's launch count reset
     before and read after; then the median of 3 timed runs of
     window_sums + host Horner on staged inputs, h2d timed apart;
  7. the GLV path: the same call with the default schedule and glv=True,
     on the same inputs, EXACT against the same oracle, counted and timed
     the same way (stage 1 two launches: `encode_rows` and
     `decompose_digits`, under GLV `glv_apply` and `decompose_digits`;
     `encode_mont` none); before it, at 2^16 and 2^20 (`[apply_glv]`),
     `glv_apply`'s rows form (`glv_rows`, the wire limbs encoded in the
     kernel) against its plain version on stage 1's inputs with the edge
     scalars (0, 1,
     r - 1, 2^15, lambda, r - lambda, +-max_abs, k1, k2 or both negative)
     in the first lanes, each edge lane also against the python-int
     split, the digits of the one `decompose_digits` against the plain
     version's, and `apply_glv` timed whole; then (`[schedule]`) the
     largest size once more under SCHEDULE, a window group of 16 that
     gives the scan 131,072 lanes and `col_prefix` several columns a
     thread, EXACT, recorded and not made the default; and (`[latency]`)
     one `padd_batch` on 32 lanes, one `pdbl_batch` on 16 lanes, one
     `col_prefix` level, one scan step and one doubling on a single
     warp, one `pbpr_full` stage-1 step, scan level and doubling of its
     tail, and one `pbpr_stage1` step, on one window, from which the
     depth floors of `col_prefix`, `prefix_scan`, `pbpr_full`,
     `pbpr_stage1` and `pdbl_batch` on 16 lanes follow; one
     `to_affine` on one point (the root's chain and 3 multiplies, which
     with a multiply a tree level give the depth floors of `to_affine`
     and `batch_inverse`); one row of `smvp_rows`' lane, from one column
     of one run at R = 64 and 128; and one
     `extract_buckets` run (39 buckets of one window on one block), its
     two dependent adds, the depth floor of a launch; and one
     `smvp_stitch` level, from one window of 2 and of 256 columns;
     and (`[scan-lanes]`) `prefix_scan` alone at 2,048 to 131,072 lanes
     (LANE_SHAPES), for every number of threads per lane, at BN254_S12
     here and at PROFILE_FULL in phase 9: what the launcher's rule of
     threads per lane rests on;
  8. affine output: `to_affine` on the window sums of the 2^16 runs
     (without GLV, and with it, where two pad windows are at infinity),
     one launch, against the host decode; the kernel against its plain
     version on the window sums with four lanes of Z = 0, p, 2p and 3p,
     int32 and int16, timed, and `batch_inverse` on the window sums' Z
     plane against its plain version; then at full width (`affine_full`),
     K = 2^20 - 3 projective points made on the card (the inputs'
     affine points in Montgomery form times a random Z, lanes of Z = 0,
     p, 2p, 3p about the tree's block boundaries): `to_affine`'s user
     call with every launch count set to 0 just before and read just
     after (the three launches of `batch_inverse_geometry`, nothing
     else), equal to the known affine points, infinity exactly at the
     edge lanes; bit-identical to `to_affine_plain`, run once, int32 and
     int16, timed; `batch_inverse` on the Z plane (the edge lanes 0 and
     p), counted the same way, bit-identical to the plain
     `batch_inverse`, run once, zero at the edges and z^-1 z = 1
     elsewhere, timed, and its three launches timed one at a time (up,
     top with the root's chain, down; `tree_split`) and on one element;
     then (`[rest]`) one real window_sums +
     host Horner at 2^16 and 2^20 under torch.profiler: the device time
     of the PyTorch ops outside the port's kernels, op by op and by input
     shape, beside the kernels' own, and the d2h, decode and Horner on the
     host clock; it fails if a PyTorch op with device time read a tensor
     with an axis as long as the stream's lanes; then (`[large]`,
     `large_phase`) BN254_S12 at 2^22 in one pass and 2^24 in four on the
     static schedule, window_sums + Horner on wire inputs on the card,
     EXACT, counted, `encode_rows`, `decompose_digits` and `col_prefix`
     at 2^22 against their plain versions, timed, with the peak device
     memory;
  9. every profile of PROFILES (`run_profile`: BLS12_377_S12 at 2^16
     and 2^20, BN254_S13 and BLS12_377_S13 at 2^16, each with its own
     inputs from gen_planar_inputs(seed=99, k_base=64)): at each size
     the nine kernels against their plain versions on the shapes its run
     gives them, timed against their bounds, the scan for both numbers
     of threads per lane, the reduction and globalisation checks,
     `[apply_glv]`; the
     MSM EXACT at each size, counted and timed; for BLS12_377_S12 also
     the GLV MSM, to_affine (on the window sums, and `affine_full` at
     K = 2^16 - 3 with batch_inverse), the [latency] line and the
     [scan-lanes] sweep; a [where] line for each size;
 10. `[sharded]`, the multi-device MSM (`tpu_msm_torch/parallel/sharded.py`)
     on BN254_S12 at 2^20, the same inputs, EXACT against the same
     oracle: (1) `windows_device` at w = 2 and 4 window shards, every
     w_index, in one process: the shards concatenated decode to the
     unsharded window sums; `pbpr_full` launched at Wp_l = 8 and 4 as
     `pbpr_full_geometry` says; on the first shard at w = 4, `pbpr_full`
     and the first group's `prefix_scan`, `col_prefix`, `padd_batch` and
     `psub_batch` against their plain versions, timed; each shard timed;
     before the spawns, the kernels of the gloo ranks' paths, each call
     of rank 0's span (n / x points, the 2^20 schedule) at its first
     window shard against its plain version; `_reduce_gathered` on the
     window sums of two and of four spans, bit-identical to the tree of
     plain adds, each level's `padd_batch` against its plain version;
     (2) `sharded_msm` on a mesh (1,) of one NCCL rank, counted, then
     `sharded.exchange` timed on its own; (3) meshes x = 2 and
     (x = 2, w = 2) of 2 and 4 ranks spawned on this one card over gloo
     (`parallel.spawn.run_ranks`), the inputs handed over in .npy
     files: every rank EXACT and counted, its window_sums and, on its
     own after a barrier, its exchange + tree timed (ranks sharing one
     card: no multi-GPU scaling); a rank that fails or misses its
     deadline fails the run; (4) the XLA path (backend="xla") at 2^16
     over x = 2 gloo ranks spawned on the card: every rank EXACT, one
     `smvp_rows` and one `smvp_stitch` launch a window group of its span,
     its window sums equal (decoded) to the unsharded twin's and its
     span's sums before the exchange bit-identical to this process's;
 11. `[twin]`, the XLA path (`MSMConfig(backend="xla")`, the port of the
     JAX package's `_windows_device`: decompose, `bucket_sort`, the row
     walk of `smvp_rows`, the stitch, `bucket_reduce`) through
     `tpu_variable_base_msm` on the card, with inputs from
     gen_planar_inputs(seed=99, k_base=64), at the default schedule:
     BN254_S12 at 2^16 without GLV and with it, BLS12_377_S12 at 2^14
     and BN254_S12 at 2^20 (TWIN_RUNS): each EXACT against the oracle
     with every launch count reset before and read after (the eight
     kernels of the path launched, every other idle; one `smvp_stitch`
     a window group, and log2 T + 1 `padd_batch`), its window sums
     equal window by window after decoding to the CUDA path's on the
     same inputs; every call of `encode_mont`, `decompose_digits`,
     `bucket_sort`, `smvp_rows` and `smvp_stitch` (the first group's),
     `padd_batch` (the reduction's tree and last add), `pbpr_stage1`
     (stage 1) and `pdbl_batch`, once per shape, against its plain
     version, timed (`[stitch]`: the stitch's time a group, its launches and
     depth floor, of its scan levels those it ran as the kernel reports
     them, held equal to the closed form's and the carried flags' levels
     with an add, and its grid barriers; `[rows]`: the row walk's time a
     group, its launch, the longest run inside one column and the depth
     floor that run gives, beside the floor of R scan steps); the
     stage-2 launch of
     `pbpr_stage1` (threads = 1) against the 2 (T - 1) `padd_batch`
     launches it replaced, bit for bit, both timed, and against its plain
     version in the first run (T = 256, the twin's smallest); the median of
     3 timed runs and its split into the kernels' time (each shape's time
     by its calls) and the rest (`[twin-where]`); then `[edge]
     smvp_stitch` at STITCH_EDGES (C = 1001, odd, with n below the
     columns; C = 2 and 1), with random digits, every key equal, every
     column its own run and every digit 0, against its plain version,
     the levels it ran held as in `[stitch]`, and `smvp_rows` on the
     same keys, on runs of ROW_RUNS rows (over columns) and with keys -1
     and B + 1, against its plain version;
 12. the `pbpr_full` edges whose plain versions ran on the CPU, in two
     processes of one thread started after phase 8 (so the host-clock
     times of phases 9 to 11 share the host with them);
 13. `[autotune]`: `utils/window.autotune` on BN254_S12 at 2^16 (the
     model's 36 candidates and the static default) and 2^20 (its 24,
     the static default and SCHEDULE), runs=2, on inputs on the card,
     into the run's own cache file (main() points the cache's
     environment variable at a temporary file for the whole run, so no
     earlier phase reads a tuned schedule): each candidate's median, the
     winner beside the static default, the sweep's launches counted;
     `default_config` gives the winner while the cache is set (each
     winner EXACT through `tpu_variable_base_msm`) and the static
     schedule once it is not;
 14. `[profile]`: in a fresh process (torch.profiler loses the first
     kernel records of every later session of a process),
     `utils/profiling.trace` around one 2^16 `tpu_variable_base_msm`
     (counted, EXACT), whose Chrome trace must name the seven kernels of
     the main path (`bucket_sort` by its three kernels: the upsweep, the
     counts and the pass); `device_ms` of `apply_glv` and of `to_affine` alone
     at 2^16, each with the device time of its kernels read from its own
     trace, and each trace's launches without a kernel record; then a
     StageTimer table of pack, window_sums and Horner;
 15. `[cpu-msm]`: `host/cpu_msm` built with g++ from native/cpumsm.cpp
     into the build directory, EXACT against the oracle on BN254_S12 and
     BLS12_377_S12 at n = 4,096, and `mont_throughput`;
 16. `[multipass]`: 2^21 points of gen_planar_inputs(seed=99,
     k_base=64) under max_points_per_pass = 2^20 (several passes, the
     side copy stream live), without GLV (2 passes) and with it (4: GLV
     halves the pass), counted: each EXACT against the oracle and equal
     to `cpu_msm` on the same points and scalars (u64 words built from
     the planar limbs);
 17. `[service]`: `app/service.serve(port=0, background=True)` on the
     card: one loopback request at 2^16 on BN254_S12 (counted, EXACT),
     two clients at once (BN254_S12 and BLS12_377_S12, both EXACT), one
     off-curve request that must get the error frame; wall times and
     the server's compute_ms;
 18. `[where]` and `[rest]` lines, then one JSON line {"kernels": [...]}
    with all seventeen kernels (`encode_rows` with its
    2^22 numbers as `_2p22`; to_affine and batch_inverse with their
    user calls at K = 2^20 - 3, to_affine also on the window sums;
    pbpr_full with the geometry the user call
    launched, from kernels.LAUNCHED; `bucket_sort` with torch.sort's time
    as library_ms and both new kernels with their chains' as chain_ms;
    under "profiles" each kernel's
    time, bound, launches and error at each profile of PROFILES; the seven
    of the main path with their launches on the sharded path and their
    largest error against the plain version there, padd_batch its main
    path's launches (0 since PR 15) and its halving tree's; the seven of
    the twin its launches, time and error at each of TWIN_RUNS;
    `smvp_rows` and `smvp_stitch` from the twin's 2^20 and 2^16 runs,
    with their depth floors, the stitch with the levels it ran and its
    grid barriers; `decompose_digits` with its launch and the copy of
    the same bytes) and the `[sharded]` and `[twin]`
    numbers under "sharded" and "twin", those of phases 13 to 17 under
    their names, and each main-path kernel's launches on their paths;
 19. last line {"ok": true, "device": {...}}.
"""

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import datetime
import json
import math
import multiprocessing
import os
import random
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpu_msm_torch import _build, batch_inverse, to_affine  # noqa: E402
from tpu_msm_torch.app import protocol as app_protocol  # noqa: E402
from tpu_msm_torch.app import service as app_service  # noqa: E402
from tpu_msm_torch.config import (MSMConfig, default_config,  # noqa: E402
                                  static_config)
from tpu_msm_torch.constants import (BLS12_377_S12,  # noqa: E402
                                     BLS12_377_S13, BN254_S12, BN254_S13,
                                     int_to_limbs)
from tpu_msm_torch.cuzk import glv as glv_dev  # noqa: E402
from tpu_msm_torch.cuzk import kernels  # noqa: E402
from tpu_msm_torch.cuzk import pbpr  # noqa: E402
from tpu_msm_torch.cuzk import pipeline  # noqa: E402
from tpu_msm_torch.cuzk import pipeline_cuda  # noqa: E402
from tpu_msm_torch.cuzk.pipeline import (get_pipeline,  # noqa: E402
                                         tpu_variable_base_msm)
from tpu_msm_torch.host import cpu_msm  # noqa: E402
from tpu_msm_torch.ops import inverse, rows  # noqa: E402
from tpu_msm_torch.parallel import sharded, spawn  # noqa: E402
from tpu_msm_torch.reference import curve as ref  # noqa: E402
from tpu_msm_torch.utils import preprocess, profiling, window  # noqa: E402

CURVE = BN254_S12   # the profile of phases 3 to 8
SIZES = (16, 20)
# The profiles beyond BN254_S12 that the script drives through the main
# path (`run_profile`), each at its sizes: at every size each kernel is
# held against its plain version and timed, and the reduction and
# globalisation paths run. PROFILE_FULL also runs GLV, to_affine and
# batch_inverse.
PROFILES = ((BLS12_377_S12, (16, 20)), (BN254_S13, (16,)),
            (BLS12_377_S13, (16,)))
PROFILE_FULL = BLS12_377_S12
DEVICE = "cuda"   # a rehearsal without a card sets "cpu" and tiny SIZES
MAIN = ("encode_rows", "decompose_digits", "prefix_scan", "col_prefix",
        "bucket_sort", "extract_buckets", "pbpr_full")
KERNELS = MAIN + ("encode_mont", "padd_batch", "pdbl_batch", "pbpr_stage1",
                  "globalize", "glv_apply", "to_affine", "batch_inverse",
                  "smvp_rows", "smvp_stitch")


def path_kernels(glv: bool) -> tuple:
    """The kernels of the main path; under GLV `glv_apply` (its rows
    form, `kernels.glv_rows`) writes the row table in `encode_rows'`
    place."""
    return tuple("glv_apply" if glv and k == "encode_rows" else k
                 for k in MAIN)


# The wrapper that launches a kernel under another name.
WRAPPER = {"glv_apply": "glv_rows"}
# (Wg, C, R) of the scan's lane sweep. On 132 SMs a block of G = 6 (20
# lanes) more comes to an SM above 2,640, 5,280 and 7,920 lanes, and a
# second block of G = 2 (64 lanes) above 8,448; the launcher's rule
# picks G = 2 from 7,921 to 8,448 at L <= 22: lane counts about those
# edges, the default schedule's 8,192, and SCHEDULE's 131,072.
LANE_SHAPES = ((1, 2048, 128), (1, 4096, 128), (1, 5632, 128),
               (1, 7424, 128), (1, 7920, 128), (1, 7936, 128),
               (1, 8192, 128), (1, 8448, 128), (1, 8704, 128),
               (2, 8192, 64), (16, 8192, 16))
# A schedule for the largest size that the card's memory allows and the
# default schedule does not use: all 16 windows in one group.
SCHEDULE = dict(window_size=16, columns=8192, pbpr_threads=512,
                subtask_group=16, max_points_per_pass=1 << 22)
# name: (source, the TPU kernel it replaces, the path that launches it)
SOURCES = {
    "encode_mont": ("tpu_msm_torch/csrc/encode_mont.cu",
                    "tpu_msm/cuzk/kernels.py:94",
                    "cuzk/decompose.points_to_mont; off every path"),
    "decompose_digits": ("tpu_msm_torch/csrc/decompose_digits.cu",
                         "tpu_msm/cuzk/kernels.py:439", "main, glv, twin"),
    "prefix_scan": ("tpu_msm_torch/csrc/prefix_scan.cu",
                    "tpu_msm/cuzk/kernels.py:131", "main, glv"),
    "col_prefix": ("tpu_msm_torch/csrc/col_prefix.cu",
                   "tpu_msm/cuzk/kernels.py:538", "main, glv"),
    "padd_batch": ("tpu_msm_torch/csrc/padd_batch.cu",
                   "tpu_msm/cuzk/kernels.py:309",
                   "reduce, twin, sharded tree"),
    "pbpr_full": ("tpu_msm_torch/csrc/pbpr_full.cu",
                  "tpu_msm/cuzk/kernels.py:656", "main, glv"),
    "pdbl_batch": ("tpu_msm_torch/csrc/pdbl_batch.cu",
                   "tpu_msm/cuzk/kernels.py:386", "reduce, twin"),
    "pbpr_stage1": ("tpu_msm_torch/csrc/pbpr_stage1.cu",
                    "tpu_msm/cuzk/kernels.py:615", "reduce, twin"),
    "globalize": ("tpu_msm_torch/csrc/globalize.cu",
                  "tpu_msm/cuzk/kernels.py:261", "globalise"),
    # counterparts of functions the JAX package leaves to XLA (no
    # pallas_call): the GLV split and doubled stream, to_affine and
    # batch_inverse (both on the tree of csrc/batch_inv.cuh)
    "glv_apply": ("tpu_msm_torch/csrc/glv_apply.cu",
                  "tpu_msm/cuzk/glv.py:105", "glv, twin glv"),
    "to_affine": ("tpu_msm_torch/csrc/to_affine.cu",
                  "tpu_msm/ops/inverse.py:124", "affine"),
    "batch_inverse": ("tpu_msm_torch/csrc/batch_inverse.cu",
                      "tpu_msm/ops/inverse.py:85", "affine"),
    # counterparts of what XLA compiles around the Pallas kernels of the
    # JAX package's device program: the stage-2 sort and boundary counts,
    # the stage-3 gathers, adds and select
    "bucket_sort": ("tpu_msm_torch/csrc/bucket_sort.cu",
                    "tpu_msm/cuzk/pipeline_pallas.py:208", "main, glv, twin"),
    "extract_buckets": ("tpu_msm_torch/csrc/extract_buckets.cu",
                        "tpu_msm/cuzk/pipeline_pallas.py:292", "main, glv"),
    # XLA's part of stage 1 around the encode kernel: the casts and the
    # (n, 2L) int16 row table (pipeline_pallas.py:141-143, :258)
    "encode_rows": ("tpu_msm_torch/csrc/encode_mont.cu",
                    "tpu_msm/cuzk/pipeline_pallas.py:258",
                    "main, twin, sharded"),
    # the device loop XLA compiles for the JAX package's XLA path: the
    # lax.fori_loop of bucket_accumulate's row walk
    "smvp_rows": ("tpu_msm_torch/csrc/smvp_rows.cu",
                  "tpu_msm/cuzk/smvp.py:94", "twin"),
    # and the stitch after it: the associative_scan across columns and
    # the inject
    "smvp_stitch": ("tpu_msm_torch/csrc/smvp_stitch.cu",
                    "tpu_msm/cuzk/smvp.py:112", "twin, sharded twin"),
}

# Bound model (H100 SXM, published peaks at 700 W): HBM at 3.35 TB/s;
# int32 multiply-add at 64 INT32 lanes x 132 SMs x 1.98 GHz = 16.7 T/s,
# counted as 2 operations each = 33.5 T int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# Montgomery multiplies per point formula (ops/rows.py).
MULS = {"padd": 12, "pmadd": 12, "pdbl": 9}


def mont_mul_ops(L: int) -> int:
    """int32 operations of one Montgomery multiply: L iterations of L
    a*b multiply-adds, L+1 m*p multiply-adds and one m digit, 2 op each."""
    return 2 * L * (2 * L + 2)


def mul_wide_mads(L: int, w: int) -> int:
    """int32 multiply and multiply-add instructions of one word-wide
    Montgomery multiply (csrc/mul_wide.cuh), each .lo and .hi half
    counted: N = ceil(L w / 32) words, NF = NP = floor(L w / 32); N^2
    word products for a b, then NF whole-word reductions and, where L w
    is no multiple of 32, one of the last bits, each an m digit (one .lo)
    and NP word products of m p. 315 at L = 22 (1,012 multiply-adds in
    Field::mul), 588 at BLS12_377_S12 (2,112)."""
    n, nf = -(-L * w // 32), L * w // 32
    steps = nf + (1 if L * w % 32 else 0)
    return 2 * n * n + steps * (1 + 2 * nf)


# The kernels whose Montgomery multiply is the word-wide one: their
# operations bound counts mul_wide_mads, and mont_mul_ops beside it.
WIDE = ("encode_mont", "encode_rows", "prefix_scan", "col_prefix",
        "padd_batch",
        "pdbl_batch", "pbpr_stage1", "globalize", "pbpr_full", "glv_apply",
        "to_affine", "batch_inverse", "extract_buckets", "smvp_rows",
        "smvp_stitch")
# 32 x 32-bit word products of the GLV split (csrc/glv_split.cuh): two
# Babai products of 8 x 5 words and four truncated products of 5 x 6
# words mod 2^192 (20 each); a .lo and a .hi half each.
GLV_SPLIT_PRODUCTS = 2 * 8 * 5 + 4 * 20


def chain_muls(curve) -> int:
    """Multiplies of one Fermat chain over p - 2: a squaring a bit, a
    product a set bit."""
    e = curve.p - 2
    return e.bit_length() + bin(e).count("1")


# Multiplies an element of Montgomery's trick (a prefix product, two on
# the way back) with Z times one, X zinv and Y zinv; the batch adds one
# chain. The least work of to_affine, so the yardstick of its bound, and
# the work of its kernel, the product tree of csrc/batch_inv.cuh.
TRICK_MULS = 6
# The same without Z one, X zinv and Y zinv: batch_inverse.
INVERSE_MULS = 3
# int32 operations of bucket_sort's ranking, an element a pass (each
# element is ranked once a pass): its digit, the eight ballots of its
# peers, its rank and slot.
SORT_OPS = 16


def bound_ms(nbytes: int, ops: int):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def work(curve, name: str, args, out, wide: bool = True) -> tuple:
    """(bytes moved, int32 operations) of one call: each input read once,
    each output written once; operations from the shapes. A kernel of
    WIDE counts its own multiply's mul_wide_mads (2 operations each, as
    a multiply-add counts); with wide=False, the 12-bit multiply's
    mont_mul_ops."""
    L = curve.num_limbs
    mm = mont_mul_ops(L)
    if wide and name in WIDE:
        mm = 2 * mul_wide_mads(L, curve.log_limb_size)
    ins = args
    if name == "glv_apply":
        # the kernel reads only the halfwords of a scalar below r
        hs = (curve.scalar_modulus.bit_length() + 15) // 16
        ins = args[:2] + (args[2][:hs],) + args[3:]
    if name == "decompose_digits":
        # the kernel reads only the halfwords its W windows touch: the
        # top window's first and, off a halfword's start, the next
        hw, s, W = args[:3]
        top = (W - 1) * s
        rows = min(hw.shape[0], (top >> 4) + 1 + (top % 16 > 0))
        if rows != kernels.digits_rows(hw.shape[0], s, W):
            raise AssertionError(f"decompose_digits: {rows} rows read, the "
                                 f"kernel loads "
                                 f"{kernels.digits_rows(hw.shape[0], s, W)}")
        ins = (hw[:rows],) + args[1:]
    nbytes = sum(a.numel() * a.element_size() for a in ins + as_tuple(out)
                 if isinstance(a, torch.Tensor))
    if name == "smvp_stitch":
        # what the function needs: the trailing sums, each column's first
        # and last key, the injected buckets read and written
        bucket, trailing, skeys, _, C = args
        adds, injects, _, _ = stitch_adds(skeys, C)
        nbytes = (trailing.numel() * 4 + 2 * skeys.shape[0] * C * 4
                  + 2 * injects * 3 * L * 4)
    if name == "extract_buckets":
        # what the function needs: T and S at the (B + 1) Wg region ends,
        # their counts, and the group's buckets written
        tbuf, _, cnt, _, _, Wg = args[:6]
        ends = Wg * cnt.shape[1]
        nbytes = (ends * (2 * 3 * L * tbuf.element_size() + 4)
                  + (ends - Wg) * 3 * L * out.element_size())
    if name == "encode_mont":
        ops = args[0].shape[1] * mm
    elif name == "encode_rows":
        ops = args[0].shape[1] * 2 * mm
    elif name == "decompose_digits":
        ops = out.numel() * 8          # shifts, masks, compare, select
    elif name == "prefix_scan":
        ops = args[1].numel() * MULS["pmadd"] * mm
    elif name == "smvp_rows":
        # a mixed add at every element but a run's first in its column
        # (where the lane restarts): what this run's keys need
        ops = (args[1].numel() - run_starts(args[2], args[4])
               ) * MULS["pmadd"] * mm
    elif name == "smvp_stitch":
        # the scan's adds where b is not flagged, and the injects: what
        # this run's keys need
        ops = (adds + injects) * MULS["padd"] * mm
    elif name == "col_prefix":
        _, _, Wg, C = args[0].shape
        ops = Wg * C * max(C.bit_length() - 1, 1) * MULS["padd"] * mm
    elif name == "padd_batch":
        ops = args[0][0, 0].numel() * MULS["padd"] * mm
    elif name == "pbpr_full":
        # the adds whose sums the output reads: 2 B in stage 1,
        # T log2 T + 3 (T - 1) in the scans (kernels.pbpr_scan_levels),
        # one in the tail, and log2(B / T) doublings, each window
        _, _, Wp, B = args[0].shape
        T = min(args[2], B)
        scan = sum(T // sm + T // sg for _, sm, sg in
                   kernels.pbpr_scan_levels(T))
        dbl = max((B // T).bit_length() - 1, 0)
        ops = Wp * ((2 * B + scan + 1) * MULS["padd"]
                    + dbl * MULS["pdbl"]) * mm
    elif name == "pdbl_batch":
        ops = args[0][0, 0].numel() * MULS["pdbl"] * mm
    elif name == "pbpr_stage1":
        _, _, Wp, B = args[0].shape
        ops = Wp * B * 2 * MULS["padd"] * mm
    elif name == "globalize":
        _, _, R, F = args[0].shape
        ops = R * F * MULS["padd"] * mm
    elif name == "glv_apply":
        # the encode of x and y, beta x, and the split
        ops = args[0].shape[1] * (3 * mm + 4 * GLV_SPLIT_PRODUCTS)
    elif name == "bucket_sort":
        ops = args[0].numel() * kernels.sort_passes(args[1]) * SORT_OPS
    elif name == "extract_buckets":
        # (B + 1) Wg adds of T and S, B Wg differences of neighbours
        Wg, B = args[5], args[2].shape[1] - 1
        ops = Wg * (2 * B + 1) * MULS["padd"] * mm
    elif name == "to_affine":
        # Montgomery's trick: the least work of the function
        ops = (args[0][0, 0].numel() * TRICK_MULS + chain_muls(curve)) * mm
    elif name == "batch_inverse":
        ops = (args[0][0].numel() * INVERSE_MULS + chain_muls(curve)) * mm
    else:
        raise KeyError(name)
    return nbytes, ops


def run_starts(skeys: torch.Tensor, C: int) -> int:
    """Positions of the (Wg, n) sorted keys at which a lane of the row
    walk restarts: each column's first row, and every row whose key
    differs from the row above it."""
    Wg, n = skeys.shape
    k = skeys.reshape(Wg, C, n // C)
    return Wg * C + int((k[..., 1:] != k[..., :-1]).sum())


def chain_form(curve) -> str:
    """Where the product tree's root chain runs at `curve`: csrc/
    batch_inv.cuh `warp_chain`, one warp from N = 12 words of 32 bits,
    else one thread."""
    N = -(-curve.num_limbs * curve.log_limb_size // 32)
    return "one warp" if N >= 12 else "one thread"


def longest_run(skeys: torch.Tensor, C: int) -> int:
    """Rows of the longest run of equal keys inside one column of the
    (Wg, n) sorted keys (a run that goes on into the next column counts
    its rows in each column apart): the row walk's chain of dependent
    adds is one less."""
    Wg, n = skeys.shape
    k = skeys.reshape(Wg * C, n // C)
    R = k.shape[1]
    start = torch.ones_like(k, dtype=torch.bool)
    start[:, 1:] = k[:, 1:] != k[:, :-1]
    # each row's distance from its run's start: its index less the index
    # of the last start at or above it
    idx = torch.arange(R, device=k.device).expand_as(k)
    last = torch.where(start, idx, torch.zeros_like(idx)).cummax(dim=1)[0]
    return int((idx - last).max()) + 1


def stitch_adds(skeys: torch.Tensor, C: int) -> tuple:
    """(the scan's adds, the injects, the depth, the levels with an add)
    of one smvp_stitch call on the (Wg, n) sorted keys: a level's pair
    adds where its b is not flagged, the flags carried level by level as
    the recursion carries them (independent of the closed form that
    csrc/smvp_stitch.cu and kernels.stitch_pairs_add decide by), a column
    injects where it goes on with the run before it and holds more than
    one run or the next column does not go on; the depth is the longest
    chain of dependent adds that these keys need in XLA's tree, the
    inject's add included."""
    Wg, n = skeys.shape
    k = skeys.cpu().long().reshape(Wg, C, n // C)
    first, last = k[..., 0], k[..., -1]
    no = torch.full((Wg, 1), -1)
    cont = torch.cat([no, last[:, :-1]], dim=1) == first
    goes_on = torch.cat([first[:, 1:], no], dim=1) == last
    flags = (first != last) | ~cont
    adds, levels = 0, []
    depth = torch.zeros((Wg, C), dtype=torch.int64)
    for lv, pairs in enumerate(kernels.smvp_stitch_levels(C)):
        a, b = torch.tensor(pairs).T
        go = ~flags[:, b]
        adds += int(go.sum())
        if bool(go.any()):
            levels.append(lv)
        flags[:, b] = torch.where(go, flags[:, a], flags[:, b])
        depth[:, b] = torch.where(
            go, torch.maximum(depth[:, a], depth[:, b]) + 1, depth[:, b])
    inject = cont & ((first != last) | ~goes_on)
    before = torch.cat([depth.new_zeros((Wg, 1)), depth[:, :-1]], dim=1)
    chain = max(int(depth.max()), int(torch.where(inject, before + 1,
                                                  0).max()))
    return adds, int(inject.sum()), chain, tuple(levels)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def queued_ms(fn, reps: int, blocker) -> float:
    """Mean device time of fn over reps launches that wait in the queue
    behind `blocker`, a call that keeps the card busy for longer than the
    host needs to enqueue them: for a kernel shorter than its launch."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    blocker()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


_BUSY = {}


def busy(curve) -> None:
    """Some 18 ms (BN254_S12) of one warp on the card (a scan lane of
    2,048 steps): the call that keeps the card busy while the launches of
    a `queued_ms` measurement are enqueued behind it, made once a
    profile."""
    if curve.name not in _BUSY:
        L, R = curve.num_limbs, 2048
        rng = np.random.default_rng(11)
        table = torch.from_numpy(rng.integers(
            0, 1 << curve.log_limb_size, (32 * R, 2 * L)).astype(np.int16)
            ).to(DEVICE)
        pay = torch.from_numpy((rng.permutation(32 * R) << 1).astype(
            np.int32)).to(DEVICE)[None]
        _BUSY[curve.name] = lambda: kernels.prefix_scan(
            table, pay, curve, 32, _threads_per_lane=2)
    _BUSY[curve.name]()


# A kernel faster than this (CUDA events around back-to-back calls) is
# timed again with queued_ms: its wrapper's host cost, not the kernel,
# sets the pace of back-to-back calls.
QUEUE_BELOW_MS = 1.0
QUEUE_REPS = 50
# A plain version whose first call takes longer is timed by that call.
PLAIN_COLD_MS = 1000.0


def timed_once(fn):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return out, s.elapsed_time(e)


def keep_tensor(a: torch.Tensor) -> torch.Tensor:
    """A copy of `a` with its strides: a view that a kernel reads in place
    (the column totals in the scan output, a pass's slice of the wire)
    stays one, with the same gaps."""
    if a.is_contiguous():
        return a.clone()
    return torch.empty_strided(a.size(), a.stride(), dtype=a.dtype,
                               device=a.device).copy_(a)


@contextlib.contextmanager
def spy(seen: dict, targets, counts: dict | None = None):
    """While active, keep (name, args, kwargs, output) of the first call of
    every (module, name) in `targets`, tensors cloned (the arguments
    before the call, the output after it); padd_batch and
    psub_batch are kept once per dtype form. With `counts`, every call is
    kept once per shape of its first argument instead, and counts[key]
    counts the calls of each key."""
    orig = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def wrap(name, fn):
        def call(*args, **kw):
            key = name
            if counts is not None:
                key = f"{name}{tuple(args[0].shape)}"
                counts[key] = counts.get(key, 0) + 1
            elif name in ("padd_batch", "psub_batch"):
                od = kw.get("out_dtype", args[3] if len(args) > 3 else
                            torch.int32)
                key = f"{name}[{args[0].dtype}->{od}]"
            # the arguments as the call found them (a wrapper may write
            # into one), the outputs as it left them
            keep = lambda a: keep_tensor(a) if isinstance(
                a, torch.Tensor) else a
            first = key not in seen
            kept = tuple(map(keep, args)) if first else None
            out = fn(*args, **kw)
            if first:
                seen[key] = (name, kept, dict(kw),
                             tuple(map(keep, as_tuple(out))))
            return out
        return call

    for mod, name, fn in orig:
        setattr(mod, name, wrap(name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


_INPUTS = {}


def inputs(curve, logn: int):
    """(xs, ys, hw, base, oracle result) of one size of a profile, made
    once."""
    key = (curve.name, logn)
    if key not in _INPUTS:
        xs, ys, hw, base = preprocess.gen_planar_inputs(
            curve, 1 << logn, seed=99, k_base=64)
        _INPUTS[key] = (xs, ys, hw, base,
                        preprocess.expected_msm(base, hw, curve))
    return _INPUTS[key]


def config(curve, logn: int, glv: bool):
    return dataclasses.replace(default_config(1 << logn, curve), glv=glv)


def stage2_chain(digits: torch.Tensor, B: int, Wg: int, C: int, R: int):
    """Stage 2 as the main path ran it before `bucket_sort` (PR 14): the
    sign-packed keys |d| << 1 | sign, one torch.sort, the payload, and
    every boundary by torch.searchsorted (`boundary_positions`)."""
    d32 = digits.to(torch.int32)
    keys2 = (d32.abs() << 1) | (d32 < 0).to(torch.int32)
    skeys2, perm = torch.sort(keys2, dim=-1)
    pay = (perm.to(torch.int32) << 1) | (skeys2 & 1)
    return pay, pipeline_cuda.boundary_positions(skeys2, B, Wg, C, R)


def group_shape(seen: dict, cfg: MSMConfig) -> tuple:
    """(tbuf, S, cnt, Wg, C, R) of the captured run's first window group."""
    tbuf = seen["prefix_scan"][3][0]
    Wg = cfg.subtask_group
    R, F = tbuf.shape[2], tbuf.shape[3]
    return (tbuf, seen["col_prefix"][3][0], seen["bucket_sort"][3][1], Wg,
            F // Wg, R)


def stage3_chain(curve, tbuf, S, cnt, buckets, Wg: int, C: int, R: int,
                 inf_b1):
    """Window group 0's bucket extraction as the main path ran it before
    `extract_buckets` (PR 14), nine launches: two advanced-index gathers,
    `padd_batch`, `torch.where`, `psub_batch` of the neighbours (and the
    two copies its wrapper makes of them), and the copy into the group's
    slice of `buckets`. Returns G, the (3, L, Wg, B+1) sums."""
    L, F = curve.num_limbs, Wg * C
    f, jt = kernels.boundary_lanes(cnt[:Wg], Wg, C, R)
    Tall = tbuf.reshape(3, L, R * F)[:, :, jt.long()]
    Sall = S.reshape(3, L, F)[:, :, f.long()]
    Gall = kernels.padd_batch(Tall, Sall, curve)
    Gp = torch.where(cnt[:Wg] == 0, inf_b1, Gall)
    buckets[:, :, :Wg] = kernels.psub_batch(Gp[..., 1:], Gp[..., :-1], curve,
                                            out_dtype=torch.int16)
    return Gall


def capture_inputs(curve, logn: int, glv: bool) -> dict:
    """Run the device program once on the wire dtypes (int16 limbs,
    uint16 halfwords, as `timed_runs` stages them) and keep the first
    call of every kernel wrapper of the main path and, under GLV, of
    `glv_rows`; then
    run the stage-3 chain that `extract_buckets` replaced on the first
    window group (`stage3_chain`), so that `padd_batch` and `psub_batch`
    are kept at the shapes the main path gave them until PR 14."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    dev = torch.device(DEVICE)
    cfg = config(curve, logn, glv)
    targets = [(kernels, k) for k in MAIN + ("padd_batch", "psub_batch",
                                            "glv_rows")]
    with spy({}, targets) as seen:
        pipeline_cuda.windows_device(
            torch.from_numpy(xs.astype(np.int16)).to(dev),
            torch.from_numpy(ys.astype(np.int16)).to(dev),
            torch.from_numpy(hw.astype(np.uint16)).to(dev), cfg)
        tbuf, S, cnt, Wg, C, R = group_shape(seen, cfg)
        buckets = seen["extract_buckets"][1][3].clone()
        stage3_chain(curve, tbuf, S, cnt, buckets, Wg, C, R,
                     kernels.inf_stacked(curve, (Wg, 1), dev))
        torch.cuda.synchronize()
    return seen


# A wrapper that launches another wrapper's kernel.
KERNEL_OF = {"psub_batch": "padd_batch", "glv_rows": "glv_apply"}
# A wrapper that writes its output into an argument: that argument's
# index. Its kernel and plain version each get their own copy of it.
IN_PLACE = {"extract_buckets": 3, "smvp_stitch": 0}


def fresh(fn: str, args: tuple) -> tuple:
    i = IN_PLACE.get(fn)
    if i is None:
        return args
    return args[:i] + (args[i].clone(),) + args[i + 1:]


def compare(curve, key: str, fn: str, args, kw, tag: str, card: str,
            reps: int) -> dict:
    """One kernel, through wrapper `fn`, against the wrapper's plain
    version on the same CUDA inputs, then timed."""
    name = KERNEL_OF.get(fn, fn)
    kern = getattr(kernels, fn)
    plain = getattr(kernels, fn + "_plain")
    got = kern(*fresh(fn, args), **kw)
    want, plain_ms = timed_once(lambda: plain(*fresh(fn, args), **kw))
    if plain_ms < PLAIN_COLD_MS:
        # fast enough that filling the cached constants on a first call
        # would show: time a second, warm call
        want, plain_ms = timed_once(lambda: plain(*fresh(fn, args), **kw))
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{key}: shape/dtype {g.shape} {g.dtype} "
                                 f"vs plain {w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)
                            ).abs().max()))
    if err:
        raise AssertionError(f"{key} at {tag}: kernel differs from its "
                             f"plain version (max abs err {err})")
    call = lambda: kern(*args, **kw)
    t_cuda = cuda_ms(call, reps)
    queued = t_cuda < QUEUE_BELOW_MS
    t = (queued_ms(call, QUEUE_REPS, lambda: busy(curve)) if queued
         else t_cuda)
    nbytes, ops = work(curve, name, args, got)
    b_ms, b_by = bound_ms(nbytes, ops)
    extra, note = {}, ""
    if name in WIDE:
        b_old, by_old = bound_ms(nbytes, work(curve, name, args, got,
                                            False)[1])
        extra = dict(bound_ms_mont_mul_ops=b_old, bound_by_mont_mul_ops=by_old)
        note = f" bound_ms by mont_mul_ops={b_old:.4f} ({by_old})"
    if name in ("padd_batch", "pdbl_batch", "pbpr_stage1", "globalize",
                "bucket_sort", "extract_buckets", "to_affine",
                "batch_inverse", "smvp_rows", "smvp_stitch",
                "decompose_digits"):
        # smvp_stitch's ran_mask is a tensor on the card, read by
        # stitch_levels_ran
        extra["launched"] = {k: v for k, v in kernels.LAUNCHED[name].items()
                             if k != "ran_mask"}
        note += f" launched={extra['launched']}"
    if name == "decompose_digits":
        copy = same_bytes_copy(args[0], extra["launched"]["rows"],
                               got.shape[0])
        extra["copy_ms"] = (queued_ms(copy, QUEUE_REPS, lambda: busy(curve))
                            if queued else cuda_ms(copy, reps))
        note += (f" a copy of the same bytes (PyTorch copy_) "
                 f"{extra['copy_ms']:.4f} ms, x{t / extra['copy_ms']:.2f}")
    shape = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
    how = "queued behind a busy call" if queued else "back to back"
    print(f"[kernel] {curve.name} {key} {tag} in={shape} "
          f"out={[tuple(o.shape) for o in as_tuple(got)]} "
          f"ms={t:.4f} ({how}) cuda_ms={t_cuda:.4f} (back to back, the "
          f"wrapper's host cost included) plain_ms={plain_ms:.1f} "
          f"bound_ms={b_ms:.4f} ({b_by}){note} x{t / b_ms:.2f} bound; "
          f"bit-identical max_abs_err={err} [{card}]", flush=True)
    return dict(name=name, ms=t, ms_cuda=t_cuda, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, **extra)


def same_bytes_copy(hw: torch.Tensor, rows: int, Wp: int):
    """decompose_digits' yardstick: one PyTorch copy that moves its bytes,
    the `rows` halfword rows its windows read (in place, at their
    stride) into Wp rows of int16, each read and written once."""
    src = hw[:rows].view(torch.int16) if hw.dtype == torch.uint16 else \
        hw[:rows]
    dst = torch.empty((Wp, hw.shape[1]), dtype=torch.int16, device=hw.device)
    k = min(rows, Wp)
    if rows == Wp:
        return lambda: dst.copy_(src)
    # rows and Wp differ: the rows read, and the rest of the rows written
    return lambda: (dst[:k].copy_(src[:k]), dst[k:].zero_())


def check_main_kernels(curve, seen: dict, tag: str, card: str,
                       reps: int) -> dict:
    """Phase 3 for the seven kernels of the main path (under GLV six:
    `glv_rows`, which writes the table there, is held in `glv_check`),
    and for `padd_batch` and `psub_batch` where the capture ran the chain
    that `extract_buckets` replaced; without GLV also `encode_mont`, off
    the path, on the (L, n) int32 x limbs that `points_to_mont` hands
    it."""
    results = {key: compare(curve, key, name, args, kw, tag, card, reps)
               for key, (name, args, kw, _) in seen.items()
               if KERNEL_OF.get(name, name) in MAIN + ("padd_batch",)}
    glv = "glv_rows" in seen
    missing = (set(path_kernels(glv)) - {"glv_apply"}
               - {r["name"] for r in results.values()})
    if missing:
        raise AssertionError(f"kernels never called at {tag}: {missing}")
    if not glv:
        xs32 = seen["encode_rows"][1][0].to(torch.int32).contiguous()
        results["encode_mont"] = compare(curve, "encode_mont", "encode_mont",
                                         (xs32, curve), {}, tag, card, reps)
    for r in results.values():
        if r["name"] in ("bucket_sort", "extract_buckets"):
            r["occupancy"] = occupancy(curve, r["name"], r["launched"], tag,
                                       card)
    return results


def yardsticks(curve, seen: dict, cfg: MSMConfig, results: dict, tag: str,
               card: str, reps: int) -> None:
    """Beside `bucket_sort` and `extract_buckets` on the captured inputs:
    torch.sort (stable, by |d|: the one PyTorch call that computes the
    sort's order; the port never calls it) and the chains of torch ops and
    launches they replaced (`stage2_chain`, `stage3_chain`), timed the
    same way; into their results as library_ms and chain_ms."""
    _, (digits, B), _, _ = seen["bucket_sort"]
    key = digits.to(torch.int32).abs()
    tbuf, S, cnt, Wg, C, R = group_shape(seen, cfg)
    sort_lib = cuda_ms(lambda: torch.sort(key, dim=-1, stable=True), reps)
    sort_chain = cuda_ms(lambda: stage2_chain(digits, B, Wg, C, R), reps)
    buckets = seen["extract_buckets"][1][3].clone()
    inf_b1 = kernels.inf_stacked(curve, (Wg, 1), DEVICE)
    ext_chain = cuda_ms(lambda: stage3_chain(curve, tbuf, S, cnt, buckets,
                                             Wg, C, R, inf_b1), reps)
    results["bucket_sort"].update(library_ms=sort_lib, chain_ms=sort_chain)
    results["extract_buckets"].update(library_ms=None, chain_ms=ext_chain)
    print(f"[yardstick] {curve.name} {tag}: bucket_sort "
          f"{results['bucket_sort']['ms']:.4f} ms beside torch.sort (stable, "
          f"by |d|) {sort_lib:.4f} ms and the stage-2 chain it replaced "
          f"(packed keys, torch.sort, payload, searchsorted) "
          f"{sort_chain:.4f} ms; extract_buckets "
          f"{results['extract_buckets']['ms']:.4f} ms a group beside the "
          f"nine launches it replaced {ext_chain:.4f} ms; all back to back "
          f"[{card}]", flush=True)


def scan_sweep(curve, seen: dict, tag: str, card: str, reps: int) -> dict:
    """`prefix_scan` on the captured inputs for every number of threads
    per lane: bit-identical to the captured output, and timed."""
    _, args, kw, (want,) = seen["prefix_scan"]
    kernels.prefix_scan(*args, **kw)
    picked = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    times = {}
    for G in kernels.SCAN_THREADS_PER_LANE:
        call = lambda: kernels.prefix_scan(*args, **kw, _threads_per_lane=G)
        if not torch.equal(call(), want):
            raise AssertionError(f"prefix_scan at {tag}: {G} threads per "
                                 "lane differ from the main path's output")
        times[G] = cuda_ms(call, reps)
    print(f"[scan-G] {curve.name} {tag} R={want.shape[2]} "
          f"lanes={want.shape[3]}: ms by "
          "threads per lane "
          + ", ".join(f"{G}: {t:.4f}" for G, t in times.items())
          + f"; the wrapper launched {picked}; all bit-identical [{card}]",
          flush=True)
    return dict(picked=picked, ms=times)


def same_as_plain(label: str, name: str, args, kw=None) -> None:
    kw = kw or {}
    got = as_tuple(getattr(kernels, name)(*fresh(name, args), **kw))
    want = as_tuple(getattr(kernels, name + "_plain")(*fresh(name, args)))
    torch.cuda.synchronize()
    if any(g.dtype != w.dtype or not torch.equal(g, w)
           for g, w in zip(got, want, strict=True)):
        raise AssertionError(f"[edge] {label}: kernel differs from its "
                             "plain version")


def sort_extract_edges(seen: dict, cfg: MSMConfig, card: str) -> None:
    """`bucket_sort` and `extract_buckets` against their plain versions at
    inputs the main path may not give them: all-zero digits, every digit
    equal, one point, every digit at +-2^(s-1) in a last partial tile,
    one pass (s = 8) and the widest key (s = 16) on the captured digits'
    shard of windows; extract_buckets with cnt == 0 lanes (j = 0, a whole
    window, a run's halo lane), cnt == n lanes, at the last window group,
    and on the first 40 and 79 region ends, whose last run of a window is
    one bucket (the captured 2^16 shape's B = 4096 = 105 * 39 + 1 is one
    too)."""
    digits, B = seen["bucket_sort"][1]
    Wp, n = digits.shape
    rng = np.random.default_rng(15)
    dev = torch.device(DEVICE)
    pm = lambda v, shape: torch.from_numpy(
        np.where(rng.random(shape) < 0.5, -v, min(v, 32767)).astype(
            np.int16)).to(dev)
    cases = {
        "all-zero digits (3, 5000)": (torch.zeros((3, 5000), dtype=torch.int16,
                                                  device=dev), B),
        "every digit -777 (3, 9000)": (torch.full(
            (3, 9000), -777, dtype=torch.int16, device=dev), B),
        "one point": (digits[:, :1].contiguous(), B),
        "+-B, a partial last tile (2, 4097)": (pm(B, (2, 4097)), B),
        "s=8 (one pass)": (digits[:, :12345].remainder(129).to(torch.int16)
                           - 64, 128),
        "s=16 +-2^15 (2, 70001)": (pm(32768, (2, 70001)), 32768),
        "a shard: the last half of the windows": (
            digits[Wp // 2:].contiguous(), B),
    }
    for label, (d, b) in cases.items():
        same_as_plain(f"bucket_sort {label}", "bucket_sort", (d, b))
    print(f"[edge] bucket_sort bit-identical to its plain version (pay and "
          f"cnt): {', '.join(cases)} [{card}]", flush=True)

    _, args, _, _ = seen["extract_buckets"]
    tbuf, S, cnt, buckets, g, Wg, C, R, curve = args
    G = cnt.shape[0] // Wg
    J = kernels.EXTRACT_LANES - 1
    edged = cnt.clone()
    edged[:, 0] = 0                               # nothing at digit 0
    edged[Wg - 1] = 0                             # an empty window
    edged[0, J:J + 3] = 0                         # a run's halo lane
    edged[0, -4:] = R * C                         # cnt == n
    cases = {"real counts, group 0": (cnt, buckets, 0),
             "cnt == 0 and cnt == n lanes": (edged, buckets, 0),
             "the last group": (edged, buckets, G - 1)}
    for b in (J + 1, 2 * J + 1):
        cases[f"B = {b}: the last run of a window one bucket"] = (
            edged[:, :b + 1].contiguous(), buckets[:, :, :, :b].contiguous(),
            0)
    for label, (c, bk, grp) in cases.items():
        same_as_plain(f"extract_buckets {label}", "extract_buckets",
                      (tbuf, S, c, bk, grp, Wg, C, R, curve))
    print(f"[edge] extract_buckets bit-identical to its plain version, "
          f"the whole (3, L, {cnt.shape[0]}, B) bucket tensor: "
          f"{', '.join(cases)} (Wg = {Wg}; B = {B} unless named) [{card}]",
          flush=True)


def wide_edges(seen: dict, card: str) -> None:
    """`padd_batch`, the in-kernel `psub_batch` and `encode_mont` against
    their plain versions at shapes and values the main path may not
    reach: F = 1; F = 37 and 333, no multiple of the 5 lanes of a warp;
    infinity on either side, P + P and P + (-P); int16 limbs at both ends
    of the (-2^12, 2^13) ledger; every dtype form. encode_mont on the
    limbs of 0, 1 and p - 1."""
    L, w = CURVE.num_limbs, CURVE.log_limb_size
    pts = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    pts = pts.reshape(3, L, -1)                       # real G points, int32
    rng = np.random.default_rng(5)
    inf = kernels.inf_stacked(CURVE, (), DEVICE)
    pick = lambda F: torch.from_numpy(rng.integers(0, pts.shape[2], F)).to(
        DEVICE)
    cases = {"F=1": (pts[..., :1], pts[..., 1:2])}
    p, q = pts[..., pick(37)], pts[..., pick(37)]
    p[..., 0], q[..., 1], p[..., 2], q[..., 2] = inf, inf, inf, inf
    q[..., 3] = p[..., 3]                             # P + P
    q[..., 4] = kernels.pneg_stacked(p[..., 4], CURVE)  # P + (-P)
    cases["F=37 infinity, P+P, P+(-P)"] = (p, q)
    p, q = pts[..., pick(333)].clone(), pts[..., pick(333)].clone()
    for t in (p, q):
        ledger_ends(t, rng, CURVE, 1)
    cases["F=333 limbs at the ledger's ends"] = (p, q)
    n = 0
    for label, (p, q) in cases.items():
        for dt_in in (torch.int16, torch.int32):
            a, b = p.to(dt_in).contiguous(), q.to(dt_in).contiguous()
            for dt_out in (torch.int16, torch.int32):
                for fn in ("padd_batch", "psub_batch"):
                    same_as_plain(f"{fn} {label} {dt_in}->{dt_out}", fn,
                                  (a, b, CURVE, dt_out))
                    n += 1
    print(f"[edge] padd_batch and psub_batch bit-identical to their plain "
          f"versions in {n} launches: {', '.join(cases)}; int16 and int32 in "
          f"and out [{card}]", flush=True)
    xs = torch.tensor([int_to_limbs(v, L, w) for v in (0, 1, CURVE.p - 1)],
                      dtype=torch.int32).T.contiguous().to(DEVICE)
    same_as_plain("encode_mont of 0, 1, p - 1", "encode_mont", (xs, CURVE))
    print(f"[edge] encode_mont bit-identical to its plain version on the "
          f"limbs of 0, 1 and p - 1 [{card}]", flush=True)
    # stage 1 on what the main path may not give it: int32 and int16
    # limbs of 0, 1, p - 1; lane counts about the blocks' 128 points; a
    # slice of the columns of a wider array (a pass's inputs); uint16 and
    # int32 halfwords with Wp > W
    rows_in = seen["encode_rows"][1]
    hw_in = seen["decompose_digits"][1][0]
    cases = {"0, 1, p - 1 int32": (xs, xs.flip(1)),
             "0, 1, p - 1 int16": (xs.to(torch.int16),
                                   xs.flip(1).to(torch.int16))}
    for n in (1, 127, 129, 1000):
        cases[f"n={n} int16"] = (rows_in[0][:, :n], rows_in[1][:, :n])
    lo, hi = 4099, 4099 + 3333
    cases[f"columns [{lo}, {hi}) of the wire"] = (rows_in[0][:, lo:hi],
                                                 rows_in[1][:, lo:hi])
    for label, (x, y) in cases.items():
        same_as_plain(f"encode_rows {label}", "encode_rows", (x, y, CURVE))
    s_, W = seen["decompose_digits"][1][1:3]
    hws = {"uint16": hw_in, "int32": hw_in.to(torch.int32),
           f"uint16 columns [{lo}, {hi})": hw_in[:, lo:hi],
           f"int32 columns [{lo}, {hi})": hw_in.to(torch.int32)[:, lo:hi]}
    for n in (1, 127, 129):
        hws[f"uint16 n={n}"] = hw_in[:, :n]
        hws[f"int32 n={n}"] = hw_in[:, :n].to(torch.int32)
        hws[f"uint16 columns [{lo}, {lo + n})"] = hw_in[:, lo:lo + n]
    # s = 13 (20 windows, the 2^16 shape) and the size's own s and W
    windows = dict.fromkeys([(s_, W), (13, 20), (16, 16)])
    for label, h in hws.items():
        for sw, Ww in windows:
            same_as_plain(f"decompose_digits {label} s={sw} Wp = W + 3",
                          "decompose_digits", (h, sw, Ww, Ww + 3))
    print(f"[edge] encode_rows bit-identical to its plain version: "
          f"{', '.join(cases)}; decompose_digits on "
          f"{', '.join(hws)}, each at (s, W) = "
          f"{', '.join(map(str, windows))}, with three zero rows [{card}]",
          flush=True)


def ledger_ends(t: torch.Tensor, rng, curve, top_axis: int) -> None:
    """Set three in ten of t's limbs, in place, to the ends of the
    (-2^w, 2^(w+1)) ledger, -2^w + 1 and 2^(w+1) - 1, the top limb
    (index L - 1 along `top_axis`) left as it is."""
    w, L = curve.log_limb_size, curve.num_limbs
    ends = torch.tensor([-(1 << w) + 1, (1 << (w + 1)) - 1], dtype=t.dtype,
                        device=t.device)
    at = torch.from_numpy(rng.random(t.shape) < 0.3).to(t.device)
    at.select(top_axis, L - 1).fill_(False)           # top limbs stay small
    t[at] = ends[torch.from_numpy(rng.integers(0, 2, int(at.sum()))).to(
        t.device)]


# (Wg, C) of col_prefix's [edge] shapes: one column; a window of the
# latency's width at Wg = 3; the 2^16 shape; (5, 64) with limbs at the
# ledger's ends; (16, 8192), the SCHEDULE shape, more columns than
# resident lanes.
COL_EDGES = ((1, 1), (3, 32), (4, 2048), (5, 64), (16, 8192))
COL_ENDS = (5, 64)


def edge_shapes(seen: dict, card: str) -> None:
    """Both kernels of stage 3 against their plain versions at shapes
    and values the two sizes do not reach, on the real points of the
    captured run."""
    coltot = seen["col_prefix"][1][0]                  # (3, L, Wg, C)
    rng = np.random.default_rng(7)
    inf = kernels.inf_stacked(CURVE, (), DEVICE).to(torch.int16)
    done, most = [], 0
    for Wg, C in COL_EDGES:
        reps = (1, 1, -(-Wg // coltot.shape[2]), -(-C // coltot.shape[3]))
        ct = coltot.repeat(*reps)[:, :, :Wg, :C].contiguous()
        if (Wg, C) == COL_ENDS:
            ledger_ends(ct, rng, CURVE, 1)
        elif C >= 8:
            at_inf = torch.from_numpy(rng.random((Wg, C)) < 0.5).to(DEVICE)
            ct = torch.where(at_inf, inf[:, :, None, None], ct)
            ct[..., 3] = ct[..., 2]                    # the add is a doubling
            ct[..., 5] = kernels.pneg_stacked(ct[..., 4], CURVE)  # sum: inf
        same_as_plain(f"col_prefix {(Wg, C)}", "col_prefix", (ct, CURVE))
        geo = dict(kernels.LAUNCHED["col_prefix"])
        most = max(most, geo["columns_per_lane"])
        ms = cuda_ms(lambda: kernels.col_prefix(ct, CURVE), 3)
        ends = " limbs at the ledger's ends" if (Wg, C) == COL_ENDS else ""
        done.append(f"{(Wg, C)}{ends} {geo['blocks']} blocks x "
                    f"{geo['lanes_per_block']} "
                    f"lanes x {geo['columns_per_lane']} columns a lane "
                    f"{ms:.4f} ms")
    if most < 2:
        raise AssertionError("[edge] col_prefix: no shape with more columns "
                             "than resident lanes")
    print("[edge] col_prefix bit-identical to its plain version at "
          + "; ".join(done) + f" [{card}]", flush=True)

    table = seen["prefix_scan"][1][0]                  # (n, 2L)
    done = []
    for Wg, C, R, ends in ((1, 32, 1, False), (3, 37, 5, False),
                           (3, 37, 5, True)):
        n = C * R
        pay = np.stack([(rng.integers(0, table.shape[0], n) << 1)
                        | rng.integers(0, 2, n) for _ in range(Wg)])
        if R >= 5:
            # lane 0 of each window: a, a (P + P), -a (back to a), -a
            # (P + (-P): infinity), a (infinity + P)
            a = pay[:, 0] & ~1
            pay[:, 0], pay[:, 1] = a, a
            pay[:, 2], pay[:, 3], pay[:, 4] = a | 1, a | 1, a
        pay = torch.from_numpy(pay.astype(np.int32)).to(DEVICE)
        tab = table
        if ends:
            tab = table.clone()
            ledger_ends(tab.view(-1, 2, CURVE.num_limbs), rng, CURVE, 2)
        for G in (None,) + kernels.SCAN_THREADS_PER_LANE:
            same_as_plain(f"prefix_scan {(Wg, C, R)} G={G}", "prefix_scan",
                          (tab, pay, CURVE, C), dict(_threads_per_lane=G))
        done.append(f"(Wg, C, R) = {(Wg, C, R)}"
                    + (" with row limbs at the ledger's ends" if ends else ""))
    print("[edge] prefix_scan bit-identical to its plain version at "
          + ", ".join(done) + "; a lane of each window through P + P, "
          "P + (-P) = infinity and infinity + P; each with "
          f"{kernels.SCAN_THREADS_PER_LANE} threads per lane and with the "
          f"launcher's pick [{card}]", flush=True)


# Lane counts of pdbl_batch's [edge] launches: one lane, the 8 lanes of
# a warp at 4 threads a doubling and one either side, the reduction
# path's 16.
PDBL_EDGES = (1, 7, 8, 9, 16)


def pdbl_edges(seen: dict, card: str) -> None:
    """`pdbl_batch` against its plain version at PDBL_EDGES lanes of real
    points of the captured run (the stage-3 sums G), on all-infinity
    lanes, and on 333 lanes whose limbs lie, three in ten, at the ends of
    the (-2^12, 2^13) ledger."""
    L = CURVE.num_limbs
    pts = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    pts = pts.reshape(3, L, -1)
    rng = np.random.default_rng(9)
    cases = {f"F={F}": pts[..., :F].contiguous() for F in PDBL_EDGES}
    cases["F=16 all at infinity"] = kernels.inf_stacked(CURVE, (16,),
                                                        DEVICE)
    p = pts[..., torch.from_numpy(rng.integers(0, pts.shape[2], 333)).to(
        DEVICE)].clone()
    ledger_ends(p, rng, CURVE, 1)
    cases["F=333 limbs at the ledger's ends"] = p
    geos = []
    for label, p in cases.items():
        same_as_plain(f"pdbl_batch {label}", "pdbl_batch", (p, CURVE))
        geos.append(f"{label} {dict(kernels.LAUNCHED['pdbl_batch'])}")
    print(f"[edge] pdbl_batch bit-identical to its plain version in "
          f"{len(cases)} launches: {'; '.join(geos)} [{card}]", flush=True)


# (Wp, B, T) of pbpr_stage1's [edge] shapes, cut from the buckets of the
# smallest size: T = 1 (one lane a window, a chain of B + 1 steps, and 3
# lanes, no multiple of the 2 lanes a warp), T = B (one bucket a slice),
# and slices of 3 buckets over 224 lanes.
STAGE1_EDGES = ((3, 64, 1), (16, 512, 512), (7, 96, 32))
# (R, F) of globalize's [edge] shapes: F = 1, R = 1, and F no multiple of
# the 20 lanes of a block.
GLOBALIZE_EDGES = ((3, 1), (1, 37), (5, 333))


def stage1_globalize_edges(seen: dict, card: str) -> None:
    """`pbpr_stage1` and `globalize` against their plain versions at shapes
    and values the two sizes may not reach, on the real points of the
    captured run. In each slice of 3 or more buckets the second from the
    top is infinity and the third equals the top one, so m adds P + P and
    g adds P + P a step before; S of `globalize` is T's first row (P + P),
    its negative (P + (-P)) and infinity at its first three lanes."""
    L = CURVE.num_limbs
    buckets = seen["pbpr_full"][1][0]                   # (3, L, Wp, B)
    inf = kernels.inf_stacked(CURVE, (), DEVICE).to(torch.int16)
    n, done = 0, []
    for Wp, B, T in STAGE1_EDGES:
        b = buckets[:, :, :Wp, :B].clone()
        Bt = B // T
        if Bt >= 3:
            top = torch.arange(T, device=DEVICE) * Bt + Bt - 1
            b[..., top - 1] = inf[:, :, None, None]
            b[..., top - 2] = b[..., top]
        for dt in (torch.int16, torch.int32):
            label = f"pbpr_stage1 (Wp, B, T) = {(Wp, B, T)} {dt}"
            same_as_plain(label, "pbpr_stage1", (b.to(dt).contiguous(), CURVE,
                                                 T))
            n += 1
        done.append(f"{(Wp, B, T)} launched "
                    f"{dict(kernels.LAUNCHED['pbpr_stage1'])}")
    print(f"[edge] pbpr_stage1 bit-identical to its plain version in {n} "
          f"launches, int16 and int32 buckets, infinity and P + P in the "
          f"chains: {'; '.join(done)} [{card}]", flush=True)
    tbuf, S = first_group(CURVE, seen)
    n = 0
    for R, F in GLOBALIZE_EDGES:
        t = tbuf[:, :, :R, :F].contiguous()
        sp = S[..., :F].clone()
        sp[..., 0] = t[:, :, 0, 0]                                 # P + P
        if F > 2:
            sp[..., 1] = kernels.pneg_stacked(t[:, :, 0, 1], CURVE)  # P + (-P)
            sp[..., 2] = inf
        for dt_in in (torch.int16, torch.int32):
            for dt_out in (torch.int16, torch.int32):
                same_as_plain(f"globalize (R, F) = {(R, F)} {dt_in}->{dt_out}",
                              "globalize", (t.to(dt_in), sp.to(dt_in), CURVE,
                                            dt_out))
                n += 1
    print(f"[edge] globalize bit-identical to its plain version in {n} "
          f"launches at (R, F) = {', '.join(map(str, GLOBALIZE_EDGES))}, "
          f"S = T, -T and infinity, every dtype pair; launched "
          f"{dict(kernels.LAUNCHED['globalize'])} [{card}]", flush=True)


# (Wp, B, T) of pbpr_full's [edge] shapes, cut from the buckets of the
# largest size: T = 1 (no scan level), T = B (one bucket a slice, no
# doubling; at the 2^20 MSM's Wp and T, so its time is that of the
# scans, the tail and a stage 1 of one step), T = 1024 and 2048 (above
# the one block of threads a window of the kernel's first form; 2048
# gives the scans more adds than resident chains), one window, and
# B = 2^15 with T = 32 (a stage-1 chain of 1,024 steps, ten doublings).
PBPR_EDGES = ((2, 64, 1), (16, 512, 512), (16, 4096, 1024),
              (16, 4096, 2048), (1, 32768, 512), (1, 32768, 32))


# A pbpr_full edge of at most this many lanes (Wp * T) is held against
# its plain version run on the CPU, in child processes beside the
# profiles, [sharded] and the twin (`cpu_checks_start`): its chains of
# thousands of small launch-bound adds would take minutes of the run on
# the card.
CPU_PLAIN_LANES = 64


def plain_on_cpu(name: str, args: tuple):
    """The plain version of kernel `name` on CPU copies of `args`; runs in
    a child process."""
    torch.set_num_threads(1)
    cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    return getattr(kernels, name + "_plain")(*map(cpu, args))


def pbpr_edges(seen: dict, card: str) -> list:
    """`pbpr_full` against its plain version at PBPR_EDGES, on the real
    buckets of the captured run. The narrow shapes keep their buckets and
    the kernel's output for `cpu_checks`."""
    buckets = seen["pbpr_full"][1][0]
    done = []
    for Wp, B, T in PBPR_EDGES:
        b = buckets[:, :, :Wp, :B].contiguous()
        label = f"pbpr_full (Wp, B, T) = {(Wp, B, T)}"
        cpu = {}
        if Wp * T <= CPU_PLAIN_LANES:
            cpu = dict(got=kernels.pbpr_full(b, CURVE, T).cpu(),
                       buckets=b.cpu())
            where = "(its plain version on the CPU: compared at the end)"
        else:
            same_as_plain(label, "pbpr_full", (b, CURVE, T))
            where = "bit-identical to its plain version"
        geo = dict(kernels.LAUNCHED["pbpr_full"])
        ms = cuda_ms(lambda: kernels.pbpr_full(b, CURVE, T), 3)
        done.append(dict(shape=(Wp, B, T), ms=ms, launched=geo, **cpu))
        print(f"[edge] {label}: {where}; launched {geo}; {ms:.4f} ms "
              f"[{card}]", flush=True)
    if max(d["launched"]["adds_per_chain"] for d in done) < 2:
        raise AssertionError("[edge] pbpr_full: no shape with more adds a "
                             "level than resident chains")
    return done


def cpu_checks_start(edges: list):
    """Starts the plain versions of the pbpr_full edges kept for the CPU,
    in spawned processes (the parent holds a CUDA context), all at once,
    one thread each, while the card's phases go on; `cpu_checks` takes
    their results. Returns (pool, edges, futures), or None."""
    edges = [e for e in edges if "buckets" in e]
    if not edges:
        return None
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(edges),
        mp_context=multiprocessing.get_context("spawn"))
    wants = [pool.submit(plain_on_cpu, "pbpr_full",
                         (e.pop("buckets"), CURVE, e["shape"][2]))
             for e in edges]
    return pool, edges, wants


def cpu_checks(started, card: str) -> None:
    """The pbpr_full edges kept for the CPU (`cpu_checks_start`): the
    kernel's output against each plain version, once it is done; the
    processes stop here."""
    if started is None:
        return
    pool, edges, wants = started
    with pool:
        for e, want in zip(edges, wants):
            got, want = e.pop("got"), want.result()
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"[edge] pbpr_full {e['shape']}: kernel "
                                     "differs from its plain version")
            print(f"[edge] pbpr_full (Wp, B, T) = {e['shape']}: bit-identical "
                  f"to its plain version (run on the CPU) [{card}]",
                  flush=True)


# The kernels of csrc/ in a profiler trace: `<name>_kernel<...>` in the
# anonymous namespace of their sources.
PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::\w+_kernel<")


def device_us(row) -> float:
    """Self device time of a profiler row in microseconds (the attribute
    is named after CUDA in older PyTorch)."""
    us = getattr(row, "self_device_time_total", None)
    return us if us is not None else row.self_cuda_time_total


def over_the_stream(shaped: list, lanes: int) -> list:
    """The PyTorch ops of `shaped` (dicts of op, input shapes, calls and
    device time, as `rest_split` reads them from the profiler) that read
    a tensor with an axis of `lanes` or more. An op whose inputs the
    profiler gives no shape (a `cat` of a list) cannot be shown to stay
    off the stream: it counts as over it."""
    return [r for r in shaped if not r["shapes"]
            or any(d >= lanes for shp in r["shapes"] for d in shp)]


def rest_split(logn: int) -> dict:
    """What the MSM does outside the port's kernels, from one real call:
    window_sums + host Horner on staged inputs, as `timed_runs` runs it,
    under torch.profiler after a warm-up call. Each kernel's device time
    goes to the PyTorch op that launched it (the op's self device time);
    the kernels of csrc/, launched through ctypes, have no such op and are
    summed apart. Every PyTorch op that kept the device busy is listed
    with its input shapes (`wide_ops`); the call fails if one of them
    read a tensor with an axis as long as the stream's lanes (a cast,
    `cat`, `copy_` or `contiguous` over the stream: stage 1 and the
    column totals are the kernels'). Then, on the host clock
    (median of 5), the d2h of the window sums, their decode and the host
    Horner, on the device output of the same program."""
    cfg = config(CURVE, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    n = 1 << logn
    xs, ys, hw, _, want = inputs(CURVE, logn)
    dev_in = [torch.from_numpy(a).to(DEVICE) for a in (
        xs.astype(np.int16), ys.astype(np.int16),
        np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))]
    call = lambda: pipe.horner(pipe.window_sums(*dev_in))
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(DEVICE).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        acc = call()
        wall = (time.perf_counter() - t0) * 1e3
    if not ref.jac_eq(CURVE, acc, want):
        raise AssertionError(f"2^{logn} [rest]: the profiled call differs "
                             "from the oracle")
    ops, port, device = {}, 0.0, 0.0
    for row in prof.key_averages():
        us = device_us(row)
        if us <= 0:
            continue
        if row.device_type == torch.autograd.DeviceType.CPU:
            ops[row.key] = us / 1e3
        else:
            device += us / 1e3
            if PORT_KERNEL.match(row.key):
                port += us / 1e3
    shaped = [dict(op=row.key, shapes=[list(x) for x in row.input_shapes
                                       if x], calls=row.count,
                   device_ms=device_us(row) / 1e3)
              for row in prof.key_averages(group_by_input_shape=True)
              if row.device_type == torch.autograd.DeviceType.CPU
              and device_us(row) > 0]
    wide = over_the_stream(shaped, n)
    if wide:
        raise AssertionError(f"2^{logn} [rest]: PyTorch ops over the "
                             f"stream's {n} lanes on the device: {wide}")
    out = dict(wall_ms=wall, device_ms=device, kernels_ms=port,
               ops_ms=dict(sorted(ops.items(), key=lambda kv: -kv[1])),
               ops_by_shape=shaped, wide_ops=len(wide))

    def host(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    g = pipe._run(pipe._stage(dev_in))
    windows = pipe._decode_windows(g)
    out["d2h"] = host(lambda: g.cpu())
    out["decode"] = host(lambda: pipe._decode_windows(g)) - out["d2h"]
    out["horner"] = host(lambda: pipe.horner(windows))
    return out


# How many PyTorch ops the [rest] line names; the others are summed.
REST_OPS = 8


def rest_line(logn: int, rest: dict, outside: float, card: str) -> None:
    ops = list(rest["ops_ms"].items())
    named = ", ".join(f"{k} {v:.3f}" for k, v in ops[:REST_OPS])
    others = [v for _, v in ops[REST_OPS:]]
    op_sum = sum(rest["ops_ms"].values())
    device = (f"device busy {rest['device_ms']:.2f} ms of the call's "
              f"{rest['wall_ms']:.2f} ms: the port's kernels "
              f"{rest['kernels_ms']:.2f} ms, PyTorch ops {op_sum:.2f} ms "
              f"({named}, {len(others)} other ops {sum(others):.3f})"
              if rest["device_ms"] else
              "device time not measured (the profiler saw no device "
              "activity)")
    host = rest["d2h"] + rest["decode"] + rest["horner"]
    shaped = "; ".join(f"{r['op']} {r['shapes']} x{r['calls']} "
                       f"{r['device_ms']:.4f} ms"
                       for r in rest["ops_by_shape"]) or "none"
    print(f"[rest] n=2^{logn} PyTorch ops with device time, by input "
          f"shape: {shaped}; none over the stream's lanes [{card}]",
          flush=True)
    print(f"[rest] n=2^{logn}, one window_sums + Horner under torch.profiler:"
          f" {device}; host d2h {rest['d2h']:.3f}, decode "
          f"{rest['decode']:.3f}, Horner {rest['horner']:.3f} ms; ops and "
          f"host together {op_sum + host:.2f} ms against the {outside:.2f} ms"
          f" of the end-to-end median outside the kernels [{card}]",
          flush=True)


# [large]: the main path at the sizes above 2^21 that a prover's MSM
# reaches, on the static schedule (s = 16, C = 8192, Wg = 1,
# max_points_per_pass = 2^22): 2^22 in one pass, 2^24 in four.
LARGE_LOGN = (22, 24)
LARGE_RUNS = {22: 3, 24: 1}
# the kernels held against their plain versions at 2^22 (the scan's plain
# version would take some 25 s there)
LARGE_CHECKED = ("encode_rows", "decompose_digits", "col_prefix")


def large_phase(card: str) -> dict:
    """[large]: BN254_S12 at each size of LARGE_LOGN through
    `window_sums` + host Horner on planar wire inputs on the card (int16
    limbs, uint16 halfwords; not the user call, whose host pack of 2^22
    python points would dominate), gen_planar_inputs(seed=99, k_base=64),
    the static schedule: EXACT against the oracle, every launch count set
    to 0 just before the first run and read just after (a pbpr_full a
    pass); at 2^22 the first call of each kernel of LARGE_CHECKED against
    its plain version, timed (`col_prefix` on the scan output in place);
    then LARGE_RUNS timed runs, each EXACT, and the peak device memory
    of a timed run (`torch.cuda.max_memory_allocated`)."""
    t0 = time.perf_counter()
    out = {}
    for logn in LARGE_LOGN:
        n = 1 << logn
        ts = time.perf_counter()
        xs, ys, hw, base = preprocess.gen_planar_inputs(CURVE, n, seed=99,
                                                        k_base=64)
        want = preprocess.expected_msm(base, hw, CURVE)
        setup_s = time.perf_counter() - ts
        cfg = static_config(n, CURVE)
        hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
        wire = [torch.from_numpy(a).to(DEVICE) for a in (
            xs.astype(np.int16), ys.astype(np.int16), hw.astype(np.uint16))]
        del xs, ys, hw
        pipe = get_pipeline(cfg, DEVICE)
        label = f"large 2^{logn}"
        seen = {}
        targets = ([(kernels, k) for k in LARGE_CHECKED]
                   if logn == min(LARGE_LOGN) else [])
        sync(DEVICE)
        kernels.reset_launches()
        with spy(seen, targets):
            t1 = time.perf_counter()
            acc = pipe.horner(pipe.window_sums(*wire))
            first_s = time.perf_counter() - t1
        launches = main_launches(label)
        passes = -(-n // cfg.max_points_per_pass)
        exact = ref.jac_eq(CURVE, acc, want)
        if not exact or launches["pbpr_full"] != passes:
            raise AssertionError(f"{label}: EXACT {exact}, "
                                 f"{launches['pbpr_full']} passes for "
                                 f"{passes}")
        checked = {}
        for name, (fn, args, kw, _) in seen.items():
            checked[name] = compare(CURVE, f"{name}[2^{logn}]", fn, args, kw,
                                    f"n=2^{logn}", card, 3)
        del seen
        on_card = torch.device(DEVICE).type == "cuda"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(LARGE_RUNS[logn]):
            sync(DEVICE)
            t1 = time.perf_counter()
            acc = pipe.horner(pipe.window_sums(*wire))
            times.append((time.perf_counter() - t1) * 1e3)
            if not ref.jac_eq(CURVE, acc, want):
                raise AssertionError(f"{label}: a timed run differs from "
                                     "the oracle")
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        ms = statistics.median(times)
        out[f"2^{logn}"] = dict(
            passes=passes, msm_ms=ms, runs_ms=times, first_run_s=first_s,
            setup_s=setup_s, peak_bytes=peak, launches=launches,
            window_size=cfg.window_size, columns=cfg.columns,
            subtask_group=cfg.subtask_group, rows=cfg.max_points_per_pass
            // cfg.columns, kernels=checked)
        print(f"[large] {CURVE.name} n=2^{logn} s={cfg.window_size} "
              f"C={cfg.columns} Wg={cfg.subtask_group} R="
              f"{cfg.max_points_per_pass // cfg.columns} "
              f"{passes} pass(es) of {cfg.max_points_per_pass}: window_sums + "
              f"Horner on wire "
              f"inputs on the card EXACT; median {ms:.2f} ms of "
              f"{[round(t, 2) for t in times]}; peak device memory "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches="
              f"{launches}; "
              + "".join(f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                        f"bit-identical to its plain version); "
                        for k, v in checked.items())
              + f"inputs and oracle {setup_s:.1f} s [{card}]", flush=True)
        del wire
        if on_card:
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[large] every phase passed in {out['seconds']:.1f} s [{card}]",
          flush=True)
    return out


def lane_sweep(curve, card: str) -> dict:
    """`prefix_scan` over 2^18 to 2^21 stream elements at lane counts from
    a quarter of the default schedule's to sixteen times it, for every
    number of threads per lane: what the launcher's rule rests on."""
    L = curve.num_limbs
    rng = np.random.default_rng(13)
    out = {}
    for Wg, C, R in LANE_SHAPES:
        n = C * R
        table = torch.from_numpy(rng.integers(
            0, 1 << curve.log_limb_size, (n, 2 * L)).astype(np.int16)
            ).to(DEVICE)
        pay = torch.from_numpy(np.stack(
            [rng.permutation(n) << 1 for _ in range(Wg)]).astype(np.int32)
            ).to(DEVICE)
        kernels.prefix_scan(table, pay, curve, C)
        picked = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
        ms = {G: cuda_ms(lambda: kernels.prefix_scan(
            table, pay, curve, C, _threads_per_lane=G), 5)
            for G in kernels.SCAN_THREADS_PER_LANE}
        out[Wg * C] = dict(R=R, ms=ms, picked=picked)
        print(f"[scan-lanes] {curve.name} lanes={Wg * C} R={R}: ms by "
              "threads per lane "
              + ", ".join(f"{G}: {t:.4f}" for G, t in ms.items())
              + f"; the wrapper launched {picked} [{card}]", flush=True)
    return out


# Slice lengths Bt of the pbpr_full and pbpr_stage1 calls on one window
# of T = 8 lanes (two lanes of twelve threads a warp) whose differences
# give the time of one stage-1 step (the last two) and, with it, of one
# doubling of the tail (the first two: Bt - 1 steps and log2 Bt
# doublings apart).
PBPR_STEP_BT = (1, 8, 32, 256)
# Lane counts T of the two pbpr_full calls at Bt = 1 (one window, B = T)
# whose difference gives the time of one scan level: 2 log2 T levels.
PBPR_LEVEL_T = (8, 64)


# Column counts of the two col_prefix calls on one warp (one window,
# log2 C levels) whose difference gives the time of one level.
COL_LEVEL_C = (2, 32)
# smvp_stitch on one window of C columns of one row, every key equal (so
# every pair of the scan adds, and the last column injects): 1 and 15
# scan levels
STITCH_LEVEL_C = (2, 256)


def latency(curve, card: str, scan_G: int) -> dict:
    """One `padd_batch` launch on 32 lanes and one `pdbl_batch` launch on
    16; one col_prefix level, one scan step and one doubling on a single
    warp (32 lanes; one lane for pdbl_batch); on one window of 8 lanes,
    twelve threads each, two a warp, one pbpr_full stage-1 step, one
    doubling of its tail and one pbpr_stage1 step; one pbpr_full scan
    level on one window of 8 and of 64 lanes; one to_affine chain on one
    point; one smvp_stitch level on one window."""
    L, R = curve.num_limbs, 128
    rng = np.random.default_rng(11)
    lazy = lambda shape: torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (3, L) + shape).astype(np.int16)
        ).to(DEVICE)
    p, q = lazy((32,)), lazy((32,))
    table = torch.from_numpy(rng.integers(
        0, 1 << curve.log_limb_size, (32 * R, 2 * L)).astype(np.int16)
        ).to(DEVICE)
    pay = torch.from_numpy((rng.permutation(32 * R) << 1).astype(np.int32)
                           ).to(DEVICE)[None]
    blocker = lambda: busy(curve)
    padd_ms = queued_ms(lambda: kernels.padd_batch(p, q, curve), 50,
                        blocker)
    padd_geo = dict(kernels.LAUNCHED["padd_batch"])
    dbl = {F: lazy((F,)).to(torch.int32) for F in (16, 1)}
    dbl_ms = {F: queued_ms(lambda: kernels.pdbl_batch(d, curve), 50,
                           blocker)
              for F, d in dbl.items()}
    dbl_geo = dict(kernels.LAUNCHED["pdbl_batch"])
    # col_prefix on one window: one block, C threads of one warp,
    # max(log2 C, 1) levels a launch; the two calls differ by 4 levels
    cols = {C: lazy((1, C)) for C in COL_LEVEL_C}
    col = {C: queued_ms(lambda: kernels.col_prefix(cols[C], curve), 50,
                        blocker)
           for C in COL_LEVEL_C}
    lv = [max(C.bit_length() - 1, 1) for C in COL_LEVEL_C]
    col_level = (col[COL_LEVEL_C[1]] - col[COL_LEVEL_C[0]]) / (lv[1] - lv[0])
    step = {G: cuda_ms(lambda: kernels.prefix_scan(
        table, pay, curve, 32, _threads_per_lane=G), 20) / R
        for G in kernels.SCAN_THREADS_PER_LANE}
    # pbpr_full on one window of 8 lanes: the calls at Bt1 > Bt0 differ by
    # Bt1 - Bt0 stage-1 steps and log2(Bt1 / Bt0) doublings; the last two
    # give a step (a doubling counted as a step), the first two then a
    # doubling; the calls at Bt = 1 and T = 8, 64 differ by 6 scan levels
    dbl_lo, dbl_hi, lo, hi = PBPR_STEP_BT
    bt_b = {Bt: lazy((1, 8 * Bt)) for Bt in PBPR_STEP_BT}
    pb = {Bt: cuda_ms(lambda: kernels.pbpr_full(b, curve, 8), 10)
          for Bt, b in bt_b.items()}
    log2 = lambda v: v.bit_length() - 1
    pbpr_step = (pb[hi] - pb[lo]) / (hi - lo + log2(hi // lo))
    pbpr_dbl = (pb[dbl_hi] - pb[dbl_lo] - (dbl_hi - dbl_lo) * pbpr_step
                ) / log2(dbl_hi // dbl_lo)
    t_b = {T: lazy((1, T)) for T in PBPR_LEVEL_T}
    lv_ms = {T: cuda_ms(lambda: kernels.pbpr_full(b, curve, T), 10)
             for T, b in t_b.items()}
    t0, t1 = PBPR_LEVEL_T
    pbpr_level = (lv_ms[t1] - lv_ms[t0]) / (2 * (log2(t1) - log2(t0)))
    # pbpr_stage1 on the same shapes: the two calls differ by Bt1 - Bt0
    # steps, each one add of each chain at once
    s1 = {Bt: cuda_ms(lambda: kernels.pbpr_stage1(bt_b[Bt], curve, 8), 10)
          for Bt in (lo, hi)}
    s1_geo = dict(kernels.LAUNCHED["pbpr_stage1"])
    stage1_step = (s1[hi] - s1[lo]) / (hi - lo)
    # the row walk on one column whose keys are all equal: one lane walks
    # its R rows, one run, an add a row; the calls at R = 128 and 64
    # differ by 64 steps of the lane
    rows_r = {}
    for Rw in (64, 128):
        rw_pay = pay[:, :Rw].contiguous()
        rw_keys = torch.full_like(rw_pay, 7)
        rows_r[Rw] = cuda_ms(lambda: kernels.smvp_rows(
            table, rw_pay, rw_keys, curve, 1, 4096), 20)
    rows_step = (rows_r[128] - rows_r[64]) / 64
    # to_affine on one point: one launch of one block, z = Z one, the
    # root's chain (on one thread or one warp, `chain_form`), X zinv and
    # Y zinv, chain_muls + 3 multiplies deep
    one = lazy((1,)).to(torch.int32)
    aff_ms = queued_ms(lambda: to_affine(one, curve), 20, blocker)
    mul_ms = aff_ms / (chain_muls(curve) + 3)
    # extract_buckets on one window of one run: one block, its two
    # dependent adds (the G lanes, then their differences)
    J = kernels.EXTRACT_LANES - 1
    ext_args = (lazy((1, 32)), lazy((32,)), torch.from_numpy(np.sort(
        rng.integers(0, 33, (1, J + 1))).astype(np.int32)).to(DEVICE),
        torch.empty((3, L, 1, J), dtype=torch.int16, device=DEVICE), 0, 1,
        32, 1, curve)
    ext_ms = queued_ms(lambda: kernels.extract_buckets(*ext_args), 50,
                       blocker)
    # smvp_stitch on one window: the calls differ by their scan levels
    # (the copy-in and the inject are in both)
    stitch = {}
    for C in STITCH_LEVEL_C:
        st_args = (lazy((1, 6)).to(torch.int32), lazy((1, C)).to(torch.int32),
                   torch.ones((1, C), dtype=torch.int32, device=DEVICE),
                   curve, C)
        stitch[C] = queued_ms(lambda: kernels.smvp_stitch(*st_args), 50,
                              blocker)
    st_lv = [len(kernels.smvp_stitch_levels(C)) for C in STITCH_LEVEL_C]
    stitch_level = ((stitch[STITCH_LEVEL_C[1]] - stitch[STITCH_LEVEL_C[0]])
                    / (st_lv[1] - st_lv[0]))
    print(f"[latency] {curve.name}: padd_batch on 32 lanes {padd_ms:.4f} "
          f"ms a launch "
          f"(launched {padd_geo}); pdbl_batch on 16 lanes {dbl_ms[16]:.4f} "
          f"ms a launch, one doubling on a lone warp {dbl_ms[1]:.4f} ms "
          f"(launched {dbl_geo}); one warp of lanes: col_prefix "
          f"{col_level:.5f} ms a level, from one window of C columns (C = "
          + ", ".join(f"{C} {t:.4f} ms" for C, t in col.items())
          + f"); prefix_scan (R={R}) ms a step by threads per lane "
          + ", ".join(f"{G}: {t:.5f}" for G, t in step.items())
          + f" (the 2^{max(SIZES)} shape runs {scan_G}); pbpr_full stage-1 "
          f"step (two adds at once) {pbpr_step:.5f} ms, one doubling of the "
          f"tail {pbpr_dbl:.5f} ms, from (1, 8 * Bt) buckets at T = 8: "
          + ", ".join(f"Bt = {Bt} {t:.4f} ms" for Bt, t in pb.items())
          + f"; pbpr_full scan level {pbpr_level:.5f} ms, from (1, T) "
          "buckets at Bt = 1: "
          + ", ".join(f"T = {T} {t:.4f} ms" for T, t in lv_ms.items())
          + f"; pbpr_stage1 step (two adds at once) "
          f"{stage1_step:.5f} ms, from the same buckets: Bt = {lo} "
          f"{s1[lo]:.4f} ms, Bt = {hi} {s1[hi]:.4f} ms, launched {s1_geo}; "
          f"to_affine on one point (a chain of {chain_muls(curve) + 3} "
          f"multiplies, the root's on {chain_form(curve)}) {aff_ms:.4f} "
          f"ms, {mul_ms:.5f} ms a multiply; smvp_rows {rows_step:.5f} ms "
          f"a row of "
          f"one lane, from one column of one run (R = 64 {rows_r[64]:.4f} "
          f"ms, R = 128 {rows_r[128]:.4f} ms); extract_buckets on one run "
          f"({J} buckets of one window on one block, two dependent adds) "
          f"{ext_ms:.4f} ms; smvp_stitch {stitch_level:.5f} ms a level, "
          f"from one window of C columns, every key equal (C = "
          + ", ".join(f"{C}, {n} levels, {t:.4f} ms" for (C, t), n in
                      zip(stitch.items(), st_lv))
          + f") [{card}]", flush=True)
    return dict(padd_ms=padd_ms, padd_launched=padd_geo,
                pdbl_16_lanes_ms=dbl_ms[16], pdbl_one_warp_ms=dbl_ms[1],
                pdbl_one_warp_launched=dbl_geo,
                col_prefix_level_ms=col_level, col_prefix_one_warp_ms=col,
                scan_step_ms=step, pbpr_step_ms=pbpr_step,
                pbpr_doubling_ms=pbpr_dbl, pbpr_level_ms=pbpr_level,
                pbpr_one_warp_ms=pb, pbpr_one_window_bt1_ms=lv_ms,
                pbpr_stage1_step_ms=stage1_step,
                pbpr_stage1_one_warp_ms=s1, pbpr_stage1_launched=s1_geo,
                to_affine_one_lane_ms=aff_ms, tree_mul_ms=mul_ms,
                rows_step_ms=rows_step,
                extract_one_block_ms=ext_ms,
                stitch_level_ms=stitch_level, stitch_one_window_ms=stitch)


def first_group(curve, seen: dict):
    """(T, S) of the first window group: the scan output (3, L, R, F) and
    the column prefix flattened to (3, L, F)."""
    tbuf = seen["prefix_scan"][3][0]
    S = seen["col_prefix"][3][0]
    return tbuf, S.reshape(3, curve.num_limbs, tbuf.shape[3])


def reduction_path(curve, seen: dict, logn: int, card: str,
                   full_ms: float):
    """Phase 4 at one size. Returns the launch counts of the path and the
    (3, L, Wp) sum that the path hands to `pdbl_batch`."""
    cfg = config(curve, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    buckets = seen["pbpr_full"][1][0]
    want = pipe._decode_windows(seen["pbpr_full"][3][0])

    kernels.reset_launches()
    with spy({}, [(kernels, "pdbl_batch")]) as dbl:
        got = pbpr.bucket_reduce(buckets, cfg)
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    got = pipe._decode_windows(got)
    for w, (a, b) in enumerate(zip(got, want, strict=True)):
        if not ref.jac_eq(curve, a, b):
            raise AssertionError(f"2^{logn}: bucket_reduce differs from "
                                 f"pbpr_full in window {w}")
    idle = [k for k in ("pbpr_stage1", "pdbl_batch", "padd_batch")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"2^{logn}: reduction path did not launch {idle}")
    # stage 1, then stage 2 as one more launch; the halving tree and the
    # last add on padd_batch
    T = min(cfg.pbpr_threads, cfg.half_columns)
    want = dict(pbpr_stage1=2 if T > 1 else 1,
                padd_batch=T.bit_length() - 1 + 1)
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"2^{logn}: reduction path launched "
                             f"{launches}, expected {want}")
    times = [timed_once(lambda: pbpr.bucket_reduce(buckets, cfg))[1]
             for _ in range(3)]
    ms = statistics.median(times)
    used = {k: v for k, v in launches.items() if v}
    print(f"[reduce] {curve.name} n=2^{logn} bucket_reduce (3, L, "
          f"{buckets.shape[2]}, "
          f"{buckets.shape[3]}) T={cfg.pbpr_threads}: equal in the group to "
          f"pbpr_full in all {len(want)} windows; median {ms:.2f} ms of "
          f"{[round(t, 2) for t in times]} against pbpr_full {full_ms:.2f} ms;"
          f" launches={used} (stage 2 one pbpr_stage1 launch of {T - 1} "
          f"steps, in place of {2 * (T - 1)} padd_batch launches) [{card}]",
          flush=True)
    return launches, ms, dbl["pdbl_batch"][1][0]


def globalise_check(curve, seen: dict, logn: int, card: str) -> int:
    """Phase 5 at one size: `globalize(T, S)` at the region ends of the
    first window group (from `bucket_sort`'s counts) against the G of the
    chain `extract_buckets` replaced, and the buckets made from it
    (infinity where cnt == 0, `psub_batch` of the neighbours) against
    what the main path's `extract_buckets` wrote. Returns the launches of
    `globalize` it made (one)."""
    cfg = config(curve, logn, False)
    tbuf, S, cnt, Wg, C, R = group_shape(seen, cfg)
    L = curve.num_limbs
    jt = kernels.boundary_lanes(cnt[:Wg], Wg, C, R)[1].long()
    want = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    kernels.reset_launches()
    G = kernels.globalize(tbuf, S.reshape(3, L, -1), curve)
    launches = kernels.LAUNCHES["globalize"]
    got = G.reshape(3, L, -1)[:, :, jt]
    Gp = torch.where(cnt[:Wg] == 0, kernels.inf_stacked(curve, (Wg, 1),
                                                        DEVICE), got)
    bk = kernels.psub_batch(Gp[..., 1:], Gp[..., :-1], curve,
                            out_dtype=torch.int16)
    main_bk = seen["extract_buckets"][3][0][:, :, :Wg]
    torch.cuda.synchronize()
    if launches == 0:
        raise AssertionError(f"2^{logn}: globalize was not launched")
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"2^{logn}: globalize(T, S) at the region ends "
                             "differs from the G of the stage-3 chain")
    if not torch.equal(bk, main_bk):
        raise AssertionError(f"2^{logn}: the buckets from globalize differ "
                             "from the main path's extract_buckets")
    print(f"[globalise] {curve.name} n=2^{logn} globalize(T "
          f"{tuple(tbuf.shape)}, "
          f"S {tuple(S.shape)}) at the {tuple(jt.shape)} region ends of "
          f"bucket_sort's counts: bit-identical to the G of the stage-3 "
          f"chain, and its buckets to those the main path's extract_buckets "
          f"wrote [{card}]", flush=True)
    return launches


def check_nine(curve, seen: dict, logn: int, card: str, reps: int,
               full_ms: float) -> dict:
    """Phase 3 for `pbpr_stage1`, `globalize` and `pdbl_batch`
    (`off_path`), and phases 4 and 5 (`full_ms`: pbpr_full's time,
    beside the reduction path's)."""
    results = off_path(curve, seen, logn, card, reps)
    red = reduction_path(curve, seen, logn, card, full_ms)
    results["pdbl_batch[Wp]"] = compare(
        curve, "pdbl_batch[Wp]", "pdbl_batch", (red[2], curve), {},
        f"n=2^{logn}", card, reps)
    glob = globalise_check(curve, seen, logn, card)
    return dict(results=results, reduce_launches=red[0], reduce_ms=red[1],
                globalize_launches=glob)


def off_path(curve, seen: dict, logn: int, card: str, reps: int) -> dict:
    """`pbpr_stage1`, `globalize` and `pdbl_batch` against their plain
    versions on the captured run's buckets,
    the first window group's scan output and column prefix, and the
    stage-3 sums G."""
    cfg = config(curve, logn, False)
    tbuf, S = first_group(curve, seen)
    buckets = seen["pbpr_full"][1][0]
    gall = seen[f"padd_batch[{torch.int16}->{torch.int32}]"][3][0]
    T = min(cfg.pbpr_threads, cfg.half_columns)
    calls = {"pbpr_stage1": ("pbpr_stage1", (buckets, curve, T)),
             "globalize": ("globalize", (tbuf, S, curve)),
             "pdbl_batch[Wg,B+1]": ("pdbl_batch", (gall, curve))}
    return {key: compare(curve, key, fn, args, {}, f"n=2^{logn}", card, reps)
            for key, (fn, args) in calls.items()}


def check_size(logn: int, card: str):
    """Phases 3 to 5 at one size."""
    reps = 5 if logn < 20 else 3
    seen = capture_inputs(CURVE, logn, False)
    tag = f"n=2^{logn}"
    results = check_main_kernels(CURVE, seen, tag, card, reps)
    yardsticks(CURVE, seen, config(CURVE, logn, False), results, tag, card,
               reps)
    sweep = scan_sweep(CURVE, seen, tag, card, reps)
    if logn == min(SIZES):
        sort_extract_edges(seen, config(CURVE, logn, False), card)
        edge_shapes(seen, card)
        wide_edges(seen, card)
        stage1_globalize_edges(seen, card)
        pdbl_edges(seen, card)
    pbpr_edge = pbpr_edges(seen, card) if logn == max(SIZES) else None
    nine = check_nine(CURVE, seen, logn, card, reps,
                      results["pbpr_full"]["ms"])
    results.update(nine["results"])
    red = (nine["reduce_launches"], nine["reduce_ms"])
    glob = nine["globalize_launches"]

    del seen
    torch.cuda.empty_cache()
    seen = capture_inputs(CURVE, logn, True)
    results_glv = check_main_kernels(CURVE, seen, f"n=2^{logn} glv", card,
                                     reps)
    yardsticks(CURVE, seen, config(CURVE, logn, True), results_glv,
               f"n=2^{logn} glv", card, reps)
    sweep_glv = scan_sweep(CURVE, seen, f"n=2^{logn} glv", card, reps)
    results_glv["glv_apply"] = glv_check(
        CURVE, seen["glv_rows"][1][:3] + (config(CURVE, logn, True),),
        f"n=2^{logn} glv", card, reps)
    glv_ms = results_glv["glv_apply"]["apply_glv_ms"]
    del seen
    torch.cuda.empty_cache()
    return dict(main=results, glv=results_glv, reduce_launches=red[0],
                reduce_ms=red[1], globalize_launches=glob, apply_glv_ms=glv_ms,
                scan_sweep=sweep, scan_sweep_glv=sweep_glv,
                pbpr_edges=pbpr_edge)


def glv_edge_scalars(glvp) -> list:
    """0, 1, r - 1, 2^15, lambda, r - lambda, +-max_abs, then seeded
    scalars until k1 alone, k2 alone and both are negative."""
    r = glvp.curve.scalar_modulus
    ks = [0, 1, r - 1, 1 << 15, glvp.lam, r - glvp.lam, glvp.max_abs,
          r - glvp.max_abs]
    rng = random.Random(14)
    want = {(True, False), (False, True), (True, True)}
    while want:
        k = rng.randrange(r)
        n1, _, n2, _ = glvp.split_signed(k)
        if (n1, n2) in want:
            want.discard((n1, n2))
            ks.append(k)
    return ks


def glv_args(curve, logn: int) -> tuple:
    """What the device program hands `glv.glv_rows` at one size: the wire
    limbs (int16), the (18, n) halfwords (uint16), the GLV config."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    return (torch.from_numpy(xs.astype(np.int16)).to(DEVICE),
            torch.from_numpy(ys.astype(np.int16)).to(DEVICE),
            torch.from_numpy(hw.astype(np.uint16)).to(DEVICE),
            config(curve, logn, True))


def glv_check(curve, args, tag: str, card: str, reps: int) -> dict:
    """[apply_glv]: the GLV kernel's rows form, `glv_rows`, against
    `glv_rows_plain` on what stage 1 hands it (xs, ys, hw, cfg: the wire
    limbs, encoded in the kernel) with the edge scalars in the first
    lanes, timed; the digits of the one
    `decompose_digits`, Wp rows, against the plain version's; the edge
    lanes' signs and magnitudes against the python ints; then stage 1
    under GLV (`glv.glv_rows`, two launches) whole, timed."""
    xs, ys, hw, cfg = args
    glvp = cfg.glv_params
    ks = glv_edge_scalars(glvp)
    h = hw.cpu().numpy().copy()
    h[:16, :len(ks)] = np.array([int_to_limbs(k, 16, 16) for k in ks]).T
    hw = torch.from_numpy(h).to(hw.device)
    res = compare(curve, "glv_apply", "glv_rows", (xs, ys, hw, curve, glvp),
                  {}, tag, card, reps)
    _, mags, neg1, neg2 = kernels.glv_rows(xs, ys, hw, curve, glvp)
    W, s, Wp = cfg.num_windows, cfg.window_size, cfg.padded_windows
    digits = glv_dev.glv_rows(xs, ys, hw, cfg)[1]
    plain = kernels.glv_rows_plain(xs, ys, hw, curve, glvp)[1]
    if not torch.equal(digits, kernels.decompose_digits_plain(plain, s, W,
                                                              Wp)):
        raise AssertionError(f"glv_rows at {tag}: digits differ from the "
                             "plain version's")
    n, m = xs.shape[1], mags[:, :len(ks)].cpu().tolist()
    m2 = mags[:, n:n + len(ks)].cpu().tolist()
    val = lambda rows_, i: sum(int(v[i]) << (16 * j)
                               for j, v in enumerate(rows_))
    for i, k in enumerate(ks):
        got = (bool(neg1[i]), val(m, i), bool(neg2[i]), val(m2, i))
        if got != glvp.split_signed(k):
            raise AssertionError(f"glv_apply at {tag}: edge scalar {k} "
                                 f"splits to {got}")
    ms = cuda_ms(lambda: glv_dev.glv_rows(xs, ys, hw, cfg), reps)
    print(f"[apply_glv] {curve.name} {tag}: glv_apply's rows form "
          f"(glv_rows, the wire limbs encoded in the kernel) bit-identical "
          f"to its plain version on {n} points, {len(ks)} edge scalars "
          f"among them (each equal to the python-int split); the digits "
          f"of the one decompose_digits equal; "
          f"glv_rows {res['ms']:.4f} ms, plain {res['plain_ms']:.1f} ms; "
          f"stage 1 under GLV (glv_rows + decompose_digits, back to back) "
          f"{ms:.4f} ms [{card}]", flush=True)
    return dict(res, apply_glv_ms=ms, edge_scalars=len(ks))


def main_path(curve, logn: int, card: str, glv: bool = False):
    """Phase 6 (or, with glv, phase 7) at one size. Returns the launch
    counts of the user call, the timings, the threads per lane that the
    user call's scans were launched with, and the geometry its pbpr_full
    and its last extract_buckets were launched with."""
    n = 1 << logn
    cfg = config(curve, logn, glv)
    _, _, hw, base, want = inputs(curve, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    label = "msm-glv" if glv else "msm"

    kernels.reset_launches()
    kernels.LAUNCHED.clear()
    t0 = time.perf_counter()
    got = tpu_variable_base_msm(points, scalars, curve=curve, device=DEVICE,
                                config=cfg if glv else None)
    t_user = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    scan_G = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    pbpr_geo = dict(kernels.LAUNCHED["pbpr_full"])
    ext_geo = dict(kernels.LAUNCHED["extract_buckets"])
    if not ref.jac_eq(curve, got, want):
        raise AssertionError(f"2^{logn} {label}: MSM result differs from "
                             "the oracle")
    idle = [k for k in path_kernels(glv) if launches[k] == 0]
    if idle:
        raise AssertionError(f"2^{logn} {label}: kernels not launched: {idle}")
    # stage 1 is two launches: encode_rows and decompose_digits, under GLV
    # glv_apply (its rows form) and decompose_digits; encode_mont none
    stage1 = {k: launches[k] for k in ("encode_rows", "glv_apply",
                                       "decompose_digits", "encode_mont")}
    want1 = dict(encode_rows=0 if glv else 1, glv_apply=1 if glv else 0,
                 decompose_digits=1, encode_mont=0)
    if stage1 != want1:
        raise AssertionError(f"2^{logn} {label}: stage 1 launched {stage1}, "
                             f"expected {want1}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[{label}] {curve.name} n=2^{logn} tpu_variable_base_msm EXACT "
          f"in {t_user:.2f} s"
          f" (host pack included) launches={used}, the scan with {scan_G} "
          f"threads a lane, pbpr_full launched {pbpr_geo}, the last "
          f"extract_buckets launched {ext_geo} [{card}]", flush=True)

    return (launches, *timed_runs(cfg, logn, label, card), scan_G, pbpr_geo,
            ext_geo)


def timed_runs(cfg: MSMConfig, logn: int, label: str, card: str,
               runs: int = 3):
    """Bench-style timing: int16/uint16 wire inputs, staged h2d timed
    apart, then window_sums + host Horner; the median of `runs`, each
    EXACT."""
    n = 1 << logn
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, _, want = inputs(cfg.curve, logn)
    wire = (xs.astype(np.int16), ys.astype(np.int16),
            np.concatenate([hw, np.zeros((2, n), np.uint32)]).astype(np.uint16))
    times, h2ds = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_in = [torch.from_numpy(a).to(DEVICE) for a in wire]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc = pipe.horner(pipe.window_sums(*dev_in))
        t2 = time.perf_counter()
        if not ref.jac_eq(cfg.curve, acc, want):
            raise AssertionError(f"2^{logn} {label}: timed run differs from "
                                 "the oracle")
        h2ds.append((t1 - t0) * 1e3)
        times.append((t2 - t1) * 1e3)
    ms, h2d = statistics.median(times), statistics.median(h2ds)
    lanes = (2 if cfg.glv else 1) * n
    print(f"[{label}] {cfg.curve.name} n=2^{logn} s={cfg.window_size} "
          f"W={cfg.num_windows} "
          f"groups={cfg.num_groups} stream={lanes} lanes C={cfg.columns} "
          f"T={cfg.pbpr_threads} Wg={cfg.subtask_group}: device+decode+"
          f"horner median {ms:.2f} ms of {[round(t, 2) for t in times]}, "
          f"h2d {h2d:.2f} ms, EXACT [{card}]", flush=True)
    return ms, h2d


def schedule_run(card: str):
    """The largest size under SCHEDULE: launch counts of one run, then
    the timed runs. Recorded beside the default schedule, not the default."""
    logn = max(SIZES)
    cfg = MSMConfig(curve=CURVE, **SCHEDULE)
    lanes = cfg.subtask_group * cfg.columns
    kernels.reset_launches()
    kernels.LAUNCHED.clear()
    ms, h2d = timed_runs(cfg, logn, "schedule", card)
    G = kernels.LAUNCHED["prefix_scan"]["threads_per_lane"]
    col = kernels.LAUNCHED["col_prefix"]
    used = {k: v // 3 for k, v in kernels.LAUNCHES.items() if v}
    idle = [k for k in MAIN if k not in used]
    if idle:
        raise AssertionError(f"schedule: kernels not launched: {idle}")
    print(f"[schedule] n=2^{logn} {SCHEDULE}: {lanes} scan lanes with {G} "
          f"thread(s) a lane, col_prefix {col['blocks']} blocks x "
          f"{col['lanes_per_block']} lanes x {col['columns_per_lane']} "
          f"columns a lane; median {ms:.2f} ms; launches a run={used} "
          f"[{card}]",
          flush=True)
    return ms, used


def where_line(label: str, logn: int, launches: dict, results: dict,
               total_ms: float, card: str, extra: str = "") -> None:
    """launches x kernel time (padd_batch: mean of its two dtype forms);
    returns the kernels' sum."""
    names = path_kernels(launches["glv_apply"] > 0)
    per = {name: launches[name] * statistics.mean(
        r["ms"] for r in results.values() if r["name"] == name)
        for name in names}
    print(f"[{label}] n=2^{logn}: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per.items()) + f" ms; kernels "
        f"{sum(per.values()):.2f} of {total_ms:.2f} ms end to end{extra} "
        f"[{card}]", flush=True)
    return sum(per.values())


def affine_check(curve, logn: int, card: str, glv: bool) -> dict:
    """Phase 8: `to_affine` on the card. Its user call on the window sums,
    every launch count set to 0 just before and read just after (one
    kernel launch), against the host decode; then the kernel against its
    plain version on the window sums with four lanes more, whose Z has
    value 0, p, 2p and 3p, timed, and on an int16 copy of them; and
    `batch_inverse` against its plain version on the window sums' Z
    plane."""
    n = 1 << logn
    cfg = config(curve, logn, glv)
    pipe = get_pipeline(cfg, DEVICE)
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    g = pipeline_cuda.windows_device(
        *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
          for a in (xs, ys, hw)), cfg)
    want = pipe._decode_windows(g)
    kernels.reset_launches()
    (ax, ay, inf), ms = timed_once(lambda: to_affine(g, curve))
    launches = kernels.LAUNCHES["to_affine"]
    if launches != 1 or sum(kernels.LAUNCHES.values()) != 1:
        raise AssertionError(f"to_affine: launches {kernels.LAUNCHES}")
    if ax.device != g.device or ax.shape != g.shape[1:]:
        raise AssertionError("to_affine: wrong device or shape")
    w = curve.log_limb_size
    vals = lambda t: [curve.from_mont(sum(int(v) << (w * i) for i, v in
                                          enumerate(col)))
                      for col in t.cpu().numpy().T.tolist()]
    got = list(zip(vals(ax), vals(ay), inf.cpu().tolist()))
    for k, ((x, y, is_inf), ref_pt) in enumerate(zip(got, want)):
        host = (0, 0, True) if ref.is_inf(ref_pt) else (*ref_pt[:2], False)
        if (x, y, is_inf) != host:
            raise AssertionError(f"to_affine: window {k} differs from the "
                                 "host decode")
    if not all(is_inf for _, _, is_inf in got[len(want):]):
        raise AssertionError("to_affine: a pad window is not at infinity")

    # Z of value 0, p, 2p and 3p beside the window sums' X and Y
    L = curve.num_limbs
    edge = g[:, :, :4].clone()
    edge[2] = torch.tensor([int_to_limbs(k * curve.p, L, w) for k in
                            range(4)], dtype=torch.int32, device=g.device).T
    ge = torch.cat([g, edge], dim=2).contiguous()
    tag = (f"n=2^{logn}{' glv' if glv else ''} window sums + Z of 0, p, 2p, "
           f"3p")
    res = compare(curve, "to_affine", "to_affine", (ge, curve), {}, tag,
                  card, 5)
    k32 = to_affine(ge, curve)
    if not bool(k32[2][-4:].all()):
        raise AssertionError("to_affine: a lane of Z = 0, p, 2p or 3p is "
                             "not at infinity")
    for a, b in zip(to_affine(ge.to(torch.int16), curve), k32, strict=True):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("to_affine: int16 limbs give other bits")
    same_as_plain(f"batch_inverse on the Z plane at {tag}", "batch_inverse",
                  (g[2].contiguous(), curve))
    print(f"[affine] {curve.name} n=2^{logn}{' glv' if glv else ''} "
          f"to_affine on the "
          f"(3, L, {g.shape[2]}) window sums ({g.shape[2] - len(want)} pad "
          f"windows at infinity): one launch, equal to the host decode in "
          f"all {len(want)} windows, infinity masks agree; {ms:.3f} ms the "
          f"user call; with 4 lanes of Z = 0, p, 2p, 3p (at infinity) "
          f"bit-identical to its plain version, int32 and int16: kernel "
          f"{res['ms']:.4f} ms, plain {res['plain_ms']:.1f} ms; batch_inverse "
          f"on the window sums' Z plane bit-identical to its plain version "
          f"[{card}]",
          flush=True)
    return dict(res, user_ms=ms, launches=launches, K=ge.shape[2])


# The full-width to_affine: K = 2^AFFINE_LOGK - 3 points (not a power of
# two, so the tree's padding runs) at BN254_S12, 2^PROFILE_AFFINE_LOGK - 3
# at PROFILE_FULL; the phase's Z from a numpy generator of this seed.
AFFINE_LOGK = 20
PROFILE_AFFINE_LOGK = 16
AFFINE_SEED = 17


def affine_edge_lanes(K: int) -> list:
    """Lanes about the tree's block boundaries (blocks of 1,024 leaves,
    threads of 4, the top level's halves) and the last lane."""
    Kp = 1 << (K - 1).bit_length()
    lanes = (0, 1, 3, 4, 1023, 1024, 1025, 4095, 4096, Kp // 2 - 1, Kp // 2,
             K - 1)
    return sorted({f for f in lanes if 0 <= f < K})


def affine_points(curve, K: int):
    """K projective points made on the card: the affine points of
    gen_planar_inputs(seed=99, k_base=64) encoded to Montgomery form, a
    random Z below p from a numpy generator (AFFINE_SEED), (X Z, Y Z, Z)
    by the row multiply; then lanes of Z of value 0, p, 2p and 3p in turn
    at `affine_edge_lanes`. Returns the (3, L, K) points, the affine
    coordinates they stand for (fully reduced, zero at the edge lanes),
    the infinity mask and the edge lanes."""
    L, w = curve.num_limbs, curve.log_limb_size
    xs, ys, _, _, _ = inputs(curve, (K - 1).bit_length())
    t = lambda a: torch.from_numpy(a[:, :K].astype(np.int32)).to(DEVICE)
    xm, ym = kernels.encode_mont(t(xs), curve), kernels.encode_mont(t(ys),
                                                                   curve)
    rng = np.random.default_rng(AFFINE_SEED)
    z = rng.integers(0, 1 << w, (L, K)).astype(np.int32)
    z[-1] = rng.integers(0, curve.p >> (w * (L - 1)), K)     # below p
    z = torch.from_numpy(z).to(DEVICE)
    pts = torch.stack([rows.mont_mul_rows(xm, z, curve),
                       rows.mont_mul_rows(ym, z, curve), z])
    edges = affine_edge_lanes(K)
    pts[2][:, edges] = torch.tensor(
        [int_to_limbs(i % 4 * curve.p, L, w) for i in range(len(edges))],
        dtype=torch.int32, device=pts.device).T
    inf = torch.zeros(K, dtype=torch.bool, device=pts.device)
    inf[edges] = True
    want = [torch.where(inf, 0, inverse.reduce_once(c, curve))
            for c in (xm, ym)]
    return pts, want[0], want[1], inf, edges


def counted(name: str, fn):
    """fn() with every launch count set to 0 just before and read just
    after: the wrapper `name` launched the plan of
    `batch_inverse_geometry` and nothing else launched."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    out, ms = timed_once(fn)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    K = kernels.LAUNCHED[name]["K"]
    want = len(kernels.batch_inverse_geometry(K).launches)
    if launches != {name: want}:
        raise AssertionError(f"{name}: launches {launches}, want "
                             f"{ {name: want} }")
    return out, ms, want


def tree_split(curve, a: torch.Tensor, reps: int = 5) -> dict:
    """{up, top, down: ms} of `batch_inverse` on the (L, K) limbs `a`:
    each launch of its plan (`batch_inverse_geometry`) on its own between
    CUDA events, as the wrapper enqueues them, the mean of `reps` calls
    after one warm-up; and `one`: the whole call on one element, the
    root's chain and little else."""
    L, w = curve.num_limbs, curve.log_limb_size
    flat = a.to(torch.int32).reshape(L, -1).contiguous()
    K = flat.shape[1]
    geo = kernels.batch_inverse_geometry(K)
    N = -(-L * w // 32)
    out = torch.empty_like(flat)
    zero = torch.empty(K, dtype=torch.uint8, device=flat.device)
    scratch = torch.empty((N, geo.scratch_nodes), dtype=torch.int32,
                          device=flat.device)
    consts = kernels._affine_consts(curve)
    lib = _build.library()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(len(geo.launches) + 1)]
    total = [0.0] * len(geo.launches)
    for rep in range(reps + 1):
        ev[0].record()
        for i, ln in enumerate(geo.launches):
            rc = lib.msm_batch_inverse(
                L, w, flat.data_ptr(), K, out.data_ptr(), zero.data_ptr(),
                scratch.data_ptr(), geo.Kp, ln.lo, ln.n, ln.d, ln.roles,
                ln.blocks, ctypes.addressof(consts), len(consts), stream)
            if rc:
                raise RuntimeError(f"batch_inverse launch {i}: rc {rc}")
            ev[i + 1].record()
        ev[-1].synchronize()
        if rep:
            for i in range(len(geo.launches)):
                total[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    if not torch.equal(out, kernels.batch_inverse(flat, curve)):
        raise AssertionError("tree_split: the launches one at a time give "
                             "other inverses")
    role = {kernels.TREE_UP: "up", kernels.TREE_DOWN: "down"}
    split = {}
    for ln, t in zip(geo.launches, total):
        k = role.get(ln.roles, "top")
        split[k] = split.get(k, 0.0) + t
    one = flat[:, :1].contiguous()
    split["one"] = cuda_ms(lambda: kernels.batch_inverse(one, curve), 10)
    return split


def affine_full(curve, logk: int, card: str) -> dict:
    """Phase 8 at full width: `to_affine` on K = 2^logk - 3 points made
    on the card (`affine_points`), its user call counted (the tree's
    launches, nothing else), equal to the known affine points with
    infinity exactly at the edge lanes; against `to_affine_plain`, run
    once, bit for bit, int32 and int16, and timed. Then `batch_inverse`
    on their Z plane with the edge lanes of 2p and 3p made 0 and p (zero
    by the value test it keeps), counted, against the plain
    `batch_inverse` run once, bit for bit, zero at the edge lanes and an
    inverse by value (a z^-1 z = 1) at the others, and timed."""
    K = (1 << logk) - 3
    pts, wx, wy, winf, edges = affine_points(curve, K)
    (ax, ay, inf), user_ms, launches = counted(
        "to_affine", lambda: to_affine(pts, curve))
    if not (torch.equal(ax, wx) and torch.equal(ay, wy)
            and torch.equal(inf, winf)):
        raise AssertionError(f"to_affine at K={K}: not the known affine "
                             "points")
    tag = f"K={K} (Z of 0, p, 2p, 3p at {len(edges)} lanes)"
    res = compare(curve, "to_affine", "to_affine", (pts, curve), {}, tag,
                  card, 5)
    for a, b in zip(to_affine(pts.to(torch.int16), curve), (ax, ay, inf),
                    strict=True):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError("to_affine: int16 limbs give other bits")

    L, w = curve.num_limbs, curve.log_limb_size
    z = pts[2].clone()
    z[:, edges] = torch.tensor(
        [int_to_limbs(i % 2 * curve.p, L, w) for i in range(len(edges))],
        dtype=torch.int32, device=z.device).T
    zinv, inv_user_ms, inv_launches = counted(
        "batch_inverse", lambda: batch_inverse(z, curve))
    one = rows.mont_mul_rows(zinv, z, curve)
    want_one = torch.where(winf, 0, inverse.reduce_once(
        rows.mont_one_rows(curve, z), curve))
    if (not torch.equal(torch.where(winf, 0, inverse.reduce_once(one, curve)),
                        want_one) or bool(zinv[:, edges].any())):
        raise AssertionError(f"batch_inverse at K={K}: not the inverses")
    res_inv = compare(curve, "batch_inverse", "batch_inverse", (z, curve), {},
                      f"K={K} (the Z plane, 0 and p at {len(edges)} lanes)",
                      card, 5)
    split = tree_split(curve, z)
    print(f"[affine] {curve.name} K={K}: to_affine's user call "
          f"{launches} launches ({kernels.LAUNCHED['to_affine']['plan']}), "
          f"{user_ms:.4f} ms, equal to the known affine points, infinity "
          f"exactly at the {len(edges)} edge lanes; bit-identical to "
          f"to_affine_plain, int32 and int16: kernel {res['ms']:.4f} ms, "
          f"plain {res['plain_ms']:.1f} ms once, bound {res['bound_ms']:.4f} "
          f"ms ({res['bound_by']}); batch_inverse on the Z plane "
          f"{inv_launches} launches, {inv_user_ms:.4f} ms the user call, "
          f"bit-identical to the plain batch_inverse, zero at the edges, "
          f"z^-1 z = 1 elsewhere: kernel {res_inv['ms']:.4f} ms, plain "
          f"{res_inv['plain_ms']:.1f} ms once, bound "
          f"{res_inv['bound_ms']:.4f} ms ({res_inv['bound_by']}); its "
          f"launches one at a time: up {split['up']:.4f} ms, top (the top "
          f"levels and the root's chain on {chain_form(curve)}) "
          f"{split['top']:.4f}, "
          f"down {split['down']:.4f}; on one element (the chain) "
          f"{split['one']:.4f} ms [{card}]", flush=True)
    return dict(to_affine=dict(res, user_ms=user_ms, launches=launches, K=K),
                batch_inverse=dict(res_inv, user_ms=inv_user_ms,
                                   launches=inv_launches, K=K, split=split))


def run_profile(curve, sizes, card: str) -> dict:
    """A profile beyond BN254_S12 through the main path. At each size:
    the seven kernels of the main path, `pbpr_stage1`, `globalize` and
    `pdbl_batch` against their plain versions on the shapes the run gives
    them, the scan for every number of threads per lane, the reduction
    and globalisation paths (phases 3 to 5), and `glv_apply` against its
    plain version (`[apply_glv]`). Then the MSM at every size,
    EXACT, counted and timed (phase 6); for PROFILE_FULL the GLV MSM and
    the [latency] line (phase 7), to_affine on the window sums of the
    smallest size and `affine_full` at K = 2^PROFILE_AFFINE_LOGK - 3
    (phase 8); a [where] line for each size."""
    t0 = time.perf_counter()
    warm_plain(curve)
    checked, nine, glv_checks = {}, {}, {}
    for logn in sizes:
        reps = 5 if logn < 20 else 3
        tag = f"n=2^{logn}"
        seen = capture_inputs(curve, logn, False)
        checked[logn] = check_main_kernels(curve, seen, tag, card, reps)
        scan_sweep(curve, seen, tag, card, reps)
        nine[logn] = check_nine(curve, seen, logn, card, reps,
                                checked[logn]["pbpr_full"]["ms"])
        del seen
        glv_checks[logn] = glv_check(curve, glv_args(curve, logn),
                                     f"n=2^{logn} glv", card, reps)
        torch.cuda.empty_cache()
    runs = {logn: main_path(curve, logn, card) for logn in sizes}
    out = dict(checked=checked, nine=nine, runs=runs, glv_checks=glv_checks)
    if curve is PROFILE_FULL:
        small = min(sizes)
        out["glv"] = main_path(curve, small, card, glv=True)
        out["affine"] = affine_check(curve, small, card, glv=False)
        out["affine_full"] = affine_full(curve, PROFILE_AFFINE_LOGK, card)
        out["latency"] = latency(curve, card, runs[max(sizes)][3])
        out["scan_by_lanes"] = lane_sweep(curve, card)
    for logn in sizes:
        where_line("where", logn, runs[logn][0], checked[logn],
                   runs[logn][1], card, f" ({curve.name})")
    out["seconds"] = time.perf_counter() - t0
    print(f"[profile] {curve.name}: every phase passed in "
          f"{out['seconds']:.1f} s [{card}]", flush=True)
    return out


def profile_entry(name: str, prof: dict) -> dict:
    """What the JSON line keeps of one kernel at one profile of PROFILES:
    the time, bound, launches, error and plain time at each size of its
    MSM."""
    out = {}
    sizes = sorted(prof["runs"])
    if name in ("to_affine", "batch_inverse"):
        # PROFILE_FULL only: K = 2^PROFILE_AFFINE_LOGK - 3 points, and
        # to_affine on the window sums of the smallest size
        if "affine_full" not in prof:
            return None
        r = prof["affine_full"][name]
        out = {"launches": r["launches"], "ms": r["ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "x_bound": r["ms"] / r["bound_ms"],
               "max_abs_err": r["max_abs_err"], "plain_ms": r["plain_ms"],
               "library_ms": None, "at": f"K={r['K']}"}
        if name == "to_affine":
            w = prof["affine"]
            out.update(launches_window_sums=w["launches"],
                       ms_window_sums=w["ms"],
                       bound_ms_window_sums=w["bound_ms"],
                       max_abs_err_window_sums=w["max_abs_err"],
                       plain_ms_window_sums=w["plain_ms"],
                       at_window_sums=f"n=2^{min(sizes)} window sums")
        return out
    for logn in sizes:
        sfx = "" if logn == max(sizes) else f"_2p{logn}"
        if name == "glv_apply":
            r = prof["glv_checks"][logn]
            glv_run = prof.get("glv") if logn == min(sizes) else None
            out.update({f"launches_glv{sfx}": glv_run and glv_run[0][name],
                        f"ms{sfx}": r["ms"], f"bound_ms{sfx}": r["bound_ms"],
                        f"bound_by{sfx}": r["bound_by"],
                        f"x_bound{sfx}": r["ms"] / r["bound_ms"],
                        f"max_abs_err{sfx}": r["max_abs_err"],
                        f"plain_ms{sfx}": r["plain_ms"],
                        f"apply_glv_ms{sfx}": r["apply_glv_ms"],
                        f"library_ms{sfx}": None})
            continue
        nine = prof["nine"][logn]
        r = next(v for v in (*prof["checked"][logn].values(),
                             *nine["results"].values()) if v["name"] == name)
        if name in MAIN or name == "encode_mont":
            launches = prof["runs"][logn][0][name]
        elif name == "globalize":
            launches = nine["globalize_launches"]
        else:
            launches = nine["reduce_launches"][name]
        out.update({f"launches{sfx}": launches, f"ms{sfx}": r["ms"],
                    f"bound_ms{sfx}": r["bound_ms"],
                    f"bound_by{sfx}": r["bound_by"],
                    f"x_bound{sfx}": r["ms"] / r["bound_ms"],
                    f"max_abs_err{sfx}": r["max_abs_err"],
                    f"plain_ms{sfx}": r["plain_ms"],
                    f"library_ms{sfx}": r.get("library_ms")})
        if name in WIDE:
            out[f"bound_ms_mont_mul_ops{sfx}"] = r["bound_ms_mont_mul_ops"]
    return out


# ---------------------------------------------------------------------------
# [sharded]: the multi-device MSM (tpu_msm_torch/parallel/sharded.py)
# ---------------------------------------------------------------------------

SHARDED_LOGN = 20
# window shards of one process: 16 windows in 16 groups at 2^20
SHARDED_W = (2, 4)
# (x, w) meshes of the ranks that share the card over gloo
SHARDED_MESHES = ({"x": 2}, {"x": 2, "w": 2})
# the XLA path (backend="xla") sharded over x = 2 gloo ranks on the card
SHARDED_XLA_LOGN = 16
# A rank's collectives fail after RANK_GROUP_TIMEOUT_S; a world whose
# ranks have not all reported by RANK_DEADLINE_S fails the phase.
RANK_GROUP_TIMEOUT_S = 120
RANK_DEADLINE_S = 240.0
SHARED = "ranks sharing one card; not multi-GPU scaling"


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_label(shape: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in shape.items())


def sharded_inputs(logn: int):
    """The planar inputs of the 2^logn MSM as int32 device tensors, with
    the two pad rows of the halfwords."""
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(CURVE, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    return [torch.from_numpy(a.astype(np.int32)).to(DEVICE)
            for a in (xs, ys, hw)]


def window_shards(card: str) -> dict:
    """Phase [sharded] 1: `windows_device` at every w of SHARDED_W and
    every w_index in one process. The shards concatenated decode to the
    unsharded window sums and their Horner sum to the oracle's; pbpr_full's
    launch at Wp_l = Wp / w is the one `pbpr_full_geometry` gives; on the
    first shard at the largest w, pbpr_full and the first group's scan,
    column prefix and extraction adds are held against their plain
    versions and timed."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    want = inputs(CURVE, logn)[4]
    pipe = get_pipeline(cfg, DEVICE)
    dev_in = sharded_inputs(logn)
    run = lambda **kw: pipeline_cuda.windows_device(*dev_in, cfg, **kw)
    full = pipe._decode_windows(run())
    full_ms = statistics.median(timed_once(run)[1] for _ in range(3))
    B, T = cfg.half_columns, min(cfg.pbpr_threads, cfg.half_columns)
    limits = kernels._pbpr_full_limits(CURVE, dev_in[0].device)
    out = dict(full_ms=full_ms, shards={})
    seen = {}
    for w in SHARDED_W:
        Wl = cfg.padded_windows // w
        shards = []
        for i in range(w):
            targets = [(kernels, k) for k in ("prefix_scan", "col_prefix",
                                              "bucket_sort",
                                              "extract_buckets",
                                              "pbpr_full")]
            with spy(seen if (w, i) == (max(SHARDED_W), 0) else {},
                     targets):
                shards.append(run(w_shards=w, w_index=i))
            sync(DEVICE)
        launched = dict(kernels.LAUNCHED["pbpr_full"])
        says = kernels.pbpr_full_launched(kernels.pbpr_full_geometry(
            Wl, B, T, *limits, CURVE.num_limbs, CURVE.log_limb_size))
        if launched != says:
            raise AssertionError(f"[sharded] w={w}: pbpr_full launched "
                                 f"{launched}, its geometry says {says}")
        got = pipe._decode_windows(torch.cat(shards, dim=2))
        for j, (a, b) in enumerate(zip(got, full, strict=True)):
            if not ref.jac_eq(CURVE, a, b):
                raise AssertionError(f"[sharded] w={w}: window {j} differs "
                                     "from the unsharded window sums")
        if not ref.jac_eq(CURVE, pipe.horner(got), want):
            raise AssertionError(f"[sharded] w={w}: MSM differs from the "
                                 "oracle")
        ms = [statistics.median(timed_once(
            lambda: run(w_shards=w, w_index=i))[1] for _ in range(3))
            for i in range(w)]
        out["shards"][w] = dict(Wp_l=Wl, ms=ms, pbpr_full_launched=launched)
        print(f"[sharded] {CURVE.name} n=2^{logn} window shards w={w} "
              f"(Wp_l={Wl}, {cfg.num_groups // w} groups a shard): "
              f"concatenated equal to the unsharded window sums, EXACT; "
              f"each shard median of 3 "
              f"{[round(t, 2) for t in ms]} ms against {full_ms:.2f} ms "
              f"unsharded; pbpr_full launched {launched} [{card}]",
              flush=True)
    tag = f"n=2^{logn} w={max(SHARDED_W)} shard 0"
    out["kernels"] = {key: compare(CURVE, key, name, args, kw, tag, card, 3)
                      for key, (name, args, kw, _) in seen.items()}
    return out


def rank_spans(card: str) -> dict:
    """The kernels of the gloo ranks' paths, in one process before the
    spawns: for each mesh of SHARDED_MESHES, `windows_device` on rank 0's
    span of the 2^20 points (n / x of them, under the 2^20 schedule, as
    `ShardedMSMPipeline.window_sums` slices it) at its first window shard
    (w_index 0 of w; at w = 2, pbpr_full at Wp_l = 8). Every kernel call
    of the main path is kept by `spy` and held against its plain version
    on the same inputs, then timed."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    dev_in = sharded_inputs(logn)
    targets = [(kernels, k) for k in MAIN]
    out = {}
    for shape in SHARDED_MESHES:
        x, w = shape["x"], shape.get("w", 1)
        span = [a[:, :a.shape[1] // x] for a in dev_in]
        with spy({}, targets) as seen:
            pipeline_cuda.windows_device(*span, cfg, w_shards=w, w_index=0)
            sync(DEVICE)
        tag = (f"n=2^{logn} span 0 of x={x}"
               + (f", w-shard 0 of {w}" if w > 1 else ""))
        out[mesh_label(shape)] = check_main_kernels(CURVE, seen, tag, card,
                                                    3)
    return out


def reduce_tree_check(card: str) -> dict:
    """`_reduce_gathered` on the (3, L, ndev, Wp) window sums of the ndev
    spans of the 2^20 points, as ndev ranks on "x" gather them, at
    ndev = 2 (the gloo meshes' x) and 4: bit-identical to the same tree
    of plain adds, each level's `padd_batch` against its plain version,
    and the sums equal to the unsharded window sums."""
    logn = SHARDED_LOGN
    cfg = config(CURVE, logn, False)
    pipe = get_pipeline(cfg, DEVICE)
    dev_in = sharded_inputs(logn)
    full = pipe._decode_windows(pipeline_cuda.windows_device(*dev_in, cfg))
    out = {}
    for ndev in (2, 4):
        q = dev_in[0].shape[1] // ndev
        stack = torch.stack([pipeline_cuda.windows_device(
            *(a[:, k * q:(k + 1) * q] for a in dev_in), cfg)
            for k in range(ndev)], dim=2)
        kernels.reset_launches()
        got = sharded._reduce_gathered(stack, CURVE, ndev)
        sync(DEVICE)
        launches = kernels.LAUNCHES["padd_batch"]
        g, d, levels = stack, ndev, {}
        while d > 1:
            h = d // 2
            key = f"padd_batch[reduce {d}->{h}]"
            levels[key] = compare(CURVE, key, "padd_batch",
                                  (g[:, :, :h], g[:, :, h:d], CURVE), {},
                                  f"n=2^{logn} tree of {ndev}", card, 5)
            g, d = kernels.padd_batch_plain(g[:, :, :h], g[:, :, h:d],
                                            CURVE), h
        if not torch.equal(got, g[:, :, 0]):
            raise AssertionError(f"[sharded] _reduce_gathered of {ndev} "
                                 "differs from the tree of plain adds")
        for j, (a, b) in enumerate(zip(pipe._decode_windows(got), full,
                                       strict=True)):
            if not ref.jac_eq(CURVE, a, b):
                raise AssertionError(f"[sharded] tree of {ndev} spans: "
                                     f"window {j} differs from the "
                                     "unsharded window sums")
        if launches != ndev.bit_length() - 1:
            raise AssertionError(f"[sharded] tree of {ndev} launched "
                                 f"padd_batch {launches} times")
        print(f"[sharded] _reduce_gathered on {tuple(stack.shape)}: "
              f"{launches} padd_batch launches, bit-identical to the tree "
              f"of plain adds, equal to the unsharded window sums [{card}]",
              flush=True)
        out[ndev] = dict(launches=launches, levels=levels)
    return out


def exchange_timed(g: torch.Tensor, mesh, device: str, reps: int = 3):
    """`sharded.exchange` of this rank's window sums `g`, called on its
    own after a barrier: (its result, the median of `reps` host times
    between synchronizes in ms, the padd_batch launches of one call)."""
    times = []
    for _ in range(reps):
        dist.barrier()
        sync(device)
        t0 = time.perf_counter()
        kernels.reset_launches()
        out = sharded.exchange(g, mesh, CURVE)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times), kernels.LAUNCHES["padd_batch"]


def sharded_nccl(card: str) -> dict:
    """Phase [sharded] 2: `sharded_msm` on a mesh (1,) of one NCCL rank,
    the user's entry point on the 2^20 points, EXACT, every kernel of
    the path counted (reset before, read after); then the exchange on
    its own."""
    logn = SHARDED_LOGN
    n = 1 << logn
    _, _, hw, base, want = inputs(CURVE, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        if DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/rendezvous", rank=0,
            world_size=1,
            timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
        try:
            mesh = init_device_mesh(DEVICE, (1,), mesh_dim_names=("x",))
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = sharded.sharded_msm(points, scalars, mesh, curve=CURVE,
                                      device=DEVICE)
            t_user = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            g = pipeline_cuda.windows_device(*sharded_inputs(logn),
                                             config(CURVE, logn, False))
            reduced, exchange_ms, tree = exchange_timed(g, mesh, DEVICE)
        finally:
            dist.destroy_process_group()
    if not ref.jac_eq(CURVE, got, want):
        raise AssertionError("[sharded] one NCCL rank: MSM differs from the "
                             "oracle")
    if not torch.equal(reduced, g):
        raise AssertionError("[sharded] one NCCL rank: the exchange changed "
                             "the window sums")
    idle = [k for k in MAIN if launches[k] == 0]
    if idle:
        raise AssertionError(f"[sharded] one NCCL rank: kernels not "
                             f"launched: {idle}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[sharded] {CURVE.name} n=2^{logn} sharded_msm on a mesh (1,) of "
          f"one {backend} rank EXACT in {t_user:.2f} s (host pack "
          f"included); the exchange on its own, median of 3, "
          f"{exchange_ms:.3f} ms; launches={used} [{card}]", flush=True)
    return dict(backend=backend, seconds=t_user, launches=used,
                exchange_tree_ms=exchange_ms, tree_launches=tree)


def sharded_rank(rank: int, world: int, shape: dict, workdir: str, want,
                 device: str) -> dict:
    """One rank of a gloo world on `device` (spawned; the library is
    already built): the sharded pipeline's window sums of the 2^20
    points handed over in workdir, once counted and EXACT, then the
    median of 3, each EXACT; then the exchange on its own, its result
    equal to the pipeline's window sums."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous-"
        f"{mesh_label(shape)}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device, tuple(shape.values()),
                                mesh_dim_names=tuple(shape))
        dev_in = [torch.from_numpy(np.load(os.path.join(
            workdir, f"{k}.npy"))).to(device) for k in ("xs", "ys", "hw")]
        cfg = default_config(dev_in[0].shape[1], CURVE)
        pipe = sharded.get_sharded_pipeline(cfg, mesh, device)
        kernels.reset_launches()
        windows = pipe.window_sums(*dev_in)
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        exact = ref.jac_eq(CURVE, pipe.horner(windows), want)
        times = []
        for _ in range(3):
            sync(device)
            t0 = time.perf_counter()
            windows = pipe.window_sums(*dev_in)
            times.append((time.perf_counter() - t0) * 1e3)
            exact = exact and ref.jac_eq(CURVE, pipe.horner(windows), want)
        # this rank's own sums, as window_sums computes them, exchanged
        x, w = shape["x"], shape.get("w", 1)
        span = dev_in[0].shape[1] // x
        lo = mesh.get_local_rank("x") * span
        g = pipeline_cuda.windows_device(
            *(a[:, lo:lo + span] for a in dev_in), cfg, w_shards=w,
            w_index=mesh.get_local_rank("w") if w > 1 else 0)
        reduced, exchange_ms, tree = exchange_timed(g, mesh, device)
        exact = exact and pipe._decode_windows(reduced) == windows
        return dict(rank=dist.get_rank(), exact=exact, launches=launches,
                    tree_launches=tree, window_sums_ms=times,
                    exchange_tree_ms=exchange_ms)
    finally:
        dist.destroy_process_group()


def sharded_gloo(card: str) -> dict:
    """Phase [sharded] 3: the meshes of SHARDED_MESHES, their ranks
    spawned on this one card over gloo (`parallel.spawn.run_ranks`), the
    2^20 inputs handed over in .npy files. Every rank EXACT and every
    kernel of the path launched on it; each rank's window_sums time and
    its exchange + tree time."""
    logn = SHARDED_LOGN
    n = 1 << logn
    xs, ys, hw, _, want = inputs(CURVE, logn)
    wire = dict(xs=xs.astype(np.int16), ys=ys.astype(np.int16),
                hw=np.concatenate([hw, np.zeros((2, n), np.uint32)]
                                  ).astype(np.uint16))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, a in wire.items():
            np.save(os.path.join(tmp, f"{k}.npy"), a)
        for shape in SHARDED_MESHES:
            label = mesh_label(shape)
            t0 = time.perf_counter()
            ranks = spawn.run_ranks(sharded_rank, math.prod(shape.values()),
                                    (shape, tmp, want, DEVICE),
                                    RANK_DEADLINE_S)
            seconds = time.perf_counter() - t0
            x = shape["x"]
            for res in ranks:
                idle = [k for k in MAIN if k not in res["launches"]]
                if not res["exact"] or idle:
                    raise AssertionError(f"[sharded] {label} rank "
                                         f"{res['rank']}: exact="
                                         f"{res['exact']}, not launched "
                                         f"{idle}")
                if res["tree_launches"] != x.bit_length() - 1:
                    raise AssertionError(f"[sharded] {label}: the tree "
                                         f"launched {res['tree_launches']}"
                                         " times")
            out[label] = dict(seconds=seconds, ranks=ranks)
            print(f"[sharded] {CURVE.name} n=2^{logn} mesh {label}, "
                  f"{len(ranks)} gloo {SHARED}: every rank EXACT; "
                  + "; ".join(
                      f"rank {r['rank']} window_sums median "
                      f"{statistics.median(r['window_sums_ms']):.2f} ms of "
                      f"{[round(t, 2) for t in r['window_sums_ms']]}, "
                      f"exchange + tree on its own, median of 3, "
                      f"{r['exchange_tree_ms']:.3f} ms, "
                      f"launches={r['launches']}" for r in ranks)
                  + f"; {seconds:.1f} s from spawn to exit [{card}]",
                  flush=True)
    return out


def sharded_xla_rank(rank: int, world: int, logn: int, workdir: str, want,
                     device: str) -> dict:
    """One rank of the gloo world of the sharded XLA path (spawned; the
    library is already built): `window_sums` of its pipeline under
    backend="xla" on mesh x = world, counted and EXACT; then its own
    span's window sums, as the pipeline's device program computes them
    before the exchange."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{workdir}/rendezvous-xla", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=RANK_GROUP_TIMEOUT_S))
    try:
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("x",))
        dev_in = [torch.from_numpy(np.load(os.path.join(
            workdir, f"{k}.npy")).astype(np.int32)).to(device)
            for k in ("xs", "ys", "hw")]
        n = dev_in[0].shape[1]
        cfg = twin_config(CURVE, logn, False)
        pipe = sharded.get_sharded_pipeline(cfg, mesh, device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        windows = pipe.window_sums(*dev_in)
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        exact = ref.jac_eq(CURVE, pipe.horner(windows), want)
        span = n // world
        lo = mesh.get_local_rank("x") * span
        g = pipeline._windows_device(*(a[:, lo:lo + span] for a in dev_in),
                                     cfg)
        return dict(rank=dist.get_rank(), exact=exact, launches=launches,
                    windows=windows, span_sums=g.cpu().numpy(),
                    window_sums_ms=ms)
    finally:
        dist.destroy_process_group()


def sharded_xla(card: str) -> dict:
    """Phase [sharded] 4: the XLA path over x = 2 gloo ranks spawned on
    this one card, BN254_S12 at 2^SHARDED_XLA_LOGN: every rank EXACT, one
    `smvp_stitch` and one `smvp_rows` launch a window group of its span,
    its window sums, decoded, equal to the unsharded twin's (this
    process's `_windows_device` on all the points), and its span's sums
    before the exchange bit for bit this process's on the same span.
    (After the exchange the sums are the tree's adds of the two spans'
    limbs, not the unsharded sums' limbs, which are not unique: they are
    equal as points, here as decoded affine integers.)"""
    logn, world = SHARDED_XLA_LOGN, 2
    n = 1 << logn
    xs, ys, hw, _, want = inputs(CURVE, logn)
    cfg = twin_config(CURVE, logn, False)
    dev_in = sharded_inputs(logn)
    unsharded = get_pipeline(cfg, DEVICE)._decode_windows(
        pipeline._windows_device(*dev_in, cfg))
    with tempfile.TemporaryDirectory() as tmp:
        for k, a in (("xs", xs), ("ys", ys), ("hw", dev_in[2].cpu().numpy())):
            np.save(os.path.join(tmp, f"{k}.npy"), a)
        t0 = time.perf_counter()
        ranks = spawn.run_ranks(sharded_xla_rank, world,
                                (logn, tmp, want, DEVICE), RANK_DEADLINE_S)
        seconds = time.perf_counter() - t0
    span = n // world
    for res in ranks:
        lo = res["rank"] * span
        mine = pipeline._windows_device(*(a[:, lo:lo + span]
                                          for a in dev_in), cfg)
        L = res["launches"]
        bad = [k for k in ("smvp_rows", "smvp_stitch", "bucket_sort")
               if L.get(k) != cfg.num_groups]
        if (not res["exact"] or bad or res["windows"] != unsharded
                or not np.array_equal(res["span_sums"], mine.cpu().numpy())):
            raise AssertionError(
                f"[sharded] xla rank {res['rank']}: exact={res['exact']}, "
                f"launch counts off {bad} ({L}), windows equal to the "
                f"unsharded twin's: {res['windows'] == unsharded}, span sums "
                f"bit-identical: "
                f"{np.array_equal(res['span_sums'], mine.cpu().numpy())}")
    print(f"[sharded] {CURVE.name} n=2^{logn} backend='xla' mesh x={world}, "
          f"{world} gloo {SHARED}: every rank EXACT, its {len(unsharded)} "
          f"window sums equal to the unsharded twin's (decoded), its span's "
          f"sums bit-identical to this process's; "
          + "; ".join(f"rank {r['rank']} window_sums {r['window_sums_ms']:.2f}"
                      f" ms (first call), launches={r['launches']}"
                      for r in ranks)
          + f"; {seconds:.1f} s from spawn to exit [{card}]", flush=True)
    return dict(seconds=seconds, ranks=[
        {k: v for k, v in r.items() if k not in ("windows", "span_sums")}
        for r in ranks])


def sharded_compares(run: dict) -> list:
    """Every `compare` result of the [sharded] phases."""
    return (list(run["window_shards"]["kernels"].values())
            + [r for span in run["rank_spans"].values()
               for r in span.values()]
            + [r for tree in run["reduce_tree"].values()
               for r in tree["levels"].values()])


def sharded_phase(card: str) -> dict:
    """The [sharded] phases, timed as a whole."""
    t0 = time.perf_counter()
    # one host: the ranks meet on the loopback interface
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    out = dict(label=SHARED, logn=SHARDED_LOGN,
               window_shards=window_shards(card),
               rank_spans=rank_spans(card),
               reduce_tree=reduce_tree_check(card),
               nccl=sharded_nccl(card), gloo=sharded_gloo(card),
               xla=sharded_xla(card))
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[sharded] every phase passed in {out['seconds']:.1f} s "
          f"[{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# [twin]: the XLA path (MSMConfig(backend="xla"), cuzk/pipeline.py
# _windows_device: bucket_sort, the row walk of smvp_rows, the stitch,
# bucket_reduce)
# ---------------------------------------------------------------------------

# (profile, log2 n, glv) of the twin's checked runs, at the default
# schedule; the first run's T (256) is the twin's smallest, where the
# stage-2 launch is also held against its plain version
TWIN_RUNS = ((BN254_S12, 16, False), (BN254_S12, 16, True),
             (BLS12_377_S12, 14, False), (BN254_S12, 20, False))
# the kernels the twin launches, glv_apply in encode_rows' place under
# GLV; the others must stay idle
TWIN_KERNELS = ("encode_rows", "decompose_digits", "bucket_sort",
                "smvp_rows", "smvp_stitch", "padd_batch", "pbpr_stage1",
                "pdbl_batch")
# (Wg, n, columns) of the [edge] smvp_stitch shapes: C = min(columns, n)
# odd and above 2 (n below the columns, one row), 2 and 1
STITCH_EDGES = ((3, 1001, 2048), (2, 64, 2), (4, 96, 1))
TWIN_TIMED_RUNS = 3


def twin_config(curve, logn: int, glv: bool) -> MSMConfig:
    return dataclasses.replace(default_config(1 << logn, curve), glv=glv,
                               backend="xla")


def twin_kernels(glv: bool) -> tuple:
    return tuple("glv_apply" if glv and k == "encode_rows" else k
                 for k in TWIN_KERNELS)


def twin_label(curve, logn: int, glv: bool) -> str:
    return f"{curve.name} 2^{logn}{' glv' if glv else ''}"


def twin_user_call(curve, logn: int, glv: bool, card: str,
                   capture: bool) -> dict:
    """The twin's user call, `tpu_variable_base_msm` under backend="xla",
    EXACT against the oracle, every launch count set to 0 just before it
    and read just after: one `smvp_stitch` a window group, and
    `padd_batch` only for the reduction's tree and last add (log2 T + 1).
    With `capture`, every call of the eight kernels' wrappers (once per
    shape, and how often) and of `bucket_reduce`, whose output is the
    window sums."""
    cfg = twin_config(curve, logn, glv)
    n = 1 << logn
    _, _, hw, base, want = inputs(curve, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    kset = twin_kernels(glv)
    targets = ([(kernels, WRAPPER.get(k, k)) for k in kset]
               + [(pbpr, "bucket_reduce")])
    seen, counts = {}, {}
    kernels.reset_launches()
    with spy(seen, targets if capture else [], counts):
        t0 = time.perf_counter()
        got = tpu_variable_base_msm(points, scalars, config=cfg,
                                    device=DEVICE)
        t_user = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    label = twin_label(curve, logn, glv)
    if not ref.jac_eq(curve, got, want):
        raise AssertionError(f"[twin] {label}: MSM result differs from the "
                             "oracle")
    idle = [k for k in kset if launches[k] == 0]
    stray = [k for k in KERNELS if k not in kset and launches[k]]
    if idle or stray:
        raise AssertionError(f"[twin] {label}: kernels not launched {idle}, "
                             f"launched off the path {stray}")
    if (launches["smvp_stitch"] != cfg.num_groups
            or launches["padd_batch"] != cfg.pbpr_threads.bit_length()):
        raise AssertionError(f"[twin] {label}: {launches['smvp_stitch']} "
                             f"smvp_stitch launches for {cfg.num_groups} "
                             f"window groups, {launches['padd_batch']} "
                             "padd_batch for the reduction's "
                             f"{cfg.pbpr_threads.bit_length()}")
    used = {k: v for k, v in launches.items() if v}
    print(f"[twin] {label} s={cfg.window_size} W={cfg.num_windows} "
          f"C={cfg.columns} T={cfg.pbpr_threads} Wg={cfg.subtask_group} "
          f"groups={cfg.num_groups} tpu_variable_base_msm(backend='xla') "
          f"EXACT in {t_user:.2f} s (host pack included) launches={used} "
          f"[{card}]", flush=True)
    return dict(cfg=cfg, launches=launches, seen=seen, counts=counts,
                user_s=t_user)


def reduce_stage2_chain(curve, m1: torch.Tensor):
    """Stage 2 of `bucket_reduce` as it ran before its one `pbpr_stage1`
    launch: for k = T-1 .. 1, macc += m_k and msum += macc, from
    infinity, 2 (T-1) dependent `padd_batch` launches on Wp lanes; m1 is
    m_1 .. m_{T-1}, (3, L, Wp, T-1). Returns (macc, msum)."""
    macc = msum = kernels.inf_stacked(curve, (m1.shape[2],), m1.device)
    for k in range(m1.shape[-1] - 1, -1, -1):
        macc = kernels.padd_batch(macc, m1[..., k].contiguous(), curve)
        msum = kernels.padd_batch(msum, macc, curve)
    return macc, msum


def reduce_stage2_check(curve, key: str, args, tag: str, card: str,
                 with_plain: bool) -> dict:
    """The stage-2 launch of `bucket_reduce` (`pbpr_stage1` with threads =
    1 on m_1 .. m_{T-1}) against the 2 (T-1) `padd_batch` launches it
    replaced (`reduce_stage2_chain`, each launch a kernel held against
    its plain version elsewhere), bit for bit, both timed back to back;
    with `with_plain`, first against its own plain version (`compare`)."""
    m1 = args[0]
    if with_plain:
        r = compare(curve, key, "pbpr_stage1", args, {}, tag, card, 3)
    else:
        got = kernels.pbpr_stage1(*args)
        t = cuda_ms(lambda: kernels.pbpr_stage1(*args), 3)
        b_ms, b_by = bound_ms(*work(curve, "pbpr_stage1", args, got))
        r = dict(name="pbpr_stage1", ms=t, ms_cuda=t, plain_ms=None,
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=0,
                 launched=dict(kernels.LAUNCHED["pbpr_stage1"]))
    macc, msum = kernels.pbpr_stage1(*args)
    want = reduce_stage2_chain(curve, m1)
    torch.cuda.synchronize()
    if not (torch.equal(macc[..., 0], want[0])
            and torch.equal(msum[..., 0], want[1])):
        raise AssertionError(f"{key} at {tag}: the stage-2 launch differs "
                             f"from the {2 * m1.shape[-1]} padd_batch "
                             "launches it replaced")
    chain_ms = cuda_ms(lambda: reduce_stage2_chain(curve, m1), 3)
    r.update(chain_ms=chain_ms, chain_launches=2 * m1.shape[-1])
    print(f"[stage2] {curve.name} {tag} {key}: one pbpr_stage1 launch on "
          f"{m1.shape[2]} lanes of {m1.shape[-1]} steps {r['ms']:.4f} ms, "
          f"bit-identical to the {2 * m1.shape[-1]} padd_batch launches it "
          f"replaced, {chain_ms:.4f} ms back to back"
          + (f"; and to its plain version ({r['plain_ms']:.1f} ms)"
             if with_plain else "") + f" [{card}]", flush=True)
    return r


def stitch_levels_ran() -> tuple:
    """The scan levels that the last smvp_stitch launch ran, from the
    mask its kernel wrote (kernels.LAUNCHED; reading it waits for the
    card)."""
    launched = kernels.LAUNCHED["smvp_stitch"]
    mask = int(launched["ran_mask"].item())
    return tuple(lv for lv in range(launched["levels"]) if mask >> lv & 1)


def stitch_barriers(levels_run) -> int:
    """Grid barriers of one smvp_stitch launch that runs `levels_run`:
    one after the pass that finds them; where there are any, one after
    the copy of the trailing sums into the scan and one after each."""
    return 1 + (1 + len(levels_run) if levels_run else 0)


def stitch_levels(skeys: torch.Tensor, C: int, label: str) -> tuple:
    """The scan levels that the last smvp_stitch launch ran (on `skeys`),
    as its kernel reports them, held against the levels with an add by
    the closed form (kernels.stitch_levels_that_add) and by the flags
    carried level by level (`stitch_adds`); returns (those levels, the
    propagation's (adds, injects, chain))."""
    ran = stitch_levels_ran()
    closed = kernels.stitch_levels_that_add(skeys, C)
    adds, injects, chain, carried = stitch_adds(skeys, C)
    if not ran == closed == carried:
        raise AssertionError(f"smvp_stitch {label}: ran levels {ran}, the "
                             f"closed form {closed}, the carried flags "
                             f"{carried}")
    return ran, (adds, injects, chain)


def stitch_line(label: str, cfg: MSMConfig, run: dict, r: dict, args,
                lat: dict | None, card: str) -> dict:
    """The [stitch] line of one twin run: smvp_stitch's launches in the
    user call, its time a group (the first group's call, compared, on
    `args`), its scan levels, the levels it ran (`stitch_levels`) and
    its grid barriers, the adds and the chain of dependent adds its keys
    need and, with `lat`, its depth floor (that chain, each add a
    [latency] level); returns the levels run, the barriers and the
    floor."""
    C = cfg.columns
    levels = len(kernels.smvp_stitch_levels(C))
    pairs = cfg.subtask_group * sum(map(len, kernels.smvp_stitch_levels(C)))
    ran, (adds, injects, chain) = stitch_levels(args[2], C, label)
    barriers = stitch_barriers(ran)
    floor = chain * lat["stitch_level_ms"] if lat else None
    print(f"[stitch] {label}: {run['launches']['smvp_stitch']} smvp_stitch "
          f"launches, one a window group ({cfg.num_groups} groups of "
          f"{cfg.subtask_group} windows, C = {C}); {r['ms']:.4f} ms a group "
          f"({r['ms_cuda']:.4f} back to back); of {levels} scan levels it "
          f"ran {len(ran)} {list(ran)} (the kernel's report, equal to the "
          f"closed form's and the carried flags' levels with an add), "
          f"{barriers} grid barriers, and the inject; the first group's "
          f"keys need {adds} scan adds of its {pairs} pairs and {injects} "
          f"injects, a chain of {chain} dependent adds"
          + (f", depth floor {floor:.4f} ms ({r['ms'] / floor:.2f}x)"
             if floor else "")
          + f"; padd_batch {run['launches']['padd_batch']} launches (the "
          f"reduction's tree and last add) [{card}]", flush=True)
    return dict(levels_ran=list(ran), barriers=barriers, floor_ms=floor)


def rows_line(label: str, run: dict, r: dict, args, lat: dict | None,
              card: str) -> dict:
    """The [rows] line of one twin run: smvp_rows's launches in the user
    call and its time a group (the first group's call, compared, on
    `args`), its launch; the longest run inside one column of the group's
    keys and, with `lat`, the depth floor of the work: that run less one,
    each a row of the lane, beside the floor of R scan steps (a lane's
    walk of its whole column, the floor before the keys were counted).
    Returns the floors and the longest run."""
    pay, skeys, C = args[1], args[2], args[4]
    Wg, n = pay.shape
    R = n // C
    launched = r["launched"]
    G = kernels.SMVP_THREADS_PER_LANE
    longest = longest_run(skeys, C)
    floor = (longest - 1) * lat["rows_step_ms"] if lat else None
    floor_R = R * lat["scan_step_ms"][G] if lat else None
    print(f"[rows] {label}: {run['launches']['smvp_rows']} smvp_rows "
          f"launches, one a window group (Wg = {Wg}, C = {C}, R = {R}); "
          f"{r['ms']:.4f} ms a group; launched {launched['blocks']} blocks "
          f"of {launched['lanes_per_block']} lanes of {G} threads, a lane a "
          f"column; the longest run inside one column {longest} rows"
          + (f", depth floor {floor:.4f} ms ({longest - 1} rows of "
             f"{lat['rows_step_ms']:.5f}; {r['ms'] / floor:.2f}x); the "
             f"floor of R = {R} scan steps {floor_R:.4f} ms "
             f"({r['ms'] / floor_R:.2f}x)" if lat and floor else "")
          + f" [{card}]", flush=True)
    return dict(floor_ms=floor, floor_R_ms=floor_R, longest_run=longest)


# Run lengths of the [edge] row-walk keys, in turn: runs of one row,
# runs over several columns, a column's last run going on into the next.
ROW_RUNS = (1, 13, 2, 1, 9, 1, 1, 21, 3, 5, 1, 17, 4, 1, 1, 7, 40, 2, 150)
# The [edge] row walk runs at the STITCH_EDGES shapes of at most
# ROW_EDGE_MAX_R rows a column (the plain version takes a step a row).
ROW_EDGE_MAX_R = 32


def rows_against_plain(label: str, args) -> None:
    """`smvp_rows` bit for bit against its plain version."""
    want = kernels.smvp_rows_plain(*args)
    got = kernels.smvp_rows(*args)
    torch.cuda.synchronize()
    if not all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want, strict=True)):
        raise AssertionError(f"{label}: kernel differs from its plain "
                             "version")


def stitch_edges(card: str) -> None:
    """`smvp_rows` and `smvp_stitch` against their plain versions at
    STITCH_EDGES on BN254_S12, their inputs made as `bucket_accumulate`
    makes them on the card (`bucket_sort`, `smvp_rows`) from the first
    points of the 2^16 inputs: random digits with runs across columns,
    every key equal, every column its own run, every digit 0, runs of
    ROW_RUNS rows; the row walk also with keys -1 and B + 1, which it
    writes nowhere."""
    curve = CURVE
    xs, ys, _, _, _ = inputs(curve, 16)
    B = 4096
    rng = np.random.default_rng(19)
    done, ran, rows_done = [], {}, set()
    for Wg, n, columns in STITCH_EDGES:
        C, R = min(columns, n), n // min(columns, n)
        xm, ym = (kernels.encode_mont(torch.from_numpy(a[:, :n].astype(
            np.int32)).to(DEVICE), curve) for a in (xs, ys))
        pts_rows = torch.cat([xm, ym]).to(torch.int16).T.contiguous()
        d = rng.integers(-B, B + 1, (Wg, n))
        d[:, n // 5:n // 5 + n // 2] = 7
        keys = np.repeat(np.arange(1, C + 1), R)
        own = np.stack([rng.permutation(keys) for _ in range(Wg)])
        runs = np.repeat(np.arange(1, len(ROW_RUNS) + 1), ROW_RUNS)
        runs = np.resize(runs, (Wg, n)) * rng.choice([-1, 1], (Wg, n))
        kinds = {"random with runs": d, "every key equal": np.full(
            (Wg, n), -9), "every column its own run": own,
            "every digit 0": np.zeros((Wg, n)),
            "runs over columns": runs,
            "keys -1 and B + 1": d}
        for kind, digits in kinds.items():
            dg = torch.from_numpy(digits.astype(np.int32)).to(DEVICE)
            pay, _ = kernels.bucket_sort(dg.to(torch.int16), B)
            skeys = torch.gather(dg.abs(), 1, (pay >> 1).long())
            tag = f"(Wg, n, C) = ({Wg}, {n}, {C}) {kind}"
            if kind == "keys -1 and B + 1":
                # keys the row walk writes nowhere (the plain version
                # writes them into the spare slot, then resets it)
                skeys[:, :3] = -1
                skeys[:, -3:] = B + 1
            if R <= ROW_EDGE_MAX_R:
                rows_against_plain(f"[edge] smvp_rows {tag}",
                                   (pts_rows, pay, skeys, curve, C, B))
                rows_done.add(kind)
            if kind == "keys -1 and B + 1":
                continue
            bucket, trailing = kernels.smvp_rows(pts_rows, pay, skeys, curve,
                                                 C, B)
            same_as_plain(f"smvp_stitch {tag}", "smvp_stitch",
                          (bucket, trailing, skeys, curve, C))
            ran[f"({Wg}, {n}, {C}) {kind}"] = len(stitch_levels(
                skeys, C, tag)[0])
        done.append(f"({Wg}, {n}, {C})")
    print(f"[edge] smvp_stitch bit-identical to its plain version, the "
          f"whole (3, L, Wg, B + 2) bucket tensor, at (Wg, n, C) = "
          f"{', '.join(done)} (C = min(columns, n); B = {B}), each with "
          f"random digits with runs, every key equal, every column its own "
          f"run and every digit 0; scan levels run (the kernel's report, "
          f"equal to the closed form's and the carried flags'): {ran} "
          f"[{card}]", flush=True)
    print(f"[edge] smvp_rows bit-identical to its plain version, the "
          f"buckets and the trailing sums, at those (Wg, n, C) of at most "
          f"{ROW_EDGE_MAX_R} rows a column, each with "
          f"{', '.join(sorted(rows_done))} (runs of {ROW_RUNS} rows in "
          f"turn) [{card}]", flush=True)


def twin_check(curve, logn: int, glv: bool, card: str,
               plain_stage2: bool, lat: dict | None = None) -> dict:
    """One checked run of the twin: the user call; its window sums
    against the CUDA path's on the same inputs, window by window after
    decoding; each captured kernel call against its plain version, timed
    (3 reps; `smvp_rows` on the first group), the stage-2 launch against
    the chain it replaced (and, with `plain_stage2`, its plain version);
    TWIN_TIMED_RUNS timed runs; the kernels' time (each shape's time by
    its calls) and the rest; the [stitch] line."""
    label = twin_label(curve, logn, glv)
    run = twin_user_call(curve, logn, glv, card, capture=True)
    cfg, seen, counts = run["cfg"], run.pop("seen"), run["counts"]
    n = 1 << logn
    xs, ys, hw, _, _ = inputs(curve, logn)
    hw = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    pipe = get_pipeline(cfg, DEVICE)
    g = next(v[3][0] for k, v in seen.items() if k.startswith(
        "bucket_reduce"))
    twin_w = pipe._decode_windows(g)
    cuda_w = pipe._decode_windows(pipeline_cuda.windows_device(
        *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
          for a in (xs, ys, hw)), dataclasses.replace(cfg, backend="auto")))
    for w, (a, b) in enumerate(zip(twin_w, cuda_w, strict=True)):
        if not ref.jac_eq(curve, a, b):
            raise AssertionError(f"[twin] {label}: window {w} differs from "
                                 "the CUDA path's")
    print(f"[twin] {label}: window sums equal to the CUDA path's in all "
          f"{len(twin_w)} windows [{card}]", flush=True)

    tag = f"n=2^{logn}{' glv' if glv else ''} twin"
    kset = twin_kernels(glv)
    results = {}
    for key, (name, args, kw, _) in seen.items():
        if KERNEL_OF.get(name, name) not in kset:
            continue
        if name == "pbpr_stage1" and args[2] == 1:
            results[key] = reduce_stage2_check(curve, key, args, tag, card,
                                               plain_stage2)
        else:
            results[key] = compare(curve, key, name, args, kw, tag, card, 3)
    kern_ms = dict.fromkeys(kset, 0.0)
    for key, r in results.items():
        kern_ms[r["name"]] += counts[key] * r["ms"]
    key = next(k for k, r in results.items() if r["name"] == "smvp_stitch")
    stitch = stitch_line(label, cfg, run, results[key], seen[key][1], lat,
                         card)
    key = next(k for k, r in results.items() if r["name"] == "smvp_rows")
    walk = rows_line(label, run, results[key], seen[key][1], lat, card)
    del seen
    ms, h2d = timed_runs(cfg, logn, "twin", card, runs=TWIN_TIMED_RUNS)
    total = sum(kern_ms.values())
    print(f"[twin-where] {label}: median {ms:.2f} ms end to end; kernels "
          f"{total:.2f} ms (" + ", ".join(f"{k} {v:.2f}" for k, v in
                                         kern_ms.items())
          + f"; each shape's time by its calls), outside the kernels "
          f"{ms - total:.2f} ms (the keys' gather, the reduction's torch "
          f"ops, launches, decode, Horner); launches "
          f"{ {k: run['launches'][k] for k in kset} } [{card}]",
          flush=True)
    return dict(label=label, logn=logn, msm_ms=ms, h2d_ms=h2d,
                user_s=run["user_s"], kernels_ms=total, kernel_ms=kern_ms,
                outside_ms=ms - total,
                launches={k: run["launches"][k] for k in kset},
                stitch_floor_ms=stitch["floor_ms"], stitch=stitch,
                rows=walk, results=results, calls=counts)


def twin_phase(card: str, lat: dict | None = None) -> dict:
    """The [twin] runs of TWIN_RUNS, each checked, then the [edge]
    smvp_stitch and smvp_rows shapes; with `lat` ([latency]'s), the
    stitch's and the row walk's depth floors."""
    t0 = time.perf_counter()
    runs = {}
    for i, (curve, logn, glv) in enumerate(TWIN_RUNS):
        warm_plain(curve)
        r = twin_check(curve, logn, glv, card, plain_stage2=i == 0,
                       lat=lat)
        runs[r["label"]] = r
        torch.cuda.empty_cache()
    stitch_edges(card)
    seconds = time.perf_counter() - t0
    print(f"[twin] every phase passed in {seconds:.1f} s [{card}]",
          flush=True)
    return dict(runs=runs, seconds=seconds)


# The limb counts whose kernels the [ptxas] and [sass] lines report:
# BN254_S12's and those of PROFILES (TINY62's L = 6 is left out).
PTXAS_LIMBS = (CURVE.num_limbs,) + tuple(c.num_limbs for c, _ in PROFILES)


# Element types as the mangled template arguments name them.
MANGLED_TYPES = {"s": "int16", "i": "int32", "t": "uint16"}


def template_args(fn: str, name: str) -> list:
    """The template arguments of the mangled `<name><...>` in `fn`: each
    int (Li<n>E) as a string, each element type by name."""
    out = []
    for m in re.finditer(r"Li(\d+)E|Lb([01])E|([a-z])|(E)",
                         fn.split(name + "I", 1)[1]):
        if m[4]:
            break
        out.append(m[1] or (m[2] and ("false", "true")[int(m[2])])
                   or MANGLED_TYPES.get(m[3], m[3]))
    return out


# What the [sass] lines count, by opcode (IMAD.WIDE, IMAD.HI, IMAD.X
# and IMAD.MOV apart from the other IMAD forms): the multiply-adds, the
# moves, the loads and stores by state space (LD and ST without a suffix
# are generic), calls.
SASS_KINDS = ("IMAD.WIDE", "IMAD.HI", "IMAD.X", "IMAD.MOV", "IMAD", "MOV",
              "IADD3", "LD", "LDS", "LDG", "LDL", "LDC", "ST", "STS", "STG",
              "STL", "CALL")


def sass_kinds(ops) -> dict:
    out = dict.fromkeys(("total",) + SASS_KINDS, 0)
    for op in ops:
        kind = next((k for k in SASS_KINDS[:4] if op.startswith(k)),
                    op.split(".")[0])
        out["total"] += 1
        if kind in out:
            out[kind] += 1
    return out


# Sources whose kernels are templated on no profile: [ptxas] and [sass]
# report every form of theirs.
NO_PROFILE_STEMS = ("bucket_sort", "decompose_digits")


def sass_listings(obj) -> dict:
    """(address, opcode, call target or None) of every instruction of each
    kernel in the object file at the limb counts PTXAS_LIMBS (every kernel
    of NO_PROFILE_STEMS), read with cuobjdump -sass. A kernel's listing
    holds the out-of-line functions it calls."""
    stem = os.path.splitext(os.path.basename(str(obj)))[0]
    every = stem in NO_PROFILE_STEMS
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            targs = (template_args(m[1], "_kernel") if "_kernelI" in m[1]
                     else [None])
            cur = None
            if every or targs[0] in map(str, PTXAS_LIMBS):
                cur = out[f"{kernel_name(m[1])}<{', '.join(targs)}>"] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)\s*(0x[0-9a-f]+)?", line)
        if cur is not None and m:
            call = int(m[4], 16) if m[3].startswith("CALL") and m[4] else None
            cur.append((int(m[1], 16), m[3], call))
    return out


def sass_counts(stem: str, build=None) -> dict:
    """Instruction counts of every kernel of csrc/<stem>.cu at the limb
    counts PTXAS_LIMBS, its out-of-line functions included, from the
    object file in `build` (by default this build's)."""
    obj = (build or _build.build_dir()) / f"{stem}.o"
    return {k: sass_kinds(op for _, op, _ in ins)
            for k, ins in sass_listings(obj).items()}


# The multiply's instructions before its rows were carry chains (64-bit
# multiply-adds in C++ on one accumulator): msm::mul_wide in prefix_scan's
# object of the parent commit's build at L = 22, counted by callee_counts
# in a scripts/torch_ab.py run (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
MUL_WIDE_SASS_BEFORE = {
    "scan<22, 12, 6>": {"total": 736, "IMAD.WIDE": 144, "IMAD.HI": 8,
                        "IMAD.X": 98, "IMAD.MOV": 30, "IMAD": 40, "MOV": 11,
                        "IADD3": 173, "LDS": 53, "STS": 22},
    "scan<22, 12, 2>": {"total": 733, "IMAD.WIDE": 144, "IMAD.HI": 8,
                        "IMAD.X": 110, "IMAD.MOV": 31, "IMAD": 40, "MOV": 9,
                        "IADD3": 162, "LDS": 53, "STS": 22},
}


def callee_counts(stem: str, build=None) -> dict:
    """Instruction counts of the out-of-line function that each kernel of
    csrc/<stem>.cu calls from the most sites (msm::mul_wide in
    prefix_scan's and the shared add's kernels): from its address to its
    first RET."""
    obj = (build or _build.build_dir()) / f"{stem}.o"
    out = {}
    for k, ins in sass_listings(obj).items():
        sites = [c for _, _, c in ins if c is not None]
        if not sites:
            continue
        start = max(set(sites), key=sites.count)
        body = []
        for addr, op, _ in ins:
            if addr >= start:
                body.append(op)
                if op.startswith("RET"):
                    break
        out[k] = sass_kinds(body)
    return out


def kernel_label(fn: str) -> str:
    """`name<template arguments>` of a mangled kernel symbol (`name` alone
    where the kernel is no template)."""
    targs = template_args(fn, "_kernel") if "_kernelI" in fn else []
    return kernel_name(fn) + (f"<{', '.join(targs)}>" if targs else "")


def ptxas_table(stem: str) -> dict:
    """{kernel label: (registers, static shared bytes)} of every kernel of
    csrc/<stem>.cu, from what ptxas printed when the library was built."""
    text = (_build.build().parent / f"{stem}.ptxas.txt").read_text()
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[kernel_label(chunk.split("'", 1)[0])] = (
            int(regs[1]), int(smem[1]) if smem else 0)
    return out


def resident_blocks(threads: int, regs: int, shared: int) -> int:
    """Blocks of a kernel that an H100 SM holds at once: by its block
    slots, its warps, its registers (allocated 256 a warp) and its shared
    memory (with the 1 KB reserved a block)."""
    warps = -(-threads // 32)
    warp_regs = -(-regs * 32 // 256) * 256
    return min(kernels.SM_BLOCKS, kernels.SM_WARPS // warps,
               kernels.SM_REGISTERS // (warp_regs * warps),
               kernels.SM_SHARED_BYTES
               // (shared + kernels.BLOCK_RESERVED_SHARED))


def occupancy(curve, name: str, launched: dict, tag: str, card: str) -> dict:
    """`[occupancy]`: for `bucket_sort` each of its kernels' blocks, the
    blocks an SM holds (from [ptxas] and the launch geometry) and its
    waves, and its launches a call; for `extract_buckets` its persistent
    blocks, the blocks an SM holds by the occupancy query and by [ptxas],
    its waves and its runs. Estimates without ncu: no achieved
    occupancy."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    table = ptxas_table(name)
    out = {}
    if name == "bucket_sort":
        Wp = launched["upsweep_blocks"] // launched["chunks"]
        forms = ([("true", "true")] if launched["passes"] == 1
                 else [("true", "false"), ("false", "true")])
        parts = [("radix_upsweep", kernels.SORT_UPSWEEP_THREADS,
                  launched["upsweep_shared_bytes"], launched["upsweep_blocks"]),
                 ("radix_counts", 256, 0, launched["count_blocks"])]
        parts += [(f"radix_pass<{a}, {b}>", 256, 0, Wp * launched["tiles"])
                  for a, b in forms]
        for label, threads, dyn, blocks in parts:
            regs, smem = table[label]
            per_sm = resident_blocks(threads, regs, smem + dyn)
            out[label] = dict(blocks=blocks, threads=threads, registers=regs,
                              shared_bytes=smem + dyn, blocks_per_sm=per_sm,
                              waves=-(-blocks // (sms * per_sm)))
        out["launches"] = launched["launches"]
        text = (f"{launched['launches']} launches a call; " + "; ".join(
            f"{k} {v['blocks']} blocks of {v['threads']} threads, "
            f"{v['blocks_per_sm']} an SM ({v['registers']} registers, "
            f"{v['shared_bytes']} B shared), waves {v['waves']}"
            for k, v in out.items() if isinstance(v, dict)))
    else:
        L = curve.num_limbs
        label = f"extract<{L}, {curve.log_limb_size}>"
        regs, smem = table[label]
        dyn = 4 * kernels.EXTRACT_LANES * (15 * L | 1)
        out = dict(blocks=launched["blocks"], threads=launched["threads"],
                   registers=regs, shared_bytes=smem + dyn,
                   blocks_per_sm=launched["blocks_per_sm"],
                   blocks_per_sm_ptxas=resident_blocks(
                       launched["threads"], regs, smem + dyn),
                   waves=launched["waves"], runs=launched["runs"],
                   runs_per_block=launched["runs_per_block"])
        text = (f"{out['blocks']} persistent blocks of {out['threads']} "
                f"threads, {out['blocks_per_sm']} an SM by the occupancy "
                f"query ({out['blocks_per_sm_ptxas']} by [ptxas]: "
                f"{regs} registers, {smem + dyn} B shared), "
                f"waves {out['waves']}, {out['runs']} runs of "
                f"{kernels.EXTRACT_LANES - 1} buckets, at most "
                f"{out['runs_per_block']} a block")
    print(f"[occupancy] {curve.name} {tag} {name}: {text} [{card}]",
          flush=True)
    return out


def kernel_name(fn: str) -> str:
    """`name` of a mangled `<name>_kernel<...>` or `<name>_kernel` symbol:
    the identifier that its length, in decimal, precedes."""
    head = re.split(r"_kernel(?=[IE])", fn, maxsplit=1)[0]
    for i in range(len(head) - 1, 0, -1):
        if (head[i].isalpha() and head[i - 1].isdigit()
                and head[:i].endswith(str(len(head) - i + 7))):
            return head[i:]
    raise ValueError(f"no kernel name in {fn}")


# ---------------------------------------------------------------------------
# phases 13 to 17: the host utilities and the service
# ---------------------------------------------------------------------------

# (log2 n, extra configs beside the model's candidates): the static
# default at both sizes, SCHEDULE at the larger.
AUTOTUNE_LOGN = (16, 20)
AUTOTUNE_RUNS = 2
PROFILE_LOGN = 16
# Device kernels of the main path in a torch.profiler trace, by the name
# each CUDA kernel has there (prefix_scan's scan has three template
# arguments, pbpr_full's two).
TRACE_NAMES = {
    "encode_rows": (r"::encode_rows_kernel\b",),
    "decompose_digits": (r"::digits_kernel\b",),
    "prefix_scan": (r"::scan_kernel<\d+, \d+, \d+>",),
    "col_prefix": (r"::colprefix_kernel\b",),
    "bucket_sort": (r"::radix_upsweep_kernel\b", r"::radix_counts_kernel\b",
                    r"::radix_pass_kernel<"),
    "extract_buckets": (r"::extract_kernel<",),
    "pbpr_full": (r"::stage1_kernel<\d+, \d+>(\(|$)",
                  r"::scan_kernel<\d+, \d+>(\(|$)"),
}
CPU_MSM_N = 4096
# The run's temporary directory (main() makes it): the autotune cache, so
# that no phase reads a schedule tuned before this run, and the traces.
RUN_TMP = None
CPU_MSM_CURVES = (BN254_S12, BLS12_377_S12)
MULTIPASS_LOGN = 21
MULTIPASS_PASS = 1 << 20
SERVICE_LOGN = 16


def main_launches(label: str, glv: bool = False) -> dict:
    """The launch counts since the last reset; fails if a kernel of the
    main path did not launch."""
    launches = dict(kernels.LAUNCHES)
    idle = [k for k in path_kernels(glv) if launches[k] == 0]
    if idle:
        raise AssertionError(f"{label}: kernels not launched: {idle}")
    return {k: v for k, v in launches.items() if v}


def planar_to_words(planar: np.ndarray, w: int, words: int) -> np.ndarray:
    """(K, n) nonnegative w-bit limbs -> (n, words) little-endian u64
    words of the same integers (the wire and native layout)."""
    out = np.zeros((planar.shape[1], words), np.uint64)
    a = planar.astype(np.uint64)
    for k in range(planar.shape[0]):
        j, off = divmod(w * k, 64)
        if j < words:
            out[:, j] |= a[k] << np.uint64(off)
        if off + w > 64 and j + 1 < words:
            out[:, j + 1] |= a[k] >> np.uint64(64 - off)
    return out


def wire_words(curve, xs, ys, hw):
    """Planar inputs -> (x, y, scalar) u64 word arrays."""
    nw, sw = app_protocol.curve_words(curve)
    w = curve.log_limb_size
    return (planar_to_words(xs, w, nw), planar_to_words(ys, w, nw),
            planar_to_words(hw, 16, sw))


def autotune_phase(card: str) -> dict:
    """`window.autotune` on BN254_S12 at each size of AUTOTUNE_LOGN, into
    the run's own cache file: the model's candidates, the static default
    and, at the largest size, SCHEDULE. Each sweep counted; then
    `default_config` gives the winner while the cache is set and the
    static schedule once it is not, and each winner is EXACT through
    `tpu_variable_base_msm`."""
    t0 = time.perf_counter()
    out = {}
    for logn in AUTOTUNE_LOGN:
        n = 1 << logn
        static = static_config(n, CURVE)
        configs = window.candidate_configs(n, CURVE) + [static]
        if logn == max(AUTOTUNE_LOGN):
            configs.append(MSMConfig(curve=CURVE, **SCHEDULE))
        kernels.reset_launches()
        ts = time.perf_counter()
        best, results = window.autotune(n, CURVE, runs=AUTOTUNE_RUNS,
                                        configs=configs, device=DEVICE)
        sweep_s = time.perf_counter() - ts
        launches = main_launches(f"autotune 2^{logn}")
        by_cfg = {c: ms for c, ms in results}
        best_ms, static_ms = by_cfg[best], by_cfg.get(static)
        if default_config(n, CURVE) != best:
            raise AssertionError(f"autotune 2^{logn}: default_config does "
                                 "not read the recorded winner")
        xs, ys, hw, base, want = inputs(CURVE, logn)
        points = [base[i % len(base)] for i in range(n)]
        got = tpu_variable_base_msm(points, preprocess.halfwords_to_ints(hw),
                                    curve=CURVE, device=DEVICE)
        if not ref.jac_eq(CURVE, got, want):
            raise AssertionError(f"autotune 2^{logn}: the winner's MSM "
                                 "differs from the oracle")
        name = lambda c: (f"s={c.window_size} C={c.columns} "
                          f"T={c.pbpr_threads} Wg={c.subtask_group}")
        print(f"[autotune] {CURVE.name} n=2^{logn}: {len(results)} of "
              f"{len(configs)} configs timed (runs={AUTOTUNE_RUNS}, median, "
              f"window_sums on inputs on the card) in {sweep_s:.1f} s; "
              f"winner {name(best)} {best_ms:.2f} ms, the static default "
              f"{name(static)} {static_ms:.2f} ms; the winner EXACT through "
              f"default_config; launches of the sweep={launches} [{card}]",
              flush=True)
        out[f"2^{logn}"] = dict(
            winner={k: getattr(best, k) for k in window._TUNED_FIELDS},
            winner_ms=best_ms, static_ms=static_ms, sweep_s=sweep_s,
            launches=launches,
            results=[dict({k: getattr(c, k) for k in window._TUNED_FIELDS},
                          ms=ms) for c, ms in results])
    os.environ[window.CACHE_ENV] = os.path.join(RUN_TMP, "no_cache.json")
    for logn in AUTOTUNE_LOGN:
        if default_config(1 << logn, CURVE) != static_config(1 << logn, CURVE):
            raise AssertionError("autotune: default_config is not the "
                                 "static schedule without the cache")
    out["seconds"] = time.perf_counter() - t0
    print(f"[autotune] default_config back on the static schedule without "
          f"the cache; every phase passed in {out['seconds']:.1f} s [{card}]",
          flush=True)
    return out


def trace_device_ms(path: str) -> tuple:
    """(kernel ms, kernel names, launches without a kernel record) of a
    Chrome trace written by `profiling.trace`: the device time of every
    kernel in it, and how many kernel launches of the host side have no
    record of their kernel."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ks = [e for e in events if e.get("cat") == "kernel"]
    have = {e.get("args", {}).get("correlation") for e in ks}
    launches = [e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "")]
    lost = sum(e.get("args", {}).get("correlation") not in have
               for e in launches)
    return (sum(e.get("dur", 0) for e in ks) / 1e3,
            {e["name"] for e in ks}, lost)


def in_fresh_process(fn, *args):
    """fn(*args) in a spawned process of its own. torch.profiler loses
    the first kernel records of every session after a process's first
    (one more each session: measured on the H100 in PR 11), so each
    traced measurement runs as the first sessions of a new process."""
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=1,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(fn, *args).result()


def profile_traces(device: str, logdir: str, logn: int) -> dict:
    """The traced part of [profile], in a fresh process: one
    tpu_variable_base_msm call (after one untraced call) under
    `profiling.trace`, counted, EXACT, whose trace must name the six
    kernels of the main path; then `device_ms` of `apply_glv` and of
    `to_affine` alone, each with the device time of its kernels from its
    own trace."""
    global DEVICE
    DEVICE = device
    if device == "cuda":
        _build.library()
    n = 1 << logn
    xs, ys, hw, base, want = inputs(CURVE, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    tpu_variable_base_msm(points, scalars, curve=CURVE, device=DEVICE)
    kernels.reset_launches()
    with profiling.trace(logdir) as path:
        got = tpu_variable_base_msm(points, scalars, curve=CURVE,
                                    device=DEVICE)
    launches = main_launches("profile")
    if not ref.jac_eq(CURVE, got, want):
        raise AssertionError("profile: the traced MSM differs from the oracle")
    kern_ms, names, lost = trace_device_ms(path)
    missing = [k for k, pats in TRACE_NAMES.items()
               if not all(any(re.search(p, nm) for nm in names)
                          for p in pats)]
    if missing:
        raise AssertionError(f"profile: the trace names no kernel of "
                             f"{missing} ({lost} launches without a kernel "
                             f"record): {sorted(names)}")
    out = dict(launches=launches, trace_bytes=os.path.getsize(path),
               kernel_names=len(names), trace_kernel_ms=kern_ms,
               trace_lost=lost, alone={})

    seen = capture_inputs(CURVE, logn, True)
    _, gargs, _, _ = seen["glv_rows"]
    del seen
    gcfg = config(CURVE, logn, True)
    hw2 = np.concatenate([hw, np.zeros((2, n), np.uint32)])
    g = pipeline_cuda.windows_device(
        *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
          for a in (xs, ys, hw2)), config(CURVE, logn, False))
    for label, fn in (("apply_glv",
                       lambda: glv_dev.glv_rows(*gargs[:3], gcfg)),
                      ("to_affine", lambda: to_affine(g, CURVE))):
        wall = profiling.device_ms(fn, runs=3, warmup=1)
        with profiling.trace(logdir) as path:
            profiling.block(fn())
        dev_ms, _, lost = trace_device_ms(path)
        out["alone"][label] = dict(wall_ms=wall, device_ms=dev_ms,
                                   trace_lost=lost)
    return out


def profile_phase(card: str) -> dict:
    """[profile]: `profile_traces` in a fresh process, then a StageTimer
    of pack, window_sums and Horner here."""
    t0 = time.perf_counter()
    logn, n = PROFILE_LOGN, 1 << PROFILE_LOGN
    logdir = os.path.join(RUN_TMP, "traces")
    out = in_fresh_process(profile_traces, DEVICE, logdir, logn)
    shutil.rmtree(logdir)
    print(f"[profile] n=2^{logn} tpu_variable_base_msm under profiling.trace,"
          f" in a fresh process: EXACT, {out['trace_bytes']} B of Chrome "
          f"trace naming the seven kernels of the main path "
          f"({out['kernel_names']} kernel names; {out['trace_lost']} "
          f"launches without a kernel record), their device time "
          f"{out['trace_kernel_ms']:.2f} ms; launches={out['launches']} "
          f"[{card}]", flush=True)
    for label, a in out["alone"].items():
        print(f"[profile] {label} alone at n=2^{logn}: device_ms (median of "
              f"3, wall) {a['wall_ms']:.2f} ms; device time of its kernels "
              f"in its own trace {a['device_ms']:.3f} ms "
              f"({100 * a['device_ms'] / a['wall_ms']:.1f} % of the wall "
              f"time; {a['trace_lost']} launches without a kernel record) "
              f"[{card}]", flush=True)

    xs, ys, hw, base, want = inputs(CURVE, logn)
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    pipe = get_pipeline(config(CURVE, logn, False), DEVICE)
    timer = profiling.StageTimer()
    with timer.span("pack"):
        packed = pipe.pack(points, scalars)
    with timer.span("window_sums"):
        windows = pipe.window_sums(*packed)
    with timer.span("horner"):
        acc = pipe.horner(windows)
    if not ref.jac_eq(CURVE, acc, want):
        raise AssertionError("profile: the staged MSM differs from the oracle")
    print(f"[profile] n=2^{logn} StageTimer (host clock; window_sums "
          f"includes the h2d of the packed inputs) [{card}]:\n"
          + timer.table(), flush=True)
    out["stages"] = json.loads(timer.json())
    out["seconds"] = time.perf_counter() - t0
    print(f"[profile] every phase passed in {out['seconds']:.1f} s [{card}]",
          flush=True)
    return out


def cpu_msm_phase(card: str) -> dict:
    """The native CPU MSM built from native/cpumsm.cpp into the build
    directory, EXACT against the oracle on each of CPU_MSM_CURVES."""
    t0 = time.perf_counter()
    lib = cpu_msm.build()
    build_s = time.perf_counter() - t0
    out = dict(build_s=build_s, ms={})
    for curve in CPU_MSM_CURVES:
        xs, ys, hw, base = preprocess.gen_planar_inputs(curve, CPU_MSM_N,
                                                        seed=99, k_base=64)
        want = preprocess.expected_msm(base, hw, curve)
        ts = time.perf_counter()
        got = cpu_msm.cpu_msm_words(*wire_words(curve, xs, ys, hw), curve)
        ms = (time.perf_counter() - ts) * 1e3
        if not ref.jac_eq(curve, got, want):
            raise AssertionError(f"cpu-msm {curve.name}: differs from the "
                                 "oracle")
        out["ms"][curve.name] = ms
        print(f"[cpu-msm] {curve.name} n={CPU_MSM_N} cpu_msm EXACT in "
              f"{ms:.1f} ms ({os.cpu_count()} host cores)", flush=True)
    out["mont_per_s"] = cpu_msm.mont_throughput()
    out["seconds"] = time.perf_counter() - t0
    print(f"[cpu-msm] {os.path.basename(lib)} built in {build_s:.1f} s; "
          f"mont_throughput {out['mont_per_s']:.4g} BN254 Montgomery "
          f"multiplies a second on one host core; every phase passed in "
          f"{out['seconds']:.1f} s [{card}]", flush=True)
    return out


def multipass_phase(card: str) -> dict:
    """2^MULTIPASS_LOGN points through tpu_variable_base_msm under
    max_points_per_pass = MULTIPASS_PASS (several passes, the next pass's
    inputs copied on the side stream), without GLV and with it; each
    EXACT against the oracle and equal to cpu_msm on the same points and
    scalars."""
    t0 = time.perf_counter()
    logn, n = MULTIPASS_LOGN, 1 << MULTIPASS_LOGN
    xs, ys, hw, base = preprocess.gen_planar_inputs(CURVE, n, seed=99,
                                                    k_base=64)
    want = preprocess.expected_msm(base, hw, CURVE)
    ts = time.perf_counter()
    native = cpu_msm.cpu_msm_words(*wire_words(CURVE, xs, ys, hw), CURVE)
    native_s = time.perf_counter() - ts
    if not ref.jac_eq(CURVE, native, want):
        raise AssertionError("multipass: cpu_msm differs from the oracle")
    points = [base[i % len(base)] for i in range(n)]
    scalars = preprocess.halfwords_to_ints(hw)
    out = dict(cpu_msm_s=native_s)
    for glv in (False, True):
        cfg = dataclasses.replace(static_config(n, CURVE), glv=glv,
                                  max_points_per_pass=MULTIPASS_PASS)
        kernels.reset_launches()
        ts = time.perf_counter()
        got = tpu_variable_base_msm(points, scalars, config=cfg,
                                    device=DEVICE)
        wall = time.perf_counter() - ts
        label = f"multipass{' glv' if glv else ''}"
        launches = main_launches(label, glv)
        passes = launches["pbpr_full"]
        expect = -(-n // (MULTIPASS_PASS // (2 if glv else 1)))
        if passes != expect:
            raise AssertionError(f"{label}: {passes} passes, expected "
                                 f"{expect}")
        # one glv_apply and one decompose_digits a pass under GLV
        if (launches.get("glv_apply", 0), launches["decompose_digits"]) != (
                passes if glv else 0, passes):
            raise AssertionError(f"{label}: launches {launches}")
        if not ref.jac_eq(CURVE, got, want) or \
                not ref.jac_eq(CURVE, got, native):
            raise AssertionError(f"{label}: differs from the oracle or "
                                 "cpu_msm")
        out[label] = dict(passes=passes, wall_s=wall, launches=launches)
        print(f"[multipass] {CURVE.name} n=2^{logn} glv={glv} "
              f"max_points_per_pass={MULTIPASS_PASS}: {passes} passes "
              f"(pbpr_full launches), EXACT and equal to cpu_msm; "
              f"tpu_variable_base_msm {wall:.2f} s (host pack included); "
              f"launches={launches} [{card}]", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"[multipass] cpu_msm on the same {n} points {native_s:.2f} s; "
          f"every phase passed in {out['seconds']:.1f} s [{card}]",
          flush=True)
    return out


def service_request(port: int, curve_id: int, words) -> tuple:
    """One request over loopback: (reply, wall seconds)."""
    curve = app_protocol.CURVE_IDS[curve_id]
    ts = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port)) as sock:
        app_protocol.send_request(sock, curve_id, *words)
        res = app_protocol.recv_result(sock, curve)
    return res, time.perf_counter() - ts


def service_phase(card: str) -> dict:
    """`app.service.serve` on the card, port 0, in this process: one
    loopback request at 2^SERVICE_LOGN on BN254_S12 (counted), two
    clients at once (BN254_S12 and BLS12_377_S12), one off-curve request
    that must get the error frame."""
    t0 = time.perf_counter()
    logn = SERVICE_LOGN
    reqs = []
    for curve_id in (0, 1):
        curve = app_protocol.CURVE_IDS[curve_id]
        xs, ys, hw, _, want = inputs(curve, logn)
        reqs.append((curve_id, wire_words(curve, xs, ys, hw), want))
    srv = app_service.serve(port=0, background=True, device=DEVICE)
    out = {}
    try:
        port = srv.server_address[1]
        curve_id, words, want = reqs[0]
        kernels.reset_launches()
        res, wall = service_request(port, curve_id, words)
        launches = main_launches("service")
        if not ref.jac_eq(CURVE, (res.x, res.y, res.z), want):
            raise AssertionError("service: the reply differs from the oracle")
        out["one"] = dict(wall_s=wall, compute_ms=res.compute_ms,
                          launches=launches)
        print(f"[service] {CURVE.name} n=2^{logn} over loopback: EXACT, "
              f"wall {wall:.3f} s, compute_ms {res.compute_ms:.2f}; "
              f"launches={launches} [{card}]", flush=True)

        done = {}

        def client(req):
            done[req[0]] = service_request(port, req[0], req[1])

        threads = [threading.Thread(target=client, args=(r,)) for r in reqs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for curve_id, _, want in reqs:
            if curve_id not in done:
                raise AssertionError(f"service: concurrent request on curve "
                                     f"{curve_id} got no reply")
            res, wall = done[curve_id]
            curve = app_protocol.CURVE_IDS[curve_id]
            if not ref.jac_eq(curve, (res.x, res.y, res.z), want):
                raise AssertionError(f"service: concurrent {curve.name} "
                                     "reply differs from the oracle")
            out[f"concurrent {curve.name}"] = dict(
                wall_s=wall, compute_ms=res.compute_ms)
            print(f"[service] two clients at once: {curve.name} n=2^{logn} "
                  f"EXACT, wall {wall:.3f} s, compute_ms "
                  f"{res.compute_ms:.2f} [{card}]", flush=True)

        nw, sw = app_protocol.curve_words(CURVE)
        bad = app_protocol.ints_to_words(
            [CURVE.gen_x, CURVE.gen_x], nw), app_protocol.ints_to_words(
            [CURVE.gen_y, CURVE.gen_y + 1], nw), app_protocol.ints_to_words(
            [3, 5], sw)
        with socket.create_connection(("127.0.0.1", port)) as sock:
            app_protocol.send_request(sock, 0, *bad)
            status, _ = struct.unpack("<Id", app_protocol.recv_exact(sock, 12))
            (ln,) = struct.unpack("<I", app_protocol.recv_exact(sock, 4))
            msg = app_protocol.recv_exact(sock, ln).decode()
        if status != 1 or "point 1 rejected" not in msg:
            raise AssertionError(f"service: off-curve request answered "
                                 f"status {status}: {msg!r}")
        print(f"[service] off-curve request: error frame {msg!r} [{card}]",
              flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
    out["seconds"] = time.perf_counter() - t0
    print(f"[service] every phase passed in {out['seconds']:.1f} s [{card}]",
          flush=True)
    return out


def host_phases(card: str) -> dict:
    """Phases 13 to 17."""
    return {"autotune": autotune_phase(card), "profile": profile_phase(card),
            "cpu_msm": cpu_msm_phase(card),
            "multipass": multipass_phase(card),
            "service": service_phase(card)}


def main() -> int:
    global RUN_TMP
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as RUN_TMP:
        os.environ[window.CACHE_ENV] = os.path.join(RUN_TMP,
                                                    "autotune_cache.json")
        return main_on_card(t_start)


def main_on_card(t_start: float) -> int:
    """Phases 1 and 2, then run_all."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {_build.build_seconds})", flush=True)
    resources = {}
    for stem in ("col_prefix", "prefix_scan", "pbpr_full", "encode_mont",
                 "padd_batch", "pdbl_batch", "pbpr_stage1", "globalize",
                 "glv_apply", "to_affine", "batch_inverse",
                 "extract_buckets", "bucket_sort", "smvp_rows",
                 "smvp_stitch", "decompose_digits"):
        for fn, regs, stack, st, ld in _build.resources(stem):
            # kernel name and template arguments <L, W[, G, types]> from
            # the mangled name (bucket_sort's and decompose_digits' are no
            # profile's)
            targs = (template_args(fn, "_kernel") if "_kernelI" in fn
                     else [])
            if (stem not in NO_PROFILE_STEMS
                    and int(targs[0]) not in PTXAS_LIMBS):
                continue
            resources[f"{stem}.{kernel_label(fn)}"] = dict(
                registers=regs, stack_bytes=stack, spill_store_bytes=st,
                spill_load_bytes=ld)
    for k, v in resources.items():
        print(f"[ptxas] {k}: {v} [{card}]", flush=True)
    sass = {}
    # each object once (encode_mont.cu holds encode_rows too)
    for stem in dict.fromkeys(os.path.basename(SOURCES[k][0])[:-3]
                              for k in WIDE):
        for fn, counts in sass_counts(stem).items():
            sass[f"{stem}.{fn}"] = counts
            print(f"[sass] {stem}.{fn}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items() if v or k == "LD")
                + f" [{card}]", flush=True)
    # decompose_digits: every form, by element type and scalars a thread
    for fn, counts in sass_counts("decompose_digits").items():
        sass[f"decompose_digits.{fn}"] = counts
        print(f"[sass] decompose_digits.{fn}: " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v) + f" [{card}]",
            flush=True)
    show = lambda c: ", ".join(f"{k} {v}" for k, v in c.items() if v)
    for fn, counts in callee_counts("prefix_scan").items():
        sass[f"mul_wide.{fn}"] = counts
        before = MUL_WIDE_SASS_BEFORE.get(fn)
        print(f"[sass] mul_wide: msm::mul_wide as prefix_scan's {fn} calls "
              f"it: {show(counts)}"
              + (f"; before its rows were carry chains (the parent's build, "
                 f"scripts/torch_ab.py): {show(before)}" if before else "")
              + f" [{card}]", flush=True)

    return run_all(card, t_start, resources, sass)


def warm_plain(curve) -> None:
    """The plain point formulas once on two lanes, so that no compared
    plain version is timed with PyTorch's first-use set-up on the card,
    which can take seconds."""
    z = kernels.inf_stacked(curve, (2,), DEVICE)
    kernels.padd_batch_plain(z, z, curve)
    kernels.psub_batch_plain(z, z, curve)
    kernels.pdbl_batch_plain(z, curve)
    kernels.encode_mont_plain(z[0], curve)
    kernels.encode_rows_plain(z[0], z[0], curve)
    kernels.decompose_digits_plain(
        torch.zeros((18, 2), dtype=torch.int32, device=DEVICE), 13, 20)
    torch.cuda.synchronize()


def result_fields(r: dict, sfx: str = "") -> dict:
    """What the kernels line keeps of one `compare` result."""
    return {f"max_abs_err{sfx}": r["max_abs_err"], f"ms{sfx}": r["ms"],
            f"ms_back_to_back{sfx}": r["ms_cuda"],
            f"plain_ms{sfx}": r["plain_ms"], f"bound_ms{sfx}": r["bound_ms"],
            f"bound_by{sfx}": r["bound_by"],
            f"bound_ms_mont_mul_ops{sfx}": r["bound_ms_mont_mul_ops"],
            f"library_ms{sfx}": None}


def glv_entry(entry: dict, checks, runs, runs_glv, twin, host,
              profiles) -> dict:
    """The kernels line's `glv_apply`: launches of the GLV user calls
    (the main path's are 0), its compare at each size, apply_glv whole,
    the twin's and the multi-pass run's launches."""
    for logn in sorted(SIZES, reverse=True):
        sfx = "" if logn == max(SIZES) else f"_2p{logn}"
        r = checks[logn]["glv"]["glv_apply"]
        entry.update({f"launches{sfx}": runs_glv[logn][0]["glv_apply"],
                      f"launches_main{sfx}": runs[logn][0]["glv_apply"],
                      f"apply_glv_ms{sfx}": r["apply_glv_ms"],
                      **result_fields(r, sfx)})
    tr = twin["runs"].values()
    entry["launches_twin"] = {r["label"]: r["launches"].get("glv_apply", 0)
                              for r in tr}
    entry["launches_multipass_glv"] = host["multipass"]["multipass glv"][
        "launches"]["glv_apply"]
    entry["bit_exact"] = True
    entry["at"] = (f"n=2^{max(SIZES)} GLV (suffix _2p16: n=2^16), the edge "
                   "scalars in the first lanes")
    entry["profiles"] = {c: profile_entry("glv_apply", prof)
                         for c, prof in profiles.items()}
    return entry


def tree_floor_ms(name: str, K: int, lat: dict) -> float:
    """The depth floor of one call of the product tree on K elements: the
    root's chain and a multiply a level up and down (2 log2 Kp), and
    to_affine's 3 multiplies (Z one, X zinv, Y zinv); from [latency]'s
    to_affine on one point, the chain and those 3, whose multiplies give
    a multiply's latency (one thread's at BN254_S12, `chain_form`)."""
    one, mul_ms = lat["to_affine_one_lane_ms"], lat["tree_mul_ms"]
    levels = (K - 1).bit_length()
    return one + (2 * levels - (0 if name == "to_affine" else 3)) * mul_ms


def affine_entry(entry: dict, name: str, full, affine, affine_glv, lat,
                 profiles) -> dict:
    """The kernels line's `to_affine` or `batch_inverse`: the user call at
    K = 2^AFFINE_LOGK - 3 (its launches, counted) and its compare there;
    its depth floor (`tree_floor_ms`). For `to_affine` also the window
    sums with the Z edges, without GLV and with it (one launch each)."""
    r = full[name]
    entry.update(launches=r["launches"], user_ms=r["user_ms"],
                 launched=r["launched"], **result_fields(r))
    entry["depth_floor_ms"] = tree_floor_ms(name, r["K"], lat)
    entry["tree_mul_ms"] = lat["tree_mul_ms"]
    entry["chain_on"] = chain_form(CURVE)
    if "split" in r:
        entry["launch_ms"] = r["split"]
    at = f"K={r['K']} points made on the card, Z of 0, p, 2p, 3p at edges"
    if name == "to_affine":
        for sfx, w in (("_window_sums", affine),
                       ("_window_sums_glv", affine_glv)):
            entry.update({f"launches{sfx}": w["launches"],
                          f"user_ms{sfx}": w["user_ms"],
                          **result_fields(w, sfx)})
        entry["depth_floor_ms_window_sums"] = tree_floor_ms(
            name, affine["K"], lat)
        at += (f"; suffix _window_sums: the (3, L, Wp + 4) window sums of "
               f"n=2^{min(SIZES)} with 4 lanes of Z = 0, p, 2p, 3p (_glv: "
               "GLV)")
    else:
        at = f"K={r['K']}: the Z plane of those points, 0 and p at edges"
    entry["bit_exact"] = True
    entry["at"] = at
    entry["profiles"] = {c: profile_entry(name, prof)
                         for c, prof in profiles.items()}
    return entry


def smvp_entry(entry: dict, name: str, twin: dict, lat: dict) -> dict:
    """The kernels line's `smvp_rows` or `smvp_stitch`, from the twin's
    runs: its launches in the user call of the BN254_S12 2^20 run and its
    compare there (the first group), with suffix _2p16 the 2^16 run's;
    its depth floor (`smvp_rows`: the longest run inside one column of
    the group's keys less one, each a row of its lane, beside the floor
    of R scan steps it had before the keys were counted;
    `smvp_stitch`: the chain of dependent adds that the group's
    keys need, each a stitch level; both from `[latency]`); its
    launches, time and error in every twin run."""
    tr = twin["runs"]
    for logn in sorted(SIZES, reverse=True):
        sfx = "" if logn == max(SIZES) else f"_2p{logn}"
        run = tr[twin_label(CURVE, logn, False)]
        r = next(v for v in run["results"].values() if v["name"] == name)
        entry.update({f"launches{sfx}": run["launches"][name],
                      f"launched{sfx}": r["launched"],
                      f"bound_ms_mont_mul_ops{sfx}": r[
                          "bound_ms_mont_mul_ops"],
                      **result_fields(r, sfx)})
        cfg = twin_config(CURVE, logn, False)
        if name == "smvp_rows":
            entry[f"depth_floor_ms{sfx}"] = run["rows"]["floor_ms"]
            entry[f"depth_floor_ms_rows_R{sfx}"] = run["rows"]["floor_R_ms"]
            entry[f"longest_run{sfx}"] = run["rows"]["longest_run"]
        else:
            entry[f"depth_floor_ms{sfx}"] = run["stitch_floor_ms"]
            entry[f"levels_ran{sfx}"] = run["stitch"]["levels_ran"]
            entry[f"grid_barriers{sfx}"] = run["stitch"]["barriers"]
    entry["launches_twin"] = {k: r["launches"][name] for k, r in tr.items()}
    entry["ms_twin"] = {k: r["kernel_ms"][name] for k, r in tr.items()}
    entry["max_abs_err_twin"] = max(
        v["max_abs_err"] for r in tr.values() for v in r["results"].values()
        if v["name"] == name)
    entry["bit_exact"] = True
    entry["at"] = (f"the XLA path's first window group at n=2^{max(SIZES)} "
                   f"(suffix _2p16: n=2^16), BN254_S12")
    return entry


def run_all(card: str, t_start: float, resources: dict, sass: dict) -> int:
    """Phases 3 to 19; `[phases]` prints the seconds each took, against
    the run's time limit."""
    seconds = {}

    def timed_phase(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = round(time.perf_counter() - t0, 1)
        return out

    warm_plain(CURVE)
    checks = timed_phase("check_size", lambda: {
        logn: check_size(logn, card) for logn in SIZES})
    runs = timed_phase("main_path", lambda: {
        logn: main_path(CURVE, logn, card) for logn in SIZES})
    runs_glv = timed_phase("main_path glv", lambda: {
        logn: main_path(CURVE, logn, card, glv=True) for logn in SIZES})
    sched_ms, sched_launches = timed_phase("schedule",
                                           lambda: schedule_run(card))
    lat = timed_phase("latency", lambda: latency(CURVE, card,
                                                 runs[max(SIZES)][3]))
    lanes_ms = timed_phase("scan-lanes", lambda: lane_sweep(CURVE, card))
    affine, affine_glv, affine_big = timed_phase("affine", lambda: (
        affine_check(CURVE, min(SIZES), card, glv=False),
        affine_check(CURVE, min(SIZES), card, glv=True),
        affine_full(CURVE, AFFINE_LOGK, card)))
    rests = timed_phase("rest", lambda: {logn: rest_split(logn)
                                         for logn in SIZES})
    large = timed_phase("large", lambda: large_phase(card))
    started = cpu_checks_start(checks[max(SIZES)]["pbpr_edges"])
    try:
        profiles = timed_phase("profiles", lambda: {
            c.name: run_profile(c, sizes, card) for c, sizes in PROFILES})
        shard_run = timed_phase("sharded", lambda: sharded_phase(card))
        twin = timed_phase("twin", lambda: twin_phase(card, lat))
        # the wait for the CPU's plain versions, if they are not done
        timed_phase("cpu_checks", lambda: cpu_checks(started, card))
    finally:
        if started is not None:
            started[0].shutdown(cancel_futures=True)
    host = timed_phase("host", lambda: host_phases(card))
    print(f"[phases] seconds by phase {seconds}, "
          f"{time.perf_counter() - t_start:.1f} s since the start [{card}]",
          flush=True)

    for logn in SIZES:
        kern_ms = where_line("where", logn, runs[logn][0],
                             checks[logn]["main"], runs[logn][1], card)
        where_line("where-glv", logn, runs_glv[logn][0], checks[logn]["glv"],
                   runs_glv[logn][1], card,
                   f"; apply_glv {checks[logn]['apply_glv_ms']:.2f} ms")
        rest_line(logn, rests[logn], runs[logn][1] - kern_ms, card)

    entries = []
    nccl, gloo = shard_run["nccl"], shard_run["gloo"]
    for name in KERNELS:
        src, replaces, path = SOURCES[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "path": path}
        if name == "glv_apply":
            entries.append(glv_entry(entry, checks, runs, runs_glv, twin,
                                     host, profiles))
            continue
        if name in ("to_affine", "batch_inverse"):
            entries.append(affine_entry(entry, name, affine_big, affine,
                                        affine_glv, lat, profiles))
            continue
        if name in ("smvp_rows", "smvp_stitch"):
            entries.append(smvp_entry(entry, name, twin, lat))
            continue
        for logn in sorted(SIZES, reverse=True):
            # the first compared call of the kernel (padd_batch: i16 -> i32;
            # pdbl_batch: the (Wg, B+1) batch)
            c = checks[logn]
            first = lambda res: next(v for v in res.values()
                                     if v["name"] == name)
            r = first(c["main"])
            sfx = "" if logn == max(SIZES) else f"_2p{logn}"
            if name in MAIN or name in ("padd_batch", "encode_mont"):
                # padd_batch: the main path's (0: stage 3 is
                # extract_buckets'); encode_mont the same (0: stage 1 is
                # encode_rows')
                launches = runs[logn][0][name]
            elif name == "globalize":
                launches = c["globalize_launches"]
            else:
                launches = c["reduce_launches"][name]
            entry.update({
                f"launches{sfx}": launches,
                f"max_abs_err{sfx}": r["max_abs_err"],
                f"ms{sfx}": r["ms"], f"ms_back_to_back{sfx}": r["ms_cuda"],
                f"plain_ms{sfx}": r["plain_ms"],
                f"bound_ms{sfx}": r["bound_ms"],
                f"bound_by{sfx}": r["bound_by"],
                f"library_ms{sfx}": r.get("library_ms")})
            if name in ("bucket_sort", "extract_buckets"):
                # the chain of torch ops and launches it replaced, and the
                # geometry of its launch in the user call
                rg = first(c["glv"])
                entry.update({f"chain_ms{sfx}": r["chain_ms"],
                              f"chain_ms_glv{sfx}": rg["chain_ms"],
                              f"library_ms_glv{sfx}": rg.get("library_ms"),
                              f"launched{sfx}": r["launched"]})
            if name == "encode_rows":
                # under GLV glv_apply writes the table (0 launches here)
                entry[f"launches_glv{sfx}"] = runs_glv[logn][0][name]
            elif name in MAIN:
                rg = first(c["glv"])
                entry.update({
                    f"launches_glv{sfx}": runs_glv[logn][0][name],
                    f"ms_glv{sfx}": rg["ms"],
                    f"plain_ms_glv{sfx}": rg["plain_ms"],
                    f"bound_ms_glv{sfx}": rg["bound_ms"],
                    f"max_abs_err_glv{sfx}": rg["max_abs_err"]})
            if name in WIDE:
                entry[f"bound_ms_mont_mul_ops{sfx}"] = r[
                    "bound_ms_mont_mul_ops"]
            if name == "decompose_digits":
                # its launch and a copy of the same bytes
                entry.update({f"launched{sfx}": r["launched"],
                              f"copy_ms{sfx}": r["copy_ms"]})
            if name in ("pdbl_batch", "pbpr_stage1", "globalize"):
                entry[f"launched{sfx}"] = r["launched"]
            if name == "pdbl_batch":
                # the (3, L, Wp) sum that bucket_reduce doubles
                rw = c["main"]["pdbl_batch[Wp]"]
                entry.update({f"ms_Wp{sfx}": rw["ms"],
                              f"bound_ms_Wp{sfx}": rw["bound_ms"],
                              f"launched_Wp{sfx}": rw["launched"]})
            if name == "padd_batch":
                # timed at the shapes of the stage-3 chain it served on the
                # main path until PR 15
                entry[f"launches_reduce{sfx}"] = c["reduce_launches"][name]
                entry[f"launched{sfx}"] = r["launched"]
                entry[f"ms_psub{sfx}"] = c["main"][
                    f"psub_batch[{torch.int32}->{torch.int16}]"]["ms"]
            if name == "extract_buckets":
                entry[f"launched_user_call{sfx}"] = runs[logn][5]
            if name == "pbpr_full":
                # as the user call launched it (kernels.LAUNCHED)
                entry[f"launched{sfx}"] = runs[logn][4]
                entry[f"launched_glv{sfx}"] = runs_glv[logn][4]
            if name == "prefix_scan":
                for key, sw, run in (
                        ("", c["scan_sweep"], runs[logn]),
                        ("_glv", c["scan_sweep_glv"], runs_glv[logn])):
                    entry[f"threads_per_lane{key}{sfx}"] = run[3]
                    entry[f"ms_by_threads_per_lane{key}{sfx}"] = sw["ms"]
        lg = large[f"2^{min(LARGE_LOGN)}"]
        if name in lg["kernels"]:
            # at the large shapes: 2^22 in one pass
            r = lg["kernels"][name]
            sfx = f"_2p{min(LARGE_LOGN)}"
            if "copy_ms" in r:
                entry[f"copy_ms{sfx}"] = r["copy_ms"]
            entry.update({f"launches{sfx}": lg["launches"][name],
                          f"ms{sfx}": r["ms"], f"plain_ms{sfx}": r["plain_ms"],
                          f"bound_ms{sfx}": r["bound_ms"],
                          f"bound_by{sfx}": r["bound_by"],
                          f"max_abs_err{sfx}": r["max_abs_err"]})
        if name in MAIN:
            # the sharded path's launches at 2^SHARDED_LOGN: the one NCCL
            # rank's and each gloo rank's
            entry["launches_sharded"] = {
                f"x=1 {nccl['backend']}": nccl["launches"].get(name, 0),
                **{f"{k} gloo": [r["launches"].get(name, 0)
                                 for r in v["ranks"]]
                   for k, v in gloo.items()}}
            # against its plain version at every shape of the sharded
            # path: the shards, the ranks' spans and the trees
            entry["max_abs_err_sharded"] = max(
                r["max_abs_err"] for r in sharded_compares(shard_run)
                if r["name"] == name)
        if name in MAIN:
            # the paths of phases 13 to 17, each counted on its own
            # (the counts keep only kernels that launched: under GLV,
            # glv_apply writes the table in encode_rows' place)
            entry["launches_host_phases"] = {
                **{f"autotune {k}": v["launches"].get(name, 0)
                   for k, v in host["autotune"].items() if k != "seconds"},
                "profile": host["profile"]["launches"].get(name, 0),
                **{k: v["launches"].get(name, 0)
                   for k, v in host["multipass"].items()
                   if isinstance(v, dict)},
                "service": host["service"]["one"]["launches"].get(name, 0)}
        if name == "padd_batch":
            # of which the halving tree's
            entry["launches_sharded_tree"] = {
                f"x=1 {nccl['backend']}": nccl["tree_launches"],
                **{f"ndev={d} check": t["launches"]
                   for d, t in shard_run["reduce_tree"].items()},
                **{f"{k} gloo": [r["tree_launches"] for r in v["ranks"]]
                   for k, v in gloo.items()}}
        # depth floors at the largest size: the least time of the chain of
        # dependent point operations, each on a warp with nothing to wait for
        if name == "col_prefix":
            levels = max(default_config(1 << max(SIZES), CURVE
                                        ).columns.bit_length() - 1, 1)
            entry["depth_floor_ms"] = levels * lat["col_prefix_level_ms"]
        if name == "pbpr_full":
            # (Bt + 1) stage-1 steps, 2 log2 T scan levels, then the tail:
            # log2 Bt doublings and one add, the add taken as a step
            cfg = default_config(1 << max(SIZES), CURVE)
            T = cfg.pbpr_threads
            Bt = cfg.half_columns // T
            entry["depth_floor_ms"] = (
                (Bt + 2) * lat["pbpr_step_ms"]
                + 2 * (T.bit_length() - 1) * lat["pbpr_level_ms"]
                + (Bt.bit_length() - 1) * lat["pbpr_doubling_ms"])
        if name == "pbpr_stage1":
            # Bt + 1 steps, the m and g chains one step apart
            cfg = default_config(1 << max(SIZES), CURVE)
            Bt = cfg.half_columns // min(cfg.pbpr_threads, cfg.half_columns)
            entry["depth_floor_ms"] = (Bt + 1) * lat["pbpr_stage1_step_ms"]
        if name == "pdbl_batch":
            # the (3, L, Wp) shape: one doubling, on a lone warp
            entry["depth_floor_ms_Wp"] = lat["pdbl_one_warp_ms"]
        if name == "extract_buckets":
            # one block: two dependent adds on its lanes
            entry["depth_floor_ms"] = lat["extract_one_block_ms"]
        if name == "prefix_scan":
            for key, run in (("", runs), ("_glv", runs_glv)):
                R = (2 if key else 1) * (1 << max(SIZES)) // default_config(
                    1 << max(SIZES), CURVE).columns
                entry[f"depth_floor_ms{key}"] = (
                    R * lat["scan_step_ms"][run[max(SIZES)][3]])
        if name in TWIN_KERNELS:
            # the twin's user calls: launches, the kernel's time over the
            # run (each shape's time by its calls), the largest error
            # against the plain version at every captured shape
            tr = twin["runs"].values()
            entry["launches_twin"] = {r["label"]: r["launches"].get(name, 0)
                                      for r in tr}
            entry["ms_twin"] = {r["label"]: r["kernel_ms"].get(name, 0.0)
                                for r in tr}
            entry["max_abs_err_twin"] = max(
                v["max_abs_err"] for r in tr for v in r["results"].values()
                if v["name"] == name)
            entry["ms_twin_by_shape"] = {
                r["label"]: {k: v["ms"] for k, v in r["results"].items()
                             if v["name"] == name} for r in tr}
        entry["bit_exact"] = True
        entry["at"] = f"n=2^{max(SIZES)} (suffix _2p16: n=2^16)"
        entry["profiles"] = {c: profile_entry(name, prof)
                             for c, prof in profiles.items()}
        entries.append(entry)
    pick = lambda d, i: {f"2^{k}": v[i] for k, v in d.items()}
    print(f"[total] chip_smoke wall time {time.perf_counter() - t_start:.1f} s"
          f" [{card}]", flush=True)
    print(json.dumps({
        "kernels": entries,
        "msm_ms": pick(runs, 1), "h2d_ms": pick(runs, 2),
        "msm_glv_ms": pick(runs_glv, 1), "h2d_glv_ms": pick(runs_glv, 2),
        "bucket_reduce_ms": {f"2^{k}": v["reduce_ms"]
                             for k, v in checks.items()},
        "apply_glv_ms": {f"2^{k}": v["apply_glv_ms"]
                         for k, v in checks.items()},
        "to_affine_ms": {f"2^{min(SIZES)}": affine["user_ms"],
                         f"2^{min(SIZES)} glv": affine_glv["user_ms"],
                         f"K={affine_big['to_affine']['K']}":
                             affine_big["to_affine"]["user_ms"]},
        "batch_inverse_ms": {f"K={affine_big['batch_inverse']['K']}":
                             affine_big["batch_inverse"]["user_ms"]},
        "schedule": {**SCHEDULE, "msm_ms": sched_ms,
                     "launches": sched_launches},
        "latency_32_lanes": lat, "scan_by_lanes": lanes_ms,
        "pbpr_full_edges": checks[max(SIZES)]["pbpr_edges"],
        "rest_ms": {f"2^{k}": v for k, v in rests.items()},
        "large": {k: ({f: x for f, x in v.items() if f != "kernels"}
                      if isinstance(v, dict) else v)
                  for k, v in large.items()},
        "ptxas": resources, "sass": sass,
        "sharded": shard_run,
        "twin": {"runs": {k: {f: v for f, v in r.items()
                              if f not in ("results", "calls")}
                          for k, r in twin["runs"].items()},
                 "stage2": {label: {k: {f: v[f] for f in (
                     "ms", "chain_ms", "chain_launches", "plain_ms")}
                     for k, v in r["results"].items() if "chain_ms" in v}
                     for label, r in twin["runs"].items()},
                 "seconds": twin["seconds"]},
        **host,
        "profiles": {c: dict(
            msm_ms={f"2^{k}": v[1] for k, v in prof["runs"].items()},
            h2d_ms={f"2^{k}": v[2] for k, v in prof["runs"].items()},
            msm_glv_ms=prof["glv"][1] if "glv" in prof else None,
            to_affine_ms=prof["affine"]["user_ms"] if "affine" in prof
            else None,
            to_affine_full_ms=prof["affine_full"]["to_affine"]["user_ms"]
            if "affine_full" in prof else None,
            batch_inverse_full_ms=prof["affine_full"]["batch_inverse"][
                "user_ms"] if "affine_full" in prof else None,
            scan_by_lanes=prof.get("scan_by_lanes"),
            bucket_reduce_ms={f"2^{k}": v["reduce_ms"]
                              for k, v in prof["nine"].items()},
            seconds=prof["seconds"]) for c, prof in profiles.items()},
        "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Cycles of the root chain's multiplies on the card, by clock64().

    python3 scripts/chain_cycles.py

Builds a small kernel with nvcc into a temporary directory (the headers
of tpu_msm_torch/csrc, as the library uses them) and runs it on one
warp alone, at BN254_S12 and BLS12_377_S12:
  - the whole Fermat chain of `WarpMul::fermat` (csrc/batch_inv.cuh),
    the chain `batch_inverse` and `to_affine` run on the product tree's
    root, and its cycles a multiply;
  - one warp multiply split into its phases: the product's columns and
    their fold; M's columns from the published fold; M's resolve; M
    published and u's columns; u's resolve; u published and its words
    read by every lane;
  - 64 dependent `Tree::mul` squarings on one thread (the multiply the
    chain ran on before), and its cycles a multiply.
The numbers are the card's SM clock cycles, not time: a multiply's
latency with nothing else on the SM. It needs one card and nvcc."""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cstring>
#include "batch_inv.cuh"

using namespace msm;

template <int L, int W>
__global__ void bench(const TreeConsts<L, W> C, long long* out,
                      uint32_t* sink) {
  using WM = WarpMul<L, W>;
  using Tr = Tree<L, W>;
  constexpr int N = WM::N;
  __shared__ typename WM::Buf sb;
  __shared__ uint32_t ebits[N];
  const int k = threadIdx.x;
  if (k == 0)
    for (int i = 0; i < N; i++) ebits[i] = C.e[i];
  __syncwarp();
  uint32_t x[N];
  for (int i = 0; i < N; i++) x[i] = C.one[i] ^ (0x9e3779b9u * (i + 1));
  if (WM::RB > 0) x[N - 1] &= (1u << WM::RB) - 1;
  const long long t0 = clock64();
  const uint32_t r = WM::fermat(x, C, ebits, sb, k);
  __syncwarp();
  const long long t1 = clock64();
  typename WM::Lane c;
  WM::lane_consts(c, C, k);
  uint32_t a[N], bs[N];
  for (int i = 0; i < N; i++) {
    a[i] = x[i];
    bs[i] = k - i >= 0 && k - i < N ? x[k - i] : 0;
  }
  long long s[7];
  __syncwarp();
  s[0] = clock64();
  typename WM::Col t3[3] = {};
#pragma unroll
  for (int i = 0; i < N; i++) WM::mad(t3[i % 3], a[i], bs[i]);
  const typename WM::Col t = WM::sum3(t3[0], t3[1], t3[2]);
  uint32_t w, g;
  WM::fold(t, k, w, g);
  s[1] = clock64();
  sb.w[k] = w;
  sb.g[k] = g;
  __syncwarp();
  uint32_t wv[N], gv[N];
  WM::load(sb.w, wv);
  WM::load(sb.g, gv);
  typename WM::Col m3[3] = {};
#pragma unroll
  for (int i = 0; i < N; i++) {
    WM::mad(m3[i % 3], wv[i], c.q[i]);
    WM::mad(m3[(i + 1) % 3], gv[i], c.q1[i]);
  }
  const typename WM::Col msum = WM::sum3(m3[0], m3[1], m3[2]);
  s[2] = clock64();
  uint32_t mk = WM::resolve(msum, k);
  s[3] = clock64();
  if (k >= N) mk = 0;
  WM::publish(sb.m, mk, k);
  uint32_t mv[N];
  WM::load(sb.m, mv);
  typename WM::Col u3[3] = {t, {}, {}};
#pragma unroll
  for (int i = 0; i < N; i++) WM::mad(u3[(i + 1) % 3], mv[i], c.p[i]);
  const typename WM::Col usum = WM::sum3(u3[0], u3[1], u3[2]);
  s[4] = clock64();
  const uint32_t uk = WM::resolve(usum, k);
  s[5] = clock64();
  WM::publish(sb.u, uk, k);
  WM::words(sb, a);
  s[6] = clock64();
  uint32_t ta[N], tr[N];
  for (int i = 0; i < N; i++) ta[i] = x[i];
  const long long t2 = clock64();
  long long t3c = t2;
  if (k == 0) {
    for (int i = 0; i < 64; i++) {
      Tr::mul(ta, ta, tr, C.wide);
      for (int j = 0; j < N; j++) ta[j] = tr[j];
    }
    t3c = clock64();
  }
  if (k == 0) {
    out[0] = t1 - t0;
    for (int i = 0; i < 6; i++) out[1 + i] = s[i + 1] - s[i];
    out[7] = t3c - t2;
    sink[0] = r ^ a[0] ^ ta[0];
  }
}

template <int L, int W>
int run(const uint32_t* words, int nwords, long long* host) {
  TreeConsts<L, W> C;
  if (nwords * 4 != (int)sizeof(C)) return -1;
  std::memcpy(&C, words, sizeof(C));
  long long* d;
  uint32_t* r;
  if (cudaMalloc(&d, 8 * sizeof(long long)) || cudaMalloc(&r, 4)) return -3;
  for (int rep = 0; rep < 3; rep++) bench<L, W><<<1, 32>>>(C, d, r);
  cudaMemcpy(host, d, 8 * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d);
  cudaFree(r);
  return (int)cudaGetLastError();
}

extern "C" int chain_cycles(int L, int W, const uint32_t* words, int n,
                            long long* host) {
  if (L == 22 && W == 12) return run<22, 12>(words, n, host);
  if (L == 32 && W == 12) return run<32, 12>(words, n, host);
  return -2;
}
"""

PHASES = ("columns and fold", "M's columns", "M's resolve",
          "M published, u's columns", "u's resolve", "u published, words")


def main() -> int:
    from tpu_msm_torch import _build
    from tpu_msm_torch import constants as tc
    from tpu_msm_torch.cuzk import kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    tmp = Path(tempfile.mkdtemp(prefix="chain_cycles_"))
    try:
        src, lib = tmp / "chain_cycles.cu", tmp / "chain_cycles.so"
        src.write_text(SOURCE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
                        "-I", str(_build.CSRC), str(src), "-o", str(lib)],
                       check=True)
        so = ctypes.CDLL(str(lib))
        for curve in (tc.BN254_S12, tc.BLS12_377_S12):
            words = kernels._affine_consts_host(curve)
            arr = (ctypes.c_uint32 * len(words))(*words)
            out = (ctypes.c_longlong * 8)()
            rc = so.chain_cycles(curve.num_limbs, curve.log_limb_size, arr,
                                 len(words), out)
            if rc:
                raise RuntimeError(f"chain_cycles: rc {rc}")
            muls = words[-1] + bin(curve.p - 2).count("1")
            print(f"[chain] {curve.name}: the warp chain {out[0]} cycles, "
                  f"{out[0] / muls:.0f} a multiply ({muls} multiplies); one "
                  "warp multiply by phase: "
                  + ", ".join(f"{p} {v}" for p, v in zip(PHASES, out[1:7]))
                  + f"; one thread's Tree::mul {out[7] / 64:.0f} cycles "
                  f"(64 squarings, {out[7]} cycles) [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

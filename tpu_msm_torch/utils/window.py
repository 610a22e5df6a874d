"""Window-size cost model and the on-device autotune sweep with its cache.

The port of `tpu_msm/utils/window.py`. `predict_cost`,
`optimal_window_size` and `candidate_configs` are copies (the cuZK §4.1
point-add count of this pipeline's shape, its argmin over s, and the
model-seeded candidates around it). `autotune(n)` times each candidate
through `MSMPipeline` on the card and keeps the winner in a JSON cache
keyed by (device name, curve, n), which `config.default_config` reads
first.

The cache is the port's own file, `autotune_cache.json` in the build
directory (`_build.build_dir()`), or the path in
$TPU_MSM_TORCH_AUTOTUNE_CACHE. It is never the JAX package's
`.autotune_cache.json`: on a GPU host both packages would key an entry by
the same card name.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from .. import _build
from ..config import MSMConfig
from ..constants import BN254_S12, CurveParams
from ..cuzk.pipeline import MSMPipeline
from . import preprocess

CACHE_ENV = "TPU_MSM_TORCH_AUTOTUNE_CACHE"


def predict_cost(n: int, s: int, curve: CurveParams = BN254_S12,
                 columns: int | None = None, pbpr_threads: int | None = None
                 ) -> float:
    """Predicted complete-point-add count for one MSM at window size s.

    Per window: n mixed adds of the segmented scan over the sorted
    stream; 2 log2(C) C for the cross-column stitch; 2 B for PBPR stage
    1 (m and g running sums over B = 2^(s-1) buckets); about 2 T +
    log2(B/T) + s for stage 2 and the Horner doublings. All times
    W = ceil(scalar_bits / s)."""
    W = -(-curve.scalar_bits // s)
    B = 1 << (s - 1)
    C = columns or min(max(n // 8, 32), 2048)
    T = pbpr_threads or max(B // 2, 1)
    Bt = max(B // T, 1)
    per_window = (n                                  # scan adds
                  + 2 * C * max(math.log2(C), 1)     # stitch
                  + 2 * B                            # PBPR stage 1
                  + 2 * T + math.log2(Bt) + s)       # stage 2 + Horner dbls
    return W * per_window


def optimal_window_size(n: int, curve: CurveParams = BN254_S12,
                        s_range: Iterable[int] = range(8, 17)) -> int:
    """argmin of predict_cost over s."""
    return min(s_range, key=lambda s: predict_cost(n, s, curve))


def candidate_configs(n: int, curve: CurveParams = BN254_S12):
    """Model-seeded candidate MSMConfigs around the predicted optimum."""
    s_best = optimal_window_size(n, curve)
    out = []
    for s in {max(s_best - 1, 4), s_best, min(s_best + 1, 16)}:
        B = 1 << (s - 1)
        for c_exp in (7, 8, 9, 10):
            C = 1 << c_exp
            if C > max(n, 32):
                continue
            for wg in (1, 2, 4):
                try:
                    cfg = MSMConfig(curve=curve, window_size=s,
                                    columns=min(C, n),
                                    pbpr_threads=min(max(B // 2, 1), 512),
                                    subtask_group=wg)
                except ValueError:
                    continue
                out.append(cfg)
    return out


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


def cache_path() -> str:
    """$TPU_MSM_TORCH_AUTOTUNE_CACHE, else autotune_cache.json in the
    build directory. Read at every call."""
    return os.environ.get(CACHE_ENV) or str(
        _build.build_dir() / "autotune_cache.json")


def _load_cache() -> Dict:
    """The cache's entries; a missing or unreadable file has none."""
    try:
        with open(cache_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(cache: Dict) -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def cache_kind(device="cuda") -> str:
    """The cache's name for a device: the CUDA card's name with spaces
    as `_`, or "cpu"."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(dev).replace(" ", "_")


def _cache_key(kind: str, curve: CurveParams, n: int) -> str:
    return f"{kind}/{curve.name}/{n}"


_TUNED_FIELDS = ("window_size", "columns", "pbpr_threads",
                 "subtask_group", "max_points_per_pass")


def cached_config(n: int, curve: CurveParams = BN254_S12, device="cuda"):
    """The best measured config for (device, curve, n), or None: also
    when `device` is CUDA and no card is present."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return None
    rec = _load_cache().get(_cache_key(cache_kind(device), curve, n))
    if not rec:
        return None
    return MSMConfig(curve=curve,
                     **{k: rec[k] for k in _TUNED_FIELDS if k in rec})


def record_measured(n: int, curve: CurveParams, cfg, ms: float,
                    source: str, device_kind: str | None = None,
                    force: bool = False) -> None:
    """Persist a measured config for (device, curve, n).

    Best-measured semantics: an existing entry is replaced only by a
    faster measurement (whatever its config), so re-running an ingest of
    older numbers never undoes a faster winner; `force=True` replaces it
    anyway (after a code change that makes old times stale). `source`
    records where the time came from; `device_kind` defaults to the
    current CUDA card's name."""
    kind = (device_kind or cache_kind()).replace(" ", "_")
    key = _cache_key(kind, curve, n)
    cache = _load_cache()
    old = cache.get(key)
    if old and not force and old.get("ms", float("inf")) <= ms:
        return
    cache[key] = {k: getattr(cfg, k) for k in _TUNED_FIELDS} | {
        "ms": round(ms, 2), "source": source}
    _save_cache(cache)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def autotune(n: int, curve: CurveParams = BN254_S12, runs: int = 2,
             configs=None, verbose: bool = True, device="cuda") -> Tuple:
    """Time each candidate on `device` and persist the winner.

    Each candidate runs `MSMPipeline.window_sums` on inputs already on
    the device (the generator's tiled points, seed 5), once untimed and
    then `runs` times; its time is the median, on the host clock around
    a call that ends with the window sums decoded on the host. A
    candidate is skipped, with its reason printed, only when the port's
    own checks refuse it before its launch (ValueError) or the card runs
    out of memory; any other error ends the sweep, since a failed CUDA
    launch leaves the context unusable.

    Returns (best config, [(config, median ms), ...])."""
    results: List[Tuple] = []
    configs = configs or candidate_configs(n, curve)
    host, staged = None, {}
    for cfg in configs:
        pipe = MSMPipeline(cfg, device)
        n_pad = pipe.padded_size(n)
        if host is None or host[0].shape[1] < n_pad:
            xs, ys, hw, _ = preprocess.gen_planar_inputs(curve, n_pad, seed=5)
            hw[:, n:] = 0
            hw = np.concatenate(
                [hw, np.zeros((2, hw.shape[1]), np.uint32)], axis=0)
            host, staged = [a.astype(np.int32) for a in (xs, ys, hw)], {}
        if n_pad not in staged:
            staged[n_pad] = [torch.from_numpy(np.ascontiguousarray(
                a[:, :n_pad])).to(pipe.device) for a in host]
        args = staged[n_pad]
        try:
            t0 = time.perf_counter()
            pipe.window_sums(*args)
            warm_s = time.perf_counter() - t0
            times = []
            for _ in range(runs):
                t0 = time.perf_counter()
                pipe.window_sums(*args)
                times.append((time.perf_counter() - t0) * 1e3)
        except (ValueError, torch.cuda.OutOfMemoryError) as e:
            if isinstance(e, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()
            print(f"[autotune] s={cfg.window_size} C={cfg.columns} "
                  f"T={cfg.pbpr_threads} Wg={cfg.subtask_group}: skipped, "
                  f"{type(e).__name__}: {e}", flush=True)
            continue
        ms = statistics.median(times)
        results.append((cfg, ms))
        if verbose:
            print(f"[autotune] s={cfg.window_size} C={cfg.columns} "
                  f"T={cfg.pbpr_threads} Wg={cfg.subtask_group}: "
                  f"{ms:.2f} ms (warm-up {warm_s:.2f} s)", flush=True)
    if not results:
        raise RuntimeError("autotune: no candidate config succeeded")
    best, best_ms = min(results, key=lambda r: r[1])
    cache = _load_cache()
    cache[_cache_key(cache_kind(device), curve, n)] = {
        k: getattr(best, k) for k in _TUNED_FIELDS} | {"ms": round(best_ms, 2)}
    _save_cache(cache)
    return best, results

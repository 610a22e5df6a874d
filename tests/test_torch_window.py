"""The port's window-size cost model and autotune cache
(`tpu_msm_torch/utils/window.py`) against the JAX package's
(`tpu_msm/utils/window.py`), and its sweep and cache on the CPU."""

import json

import pytest
import torch

from tpu_msm import constants as jc
from tpu_msm.utils import window as jwindow
from tpu_msm_torch.config import MSMConfig, default_config, static_config
from tpu_msm_torch.constants import (BLS12_377_S12, BLS12_377_S13, BN254_S12,
                                     BN254_S13, TINY62)
from tpu_msm_torch.cuzk import kernels
from tpu_msm_torch.utils import window

PROFILES = (BN254_S12, BN254_S13, BLS12_377_S12, BLS12_377_S13)
SIZES = [1 << lg for lg in range(8, 25)]
H100 = "NVIDIA H100 80GB HBM3"


def fields(cfg):
    return tuple(getattr(cfg, k) for k in window._TUNED_FIELDS)


@pytest.mark.parametrize("curve", PROFILES, ids=lambda c: c.name)
def test_cost_model_equals_jax(curve):
    jcurve = jc.CURVES[curve.name]
    for n in SIZES:
        for s in range(2, 17):
            assert window.predict_cost(n, s, curve) == \
                jwindow.predict_cost(n, s, jcurve)
        assert window.optimal_window_size(n, curve) == \
            jwindow.optimal_window_size(n, jcurve)
        got = [fields(c) for c in window.candidate_configs(n, curve)]
        want = [fields(c) for c in jwindow.candidate_configs(n, jcurve)]
        assert got == want, n


def test_candidate_counts_at_the_sweep_sizes():
    c16 = window.candidate_configs(1 << 16)
    c20 = window.candidate_configs(1 << 20)
    assert len(c16) == 36 and len(c20) == 24
    assert {c.window_size for c in c16} == {12, 13, 14}
    assert {c.window_size for c in c20} == {15, 16}
    assert max(c.columns for c in c16 + c20) <= 1024


# JAX's four properties (tests/test_window.py) on the port


def test_predicted_optimum_grows_with_n():
    opts = [window.optimal_window_size(1 << lg) for lg in (10, 14, 18, 22, 26)]
    assert opts == sorted(opts)
    assert 4 <= opts[0] <= opts[-1] <= 16


def test_cost_model_matches_pippenger_shape():
    n = 1 << 20
    best = window.optimal_window_size(n)
    assert window.predict_cost(n, best) < window.predict_cost(n, 4)
    assert window.predict_cost(n, best) <= window.predict_cost(n, 16)


def test_candidate_configs_valid():
    for cfg in window.candidate_configs(1 << 16):
        assert isinstance(cfg, MSMConfig)
        assert cfg.columns <= (1 << 16)


def test_default_config_schedule_monotone_windows(tmp_path, monkeypatch):
    monkeypatch.setenv(window.CACHE_ENV, str(tmp_path / "none.json"))
    sizes = [1 << 9, 1 << 12, 1 << 16, 1 << 20, 1 << 24]
    ws = [default_config(n).window_size for n in sizes]
    assert ws == sorted(ws)


# the cache


def test_cache_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "cache.json"
    monkeypatch.setenv(window.CACHE_ENV, str(path))
    assert window.cache_path() == str(path)
    n = 1 << 16
    fast = MSMConfig(curve=BN254_S12, window_size=12, columns=512,
                     pbpr_threads=512, subtask_group=2)
    slow = MSMConfig(curve=BN254_S12, window_size=14, columns=128,
                     pbpr_threads=512, subtask_group=1)
    window.record_measured(n, BN254_S12, fast, 5.0, "a", device_kind=H100)
    key = f"{H100.replace(' ', '_')}/bn254_s12/{n}"
    rec = json.loads(path.read_text())[key]
    assert rec["ms"] == 5.0 and rec["source"] == "a"
    # best-measured: a slower measurement does not replace it ...
    window.record_measured(n, BN254_S12, slow, 6.0, "b", device_kind=H100)
    assert json.loads(path.read_text())[key]["source"] == "a"
    # ... unless forced
    window.record_measured(n, BN254_S12, slow, 6.0, "c", device_kind=H100,
                           force=True)
    assert json.loads(path.read_text())[key]["window_size"] == 14
    window.record_measured(n, BN254_S12, fast, 4.0, "d", device_kind=H100)
    assert json.loads(path.read_text())[key]["source"] == "d"

    # read back on a (monkeypatched) card of that name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    assert window.cached_config(n, BN254_S12) == fast
    assert default_config(n, BN254_S12) == fast
    assert default_config(n, BLS12_377_S12) == static_config(n, BLS12_377_S12)
    assert default_config(n + 1, BN254_S12) == static_config(n + 1)
    # another card's name has no entry
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "A100")
    assert default_config(n, BN254_S12) == static_config(n)
    # no card: the static schedule
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert window.cached_config(n, BN254_S12) is None
    assert default_config(n, BN254_S12) == static_config(n)


def test_cache_missing_or_unreadable_is_empty(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    monkeypatch.setenv(window.CACHE_ENV, str(tmp_path / "missing.json"))
    assert default_config(1 << 16) == static_config(1 << 16)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(window.CACHE_ENV, str(bad))
    assert window._load_cache() == {}
    assert default_config(1 << 16) == static_config(1 << 16)


def test_cache_default_path_in_build_dir(tmp_path, monkeypatch):
    from tpu_msm_torch import _build
    monkeypatch.delenv(window.CACHE_ENV, raising=False)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    assert window.cache_path() == str(tmp_path / "autotune_cache.json")


# the sweep

TINY_CFGS = (
    MSMConfig(curve=TINY62, window_size=8, columns=32, pbpr_threads=16,
              subtask_group=8),
    MSMConfig(curve=TINY62, window_size=6, columns=32, pbpr_threads=16,
              subtask_group=4),
)


def test_autotune_cpu_records_the_winner(tmp_path, monkeypatch, capsys):
    path = tmp_path / "cache.json"
    monkeypatch.setenv(window.CACHE_ENV, str(path))
    best, results = window.autotune(64, TINY62, runs=1, configs=TINY_CFGS,
                                    device="cpu")
    assert [c for c, _ in results] == list(TINY_CFGS)
    assert all(ms > 0 for _, ms in results)
    assert best == min(results, key=lambda r: r[1])[0]
    rec = json.loads(path.read_text())["cpu/tiny62/64"]
    assert fields(best) == tuple(rec[k] for k in window._TUNED_FIELDS)
    assert rec["ms"] == round(min(ms for _, ms in results), 2)
    out = capsys.readouterr().out
    assert out.count("[autotune]") == 2


def test_autotune_skips_only_refusals(tmp_path, monkeypatch, capsys):
    """A candidate that a launcher refuses (ValueError) is skipped and
    printed; a candidate whose launcher fails otherwise ends the sweep,
    and nothing is written."""
    path = tmp_path / "cache.json"
    monkeypatch.setenv(window.CACHE_ENV, str(path))
    real = kernels.col_prefix
    calls = []

    def refuse_wide(coltot, curve):
        calls.append(coltot.shape)
        if coltot.shape[-2] == 8:           # Wg = 8: the first candidate
            raise ValueError("col_prefix: refused for the test")
        return real(coltot, curve)

    monkeypatch.setattr(kernels, "col_prefix", refuse_wide)
    best, results = window.autotune(64, TINY62, runs=1, configs=TINY_CFGS,
                                    device="cpu")
    assert best == TINY_CFGS[1] and len(results) == 1
    out = capsys.readouterr().out
    assert "skipped, ValueError: col_prefix: refused for the test" in out
    assert "cpu/tiny62/64" in json.loads(path.read_text())

    path.unlink()
    seen = []

    def fail(coltot, curve):
        seen.append(coltot.shape)
        raise RuntimeError("col_prefix: CUDA kernel launch failed")

    monkeypatch.setattr(kernels, "col_prefix", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        window.autotune(64, TINY62, runs=1, configs=TINY_CFGS, device="cpu")
    assert len(seen) == 1                   # the second candidate never ran
    assert not path.exists()

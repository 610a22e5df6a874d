"""The harness refuses to run without the cards a cell asks for, and
prints no result then."""

import os
import subprocess
import sys

import pytest

import run
from conftest import ROOT


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bn254.msm_2p20",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_refuses_fewer_cards_than_the_cell_asks(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(["--workload", "bn254.msm_2p18", "--seed", "1",
                     "--seconds", "1", "--trace", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_refuses_an_unknown_cell(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) \
        != 0
    assert capsys.readouterr().out == ""


@pytest.mark.card
def test_refuses_without_the_program(card, tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "bn254.msm_2p18",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""

"""The command refuses to measure without a card, and a checkout that
holds only BENCHMARK.json and the benchmark's folder gives no result."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def _run(cwd, cell="flagship-serve-b4"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    r = _run(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_unknown_cell_gives_no_result():
    r = _run(ROOT, cell="no-such-cell")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    """On a card: a cell's short run prints its result line last."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "flagship-serve-b4", "--seed", "2147483701", "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"

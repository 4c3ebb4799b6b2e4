"""The command's refusals: without a CUDA card it exits non-zero and
prints no result, and so it does in a directory that holds only
BENCHMARK.json and the benchmark's files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CMD = ["benchmark/run.py", "--workload", "rwkv7-1.5b.s1", "--seed",
       "2147483999", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable] + CMD, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""

"""Shared pieces of the benchmark's CPU tests: a cell of BENCHMARK.json
cut to tiny widths (the program's own tests' size), run on the CPU."""

import copy

import pytest
import torch

from benchmark.harness import load_manifest, resolve

TINY = {"hidden_size": 32, "intermediate_size": 128, "head_dim": 16,
        "vocab_size": 64, "decay_low_rank_dim": 8, "a_low_rank_dim": 8,
        "v_low_rank_dim": 8, "gate_low_rank_dim": 16}


def tiny_spec(workload: str) -> dict:
    """The cell's spec with its configuration at tiny widths (N=256), its
    limits and its traffic as they are."""
    spec = copy.deepcopy(resolve(load_manifest(), workload))
    spec["config"].update(TINY)
    spec["config"]["ckks"] = dict(spec["config"]["ckks"], n=256)
    return spec


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")

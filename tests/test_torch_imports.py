"""Importing fhe_spear_tpu_torch and every submodule in a fresh interpreter
leaves `jax` and `fhe_spear_tpu` out of sys.modules, and builds nothing."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fhe_spear_tpu_torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_no_reference():
    names = ["fhe_spear_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(fhe_spear_tpu_torch.__path__,
                                              "fhe_spear_tpu_torch.")]
    for mod in ("core.ntt_cuda", "core.fourstep_cuda",
                "parallel.ntt_fourstep", "models.device_client",
                "bench_common", "ckks.device_encrypt", "ops.packing",
                "ops.retrieval", "apps.demo", "apps.rag",
                "models.fully_encrypted", "bench_retrieval",
                "bench_fully_enc", "ckks.dft", "ops.polyeval",
                "ckks.bootstrap", "apps.access_control", "apps.noise_study",
                "bench_bootstrap", "bench_rag", "fhesim", "fhesim.simulator",
                "fhesim.eval", "fhesim.calibrate", "fhesim.benchmark_speed",
                "apps.data_prep", "models.naive_inference", "utils",
                "utils.serialization", "utils.profiling",
                "parallel.collectives", "parallel.sharded_bsgs",
                "parallel.sharded_server", "parallel.sharded_fully_enc",
                "parallel.limb_sharded", "parallel.block_pipeline",
                "parallel.dryrun"):
        assert "fhe_spear_tpu_torch." + mod in names, mod
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'fhe_spear_tpu' or "
        "m.startswith('fhe_spear_tpu.'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_package_sources_name_no_reference_import():
    pkg = ROOT / "fhe_spear_tpu_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text, path
        assert "from fhe_spear_tpu." not in text, path
        assert "import fhe_spear_tpu\n" not in text, path

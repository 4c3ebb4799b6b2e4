"""What the benchmark imports: nothing of `jax`, `jaxlib`, `flax` or the
JAX package `fhe_spear_tpu` (top-level names compared whole: the port's
name begins with the JAX package's), and the reference nothing of the
program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _modules_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_names_compared_whole():
    assert forbidden_modules(["fhe_spear_tpu_torch.ops.bsgs", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["fhe_spear_tpu.models", "jax.numpy", "flax",
                              "jaxlib.xla"]) == ["fhe_spear_tpu.models",
                                                 "flax", "jax.numpy",
                                                 "jaxlib.xla"]


def test_run_imports_nothing_forbidden():
    """Every module of the harness, the drivers, the readers and the port
    that a run loads, and a whole tiny run on the CPU."""
    code = ("import torch; torch.set_num_threads(1)\n"
            "import benchmark.run, benchmark.control, benchmark.trace\n"
            "from benchmark.harness import load_reader, run_cell, "
            "load_manifest\n"
            "from benchmark.tests.conftest import tiny_spec\n"
            "import time\n"
            "for m in load_manifest()['per_layer'] + "
            "load_manifest()['end_to_end']: load_reader(m['name'])\n"
            "run_cell(tiny_spec('rwkv7-1.5b.s4'), 3, 0.1, True, 'cpu', "
            "time.perf_counter(), log=lambda m: None)\n")
    mods = _modules_after(code)
    assert "fhe_spear_tpu_torch" in mods
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == []


def test_reference_imports_torch_and_numpy_only():
    mods = _modules_after("import benchmark.reference.rwkv7")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & set(FORBIDDEN)
    assert "fhe_spear_tpu_torch" not in tops
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math",
                                           "__future__"), (path, n)

"""The port's bench entries at a tiny size on the CPU: `bench_retrieval`,
`bench_fully_enc` (with and without `BENCH_BOOTSTRAP=1`),
`bench_bootstrap` and `bench_rag`.  Each prints one JSON line with the
keys of the root entry's line of the same name (read from that file's
source), plus the device name and the peak device memory (null on the
CPU) in `detail`; `bench_fully_enc` also names its allocator setting and
reports per-block errors and refresh seconds, `bench_bootstrap` the
identity key and the K1/K2 launches.  Decode is timed by the cells of
`benchmark/`, not by an entry here."""

import ast
import importlib
import json
from pathlib import Path

import pytest
import torch

from fhe_spear_tpu_torch import bench_common, bench_fully_enc, bench_rag

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small-ring torch ops gain nothing from intra-op threads, and under a
    parallel test run the threads of several workers oversubscribe the
    cores (a bootstrapped chain took 179 s with 8 threads, 8.6 s with
    1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_schema(name):
    """Keys of the last dict literal that the root `<name>.py` prints with
    json.dumps (its result line), and of its `detail` dict (None where
    detail is not a dict literal)."""
    tree = ast.parse((ROOT / f"{name}.py").read_text())
    found = None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            line = node.args[0]
            keys = [k.value for k in line.keys]
            detail = line.values[keys.index("detail")]
            if found is None or node.lineno > found[0]:
                found = (node.lineno, set(keys),
                         {k.value for k in detail.keys}
                         if isinstance(detail, ast.Dict) else None)
    assert found is not None, f"no json.dumps({{...}}) in the root {name}.py"
    return found[1:]


def _root_row_keys(name):
    """Keys of the dict literal the root `<name>.py` appends to `rows`."""
    tree = ast.parse((ROOT / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "append" and getattr(node.func.value, "id", None) == "rows"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no rows.append({{...}}) in the root {name}.py")


def test_bench_retrieval_json_line(monkeypatch, capsys):
    for k, v in {"BENCH_N": "256", "BENCH_DIM": "15",
                 "BENCH_SIZES": "100,300"}.items():
        monkeypatch.setenv(k, v)
    importlib.import_module("fhe_spear_tpu_torch.bench_retrieval").main(
        device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    keys, _ = _root_schema("bench_retrieval")
    assert set(line) == keys
    assert set(line["detail"]) == {"rows", "device", "peak_device_memory_gib"}
    assert line["detail"]["device"] == "cpu"
    rows = line["detail"]["rows"]
    assert [r["docs"] for r in rows] == [100, 300]
    for r in rows:
        assert set(r) == _root_row_keys("bench_retrieval")
        assert r["top1_exact"] == 1 and r["corr"] > 0.999


def test_bench_fully_enc_json_line(monkeypatch, tmp_path, capsys):
    for k, v in {"BENCH_D": "16", "BENCH_F": "64", "BENCH_N": "256",
                 "BENCH_BLOCKS": "2", "BENCH_SPECIAL": "3", "BENCH_DNUM": "4",
                 "BENCH_PASSES": "2",
                 "PYTORCH_CUDA_ALLOC_CONF": ""}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench_fully_enc, "CACHE_ROOT", tmp_path)
    bench_fully_enc.main(device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    keys, detail = _root_schema("bench_fully_enc")
    assert set(line) == keys
    assert set(line["detail"]) == detail | FE_EXTRA
    assert line["detail"]["allocator"] == "default"
    assert line["detail"]["blocks"] == 2
    assert line["detail"]["final_level"] == 2       # L = 3*2 + 2 = 8
    assert line["detail"]["min_corr"] > 0.99999
    assert line["detail"]["bootstraps"] == 0
    assert line["detail"]["refresh_s_steady"] is None
    assert "(no bootstrap)" in line["metric"]
    assert line["value"] > 0
    assert any(p.name.startswith("fe_preenc_16_64_2_256_q")
               for p in tmp_path.iterdir())


FE_EXTRA = {"device", "allocator", "peak_device_memory_gib", "per_block_corr",
            "per_block_max_err", "refresh_s_steady"}


def test_bench_fully_enc_bootstrap_json_line(monkeypatch, tmp_path, capsys):
    """BENCH_BOOTSTRAP=1 with FHE_WARM_FREE=1: the refreshed chain, the
    warm-up refresh and the raw keys dropped before the passes."""
    for k, v in {"BENCH_D": "16", "BENCH_F": "32", "BENCH_N": "128",
                 "BENCH_BLOCKS": "9", "BENCH_LIMBS": "26",
                 "BENCH_SPECIAL": "2", "BENCH_BOOTSTRAP": "1",
                 "BENCH_WIDTH": "1", "BENCH_EXP_DEGREE": "23",
                 "BENCH_BOOT_LEVEL": "8", "FHE_WARM_FREE": "1",
                 "BENCH_PASSES": "2", "PYTORCH_CUDA_ALLOC_CONF": ""}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench_fully_enc, "CACHE_ROOT", tmp_path)
    bench_fully_enc.main(device="cpu")
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys, detail = _root_schema("bench_fully_enc")
    assert set(line) == keys
    assert set(line["detail"]) == detail | FE_EXTRA
    det = line["detail"]
    assert det["blocks"] == 9 and det["bootstraps"] >= 1
    assert f"({det['bootstraps']} bootstraps)" in line["metric"]
    assert det["refresh_s_steady"] > 0
    assert err.count("bootstrap before block") == 2 * det["bootstraps"]
    assert min(det["per_block_corr"]) > 0.98
    assert det["min_corr"] == round(min(det["per_block_corr"]), 8)
    assert "warm-up refresh done" in err


def test_bench_bootstrap_json_line(monkeypatch, capsys):
    for k, v in {"BENCH_N": "256", "BENCH_LIMBS": "24", "BENCH_SPECIAL": "2",
                 "BENCH_RADIX": "3", "BENCH_EXP_DEGREE": "23"}.items():
        monkeypatch.setenv(k, v)
    importlib.import_module("fhe_spear_tpu_torch.bench_bootstrap").main(
        device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    keys, detail = _root_schema("bench_bootstrap")
    assert set(line) == keys
    assert set(line["detail"]) == detail | {
        "device", "peak_device_memory_gib", "identity_key",
        "launches_by_shape"}
    det = line["detail"]
    assert det["identity_key"] is True     # n=256, radix 3: the last S2C group
    assert det["output_level"] >= 3
    assert det["refresh_max_err"] < 0.05 and det["corr"] > 0.999
    assert det["launches_by_shape"] == {"ntt_fwd": {}, "ntt_inv": {}}


def test_bench_rag_json_line(monkeypatch, tmp_path, capsys):
    for k, v in {"RAG_DOCS": "40", "RAG_QUERIES": "2", "BENCH_D": "32",
                 "BENCH_F": "128", "BENCH_N": "256", "BENCH_BLOCKS": "1",
                 "BENCH_TOKENS": "1",
                 "FHE_PREENC_CACHE": str(tmp_path / "preenc")}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench_common, "CACHE_ROOT", tmp_path)
    bench_rag.main(device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    keys, detail = _root_schema("bench_rag")
    assert set(line) == keys
    assert set(line["detail"]) == detail | {"device", "peak_device_memory_gib"}
    assert line["detail"]["rank_agree"] == "2/2"
    assert line["detail"]["tokens_match_plaintext"] is True
    assert line["value"] > 0


@pytest.mark.parametrize("entry", ["bench_retrieval", "bench_fully_enc",
                                   "retriever", "rag", "bench_bootstrap",
                                   "bench_rag", "noise_study",
                                   "fhesim_calibrate", "fhesim_speed",
                                   "naive_ablation"])
def test_new_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from fhe_spear_tpu_torch.apps.demo import FheSpearRetriever
    from fhe_spear_tpu_torch.apps.rag import EncryptedRag

    call = {"bench_retrieval": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.bench_retrieval").main(),
            "bench_fully_enc": bench_fully_enc.main,
            "retriever": FheSpearRetriever,
            "rag": lambda: EncryptedRag(["a passage"]),
            "bench_bootstrap": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.bench_bootstrap").main(),
            "bench_rag": bench_rag.main,
            "noise_study": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.apps.noise_study").main(),
            "fhesim_calibrate": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.fhesim.calibrate").main(n=256),
            "fhesim_speed": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.fhesim.benchmark_speed").run(
                ns=(256,), n_docs=8, verbose=False),
            "naive_ablation": lambda: importlib.import_module(
                "fhe_spear_tpu_torch.models.naive_inference").naive_ablation(
                d=16, f=64, n=256)}[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()

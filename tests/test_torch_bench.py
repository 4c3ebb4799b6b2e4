"""The port's bench entries at a tiny size on the CPU: `bench` in both
transports and `bench_streams` on the device client.  Each prints one JSON
line with the keys of the root entry's line of the same name (read from
that file's source), plus the device name in `detail`."""

import ast
import importlib
import json
from pathlib import Path

import pytest

from fhe_spear_tpu_torch import bench

ROOT = Path(__file__).resolve().parents[1]


def _root_schema(name):
    """Keys of the dict literal that the root `<name>.py` prints with
    json.dumps, and of its `detail` dict."""
    tree = ast.parse((ROOT / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            line = node.args[0]
            keys = [k.value for k in line.keys]
            detail = line.values[keys.index("detail")]
            return set(keys), {k.value for k in detail.keys}
    raise AssertionError(f"no json.dumps({{...}}) in the root {name}.py")


@pytest.mark.parametrize("name,mode", [("bench", "device"),
                                       ("bench", "classic"),
                                       ("bench_streams", "device")])
def test_bench_json_line(name, mode, monkeypatch, tmp_path, capsys):
    for k, v in {"BENCH_D": "32", "BENCH_F": "128", "BENCH_N": "256",
                 "BENCH_BLOCKS": "1", "BENCH_TOKENS": "1", "BENCH_MODE": mode,
                 "BENCH_STREAMS": "2",
                 "FHE_PREENC_CACHE": str(tmp_path / "preenc"),
                 "FHE_STAGE_MODE": "expanded"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "CACHE_ROOT", tmp_path)
    importlib.import_module(f"fhe_spear_tpu_torch.{name}").main(device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    keys, detail = _root_schema(name)
    assert set(line) == keys
    assert set(line["detail"]) == detail | {"device"}
    assert line["detail"]["device"] == "cpu"
    assert line["value"] > 0
    if name == "bench":
        assert line["detail"]["tokens_match_plaintext"] is True
        assert line["detail"]["transport"] == (
            "device-client" if mode == "device" else "fused")
    else:
        assert line["detail"]["all_streams_match_plaintext"] is True

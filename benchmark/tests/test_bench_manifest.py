"""BENCHMARK.json against the benchmark's contract, on the CPU: every
part of every cell is found by name, names and units use the allowed
characters, and every per-layer metric's `moves` is reported wherever the
metric is."""

import json
import re
from pathlib import Path

from benchmark.harness import load_driver, load_manifest, resolve

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = load_manifest()


def test_top_level_keys_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(M["command"]) <= 32
    for word in M["command"]:
        assert LINE.match(word) and not word.startswith("/")
        if (ROOT / word).is_file():
            assert any(word.startswith(p + "/") for p in M["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    names = []
    for section, allowed in keys.items():
        assert 1 <= len(M[section])
        for e in M[section]:
            assert set(e) - {"workloads"} == allowed, (section, e)
            assert NAME.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in e and section != "end_to_end":
                    assert LINE.match(str(e[k])), e[k]
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    for section in ("configs", "workloads"):
        ns = [e["name"] for e in M[section]]
        assert len(ns) == len(set(ns))


def test_configs_found_and_reduced_keys_named():
    paths = M["paths"]
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in paths)
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not re.search(r"(_dim|_rank|size|heads?)$", k), k


def test_limits_name_numbers_of_each_cells_driver():
    """A configuration limits some of the numbers that the driver of each
    of its cells' traffic returns, and only those."""
    for w in M["workloads"]:
        spec = resolve(M, w["name"])
        limits = spec["config"]["limits"]
        numbers = load_driver(spec["traffic"]["kind"]).NUMBERS
        assert limits and set(limits) <= set(numbers), (w["name"], limits)
        assert all(isinstance(v, float) for v in limits.values())


def test_cells_found_by_name():
    pairs = set()
    four = 0
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        spec = resolve(M, w["name"])
        kind = spec["traffic"]["kind"]
        assert (ROOT / "benchmark" / "drivers" / f"{kind}.py").is_file()
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
                    ).is_file()
    assert four <= max(1, len(M["workloads"]) // 4)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in M["workloads"]:
        spec = resolve(M, w["name"])
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["per_layer"]:
            assert m["moves"] in names, (w["name"], m["name"])


def test_layers_named_alike():
    assert 1 <= len(M["per_layer"]) <= 128
    for m in M["per_layer"]:
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"

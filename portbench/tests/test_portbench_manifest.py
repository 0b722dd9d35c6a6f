"""`BENCHMARK.json` keeps to its contract, and every cell, configuration,
traffic mix, entry and per-layer metric resolves to its files by name."""
import json
import math

import pytest

from harness import manifest

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def test_top_level_keys(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    run = bench["run_seconds"]
    assert isinstance(run, int) and 1 <= run <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (run + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys(bench, section):
    for entry in bench[section]:
        extra = set(entry) - KEYS[section] - {"workloads"}
        assert set(entry) >= KEYS[section] and not extra, entry
        if section in ("configs", "workloads"):
            assert "workloads" not in entry


def test_names_and_units(bench):
    names = []
    for section in KEYS:
        for entry in bench[section]:
            assert manifest.NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert manifest.UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert manifest.NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])


def test_every_cell_resolves(bench):
    metric_names = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = manifest.resolve(bench, w["name"])
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        assert (manifest.BENCH_DIR / "entries"
                / f"{cell.workload['entry']}.py").is_file()
        for m in cell.per_layer:
            assert m["moves"] in reported and m["moves"] in metric_names
            family = m["name"].partition(".")[0]
            assert callable(manifest.load_module("metrics", family).read)
        assert set(cell.workload["limits"]) and all(
            math.isfinite(v) and v > 0 for v in cell.workload["limits"].values())


def test_configuration_files(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_per_layer_metrics(bench):
    layers = {}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
        layers.setdefault(m["name"].partition(".")[0], set()).add(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert all(len(v) == 1 for k, v in layers.items() if k != "mfu")

"""`BENCHMARK.json` and the files it names, found by name.

A cell `<name>` of `workloads` reads `portbench/workloads/<name>.json`
(its entry, traced items and correctness limits), its configuration's
`file`, and `portbench/traffic/<traffic>.json`; its entry is
`portbench/entries/<entry>.py` and each per-layer metric `<family>.<suffix>`
is read by `portbench/metrics/<family>.py`. Adding a cell, a configuration,
a traffic mix or a metric adds files and entries; nothing here changes.
"""
import dataclasses
import importlib.util
import json
import re
import typing as tp
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict          # the `workloads` entry of BENCHMARK.json
    workload: dict      # portbench/workloads/<name>.json
    config: dict        # the configuration's file
    traffic: dict       # portbench/traffic/<traffic>.json
    end_to_end: tp.List[dict]
    per_layer: tp.List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its files and the metrics it reports."""
    specs = {w["name"]: w for w in manifest["workloads"]}
    if name not in specs:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    spec = specs[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[spec["config"]]["file"]).read_text())
    bench = root / "portbench"
    workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{spec['traffic']}.json"
                          ).read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in names)]
    return Cell(name, spec, workload, config, traffic, e2e, per_layer)


def load_module(kind: str, name: str, bench: Path = BENCH_DIR):
    """`portbench/<kind>/<name>.py` as a module."""
    path = bench / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

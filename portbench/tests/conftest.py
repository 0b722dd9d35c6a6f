"""Shared set-up of the benchmark's own tests: the harness on the path,
and the debug cells under `data/` (tiny widths, run on the CPU)."""
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))
DATA = Path(__file__).resolve().parent / "data"

E2E = {"generate": ["setup_s", "gen_audio_s_per_s"],
       "train_step": ["setup_s", "train_audio_s_per_s", "train_step_p90_s"]}


def _load(path: str) -> dict:
    return json.loads((DATA / path).read_text())


@pytest.fixture
def debug_cell():
    """debug_cell(kind, dtype, limits=None): the debug cell of `kind`
    ('gen' or 'train') with the program in `dtype`."""
    import run
    from harness.manifest import Cell
    run._environment()

    def make(kind: str, dtype: str = "float32", limits=None):
        cfg = _load("configs/debug.json")
        cfg["serve_dtype"] = dtype
        cfg["train"]["overrides"]["transformer_lm.dtype"] = dtype
        workload = _load(f"workloads/debug.{kind}.json")
        if dtype != "float32":
            workload["limits"] = workload["limits_" + dtype]
        if limits is not None:
            workload["limits"] = limits
        traffic = _load(f"traffic/debug_{kind}.json")
        e2e = [{"name": n, "unit": "s"} for n in E2E[workload["entry"]]]
        return Cell(f"debug.{kind}", {"chips": 1}, workload, cfg, traffic,
                    e2e, [])
    return make

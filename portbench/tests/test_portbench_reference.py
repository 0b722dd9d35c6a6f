"""The plain reference agrees with the port at the debug sizes on the CPU
(program in float32), and the float8 control put in the program's place
comes out not correct where the program in bfloat16 is correct."""
import pytest
import torch

import run
from harness import manifest

SEED = 2 ** 33 + 5


def _run(cell, count=4):
    return run.run_cell(cell, SEED, 0, False, torch.device("cpu"), torch,
                        count=count)


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_reference_agrees_with_port(debug_cell, kind):
    out = _run(debug_cell(kind))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 4
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_bfloat16_program_is_correct(debug_cell, kind):
    out = _run(debug_cell(kind, "bfloat16"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_control_is_not_correct(debug_cell, kind):
    """The control's readings against the bfloat16 limits, on three
    seeds: each fails at least one number."""
    cell = debug_cell(kind, "bfloat16")
    ctx = run.Context(cell, 11, torch.device("cpu"), False, torch)
    entry = manifest.load_module("entries", cell.workload["entry"])
    state = entry.setup(ctx)
    limits = cell.workload["limits"]
    for seed in (11, 12, 13):
        ctx.seed = seed
        got = entry.calibration_readings(state, ctx, True)
        assert all(got[k] <= v for k, v in limits.items()), (seed, got)
        assert any(got[f"{k}.control"] > v for k, v in limits.items()), (seed, got)


@pytest.mark.parametrize("kind", ["gen", "train"])
def test_traced_run(debug_cell, kind):
    """A `--trace 1` run drives the profiler passes and the per-layer
    readers; on the CPU only the readers that need no card report."""
    import json
    cell = debug_cell(kind)
    bench = manifest.load_manifest()
    cell.per_layer = [m for m in bench["per_layer"]
                      if m["name"].partition(".")[0] in ("mfu", "decode_ms_per_step")]
    out = run.run_cell(cell, SEED, 0, True, torch.device("cpu"), torch,
                       count=2)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 2 + 2 * cell.workload["traced_items"]
    assert "mfu" in json.dumps(out["metrics"])
    assert out["device"]["window_s"] > 0
    assert len(out["breakdown"]["device_ops"]) <= 10
    assert len(out["breakdown"]["idle_gaps"]) <= 10

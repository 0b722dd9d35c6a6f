"""On the card: a run of each debug cell through the kernels (K1 in the
decode graph, K2 in the training step) is correct against the reference,
and the float8 control fails. Skips without a CUDA card."""
import pytest
import torch

import run
from harness import manifest


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gen", "train"])
def test_debug_cell_on_card(debug_cell, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = debug_cell(kind, "bfloat16")
    out = run.run_cell(cell, 2 ** 35 + 3, 0, False, torch.device("cuda", 0),
                       torch, count=4)
    assert out["correct"], out["checks"]
    ctx = run.Context(cell, 21, torch.device("cuda", 0), False, torch)
    entry = manifest.load_module("entries", cell.workload["entry"])
    state = entry.setup(ctx)
    got = entry.calibration_readings(state, ctx, True)
    limits = cell.workload["limits"]
    assert any(got[f"{k}.control"] > v for k, v in limits.items()), got

"""`host_step_ms.<suffix>`: host milliseconds per training step of
`MusicGenSolver.run_step` (the program's root span `solver.step`): the
time the host takes to enqueue a step, with no synchronise inside it, over
the first traced pass (`harness/spans.py`). Moves
`train_audio_s_per_s`."""
from harness import spans


def _host_ms(root):
    return root.host_ms if root.name == "solver.step" else None


def read(view, suffix):
    return spans.per_item(view, _host_ms)

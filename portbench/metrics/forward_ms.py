"""`forward_ms.<suffix>`: device milliseconds per training step of the
autocast forward (conditions, the LM's predictions and the cross-entropy:
`solvers/musicgen.py::train_step`), from the CUDA events of the program's
span `solver.forward`, over the first traced pass (`harness/spans.py`).
Moves `train_audio_s_per_s`."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(["solver.forward"],
                                                "device_ms"))

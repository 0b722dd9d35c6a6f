"""`backward_ms.<suffix>`: device milliseconds per training step of
`zero_grad` and the backward pass (`solvers/musicgen.py::train_step`),
from the CUDA events of the program's span `solver.backward`, over the
first traced pass (`harness/spans.py`). Moves `train_audio_s_per_s`."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(["solver.backward"],
                                                "device_ms"))

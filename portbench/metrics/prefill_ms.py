"""`prefill_ms.<suffix>`: device milliseconds of the LM's prefill per
request (the first forward and sample of `models/lm.py::generate`), from
the CUDA events of the program's span `lm.prefill`, over the first traced
pass (`harness/spans.py`). Moves the cell's serving metric."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(["lm.prefill"], "device_ms"))

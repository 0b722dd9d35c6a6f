"""`conditioning_ms.<suffix>`: device milliseconds of conditioning per
request (tokenize, T5 and the fuser, the KV caches' set-up and the text's
cross-attention keys and values: `models/lm.py::generate`), from the CUDA
events of the program's span `lm.conditions`, over the first traced pass
(`harness/spans.py`). Moves the cell's serving metric."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(["lm.conditions"],
                                                "device_ms"))

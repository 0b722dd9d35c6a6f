"""`capture_ms.<suffix>`: host milliseconds per request in which the card
has nothing queued before the decode graph's first replay
(`models/lm.py::_replay_decode_steps`): the program's spans
`lm.graph.release` (the `empty_cache` before capture) and
`lm.graph.capture` (the capture of one decode step), over the first traced
pass (`harness/spans.py`). Moves the cell's serving metric."""
from harness import spans


def read(view, suffix):
    return spans.per_item(view, spans.spans_sum(
        ["lm.graph.release", "lm.graph.capture"], "host_ms"))

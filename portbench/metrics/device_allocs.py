"""`device_allocs.<suffix>`: the caching allocator's calls of cudaMalloc
and cudaFree per request or step (`num_device_alloc` + `num_device_free`
of `torch.cuda.memory_stats`, counted over each root span of the program,
`generate` or `solver.step`), over the first traced pass
(`harness/spans.py`). Moves the cell's end-to-end rate or time."""
from harness import spans


def _calls(root):
    c = root.counters
    if "num_device_alloc" not in c or "num_device_free" not in c:
        return None
    return c["num_device_alloc"] + c["num_device_free"]


def read(view, suffix):
    return spans.per_item(view, _calls)

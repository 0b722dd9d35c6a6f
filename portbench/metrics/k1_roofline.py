"""`k1_roofline.<suffix>`: K1's (`csrc/decode_attention.cu`) share of its
roofline over the traced requests, in %: the sum over its calls of the
least time each could take (bytes at the call's valid length over HBM's
3.35 TB/s, or its f32 operations over 67 TFLOP/s, whichever is longer;
`harness/counts.py`) over the kernels' device time in the trace. The
calls are the self-attention of every layer at every forward of every
traced request, at lengths 1 .. forwards; their count is checked against
the trace's kernels and `decode_attention.launches`. Nothing is returned
where the trace does not show every call. Moves the cell's serving
metric."""
from harness import counts

KERNEL = r"decode_attn_kernel"


def read(view, suffix):
    s, trace = view.state, view.trace
    if trace is None or not hasattr(s, "traced_launches"):
        return None
    lm = view.cell.config["transformer_lm"]
    L, H, D = lm["num_layers"], lm["num_heads"], lm["dim"] // lm["num_heads"]
    calls = trace.kernels(KERNEL)
    expected = 0
    bound = 0.0
    for i, _, _ in view.traced_items.items:
        rows = 2 * len(s.traffic.request(i).texts)
        expected += L * s.forwards
        bound += L * sum(counts.k1_bound_s(rows, H, D, n)
                         for n in range(1, s.forwards + 1))
    if not calls or len(calls) != expected or s.traced_launches != expected:
        return None
    device_s = sum(c.end - c.start for c in calls) / 1e9
    return 100.0 * bound / device_s

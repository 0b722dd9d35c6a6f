"""`cross_attn_ms.<suffix>`: device milliseconds per traced request of the
cross-attention step kernel K4 (`csrc/cross_attention_step.cu`), from the
trace. Its calls are the cross-attention of every layer at every forward
of the request (the prefill over the first pattern step is a single step
too); nothing is returned unless the trace shows exactly layers x forwards
calls per traced request, so a program without K4 reads nothing. Moves
the cell's serving metric."""
KERNEL = r"cross_attn_step_kernel"


def read(view, suffix):
    s, trace = view.state, view.trace
    items = len(view.traced_items.items) if view.traced_items else 0
    if trace is None or not items or not hasattr(s, "forwards"):
        return None
    layers = view.cell.config["transformer_lm"]["num_layers"]
    calls = trace.kernels(KERNEL)
    if not calls or len(calls) != items * layers * s.forwards:
        return None
    return sum(c.end - c.start for c in calls) / 1e6 / items

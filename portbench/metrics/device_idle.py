"""`device_idle.<suffix>`: the share of the traced window (whole requests
or steps under `torch.profiler`) in which nothing ran on the card, in %:
one minus the union of the device operations' intervals over the
window's length. Moves the cell's end-to-end metric."""


def read(view, suffix):
    trace = view.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

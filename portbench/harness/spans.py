"""The program's own spans (`audiocraft_tpu_torch.utils.tracing`) for the
per-layer metrics that read them.

Spans are on while `torch.profiler` records, so the traced passes record a
root span for each item (`generate` a request, `solver.step` a step), and
the timed window, which runs with no profiler, records none. The roots of
the first traced pass, the card's activity alone, are therefore the first
`len(view.traced_items.items)` roots the process recorded. A reading is
the mean over those items; it is None on a CPU, where the program has no
spans (`utils.tracing` missing), or where an item lacks what is read.
"""
import typing as tp


def first_pass_roots(view) -> tp.Optional[list]:
    import torch
    if view.trace is None or not torch.cuda.is_available():
        return None
    try:
        from audiocraft_tpu_torch.utils import tracing
    except ImportError:
        return None
    n = len(view.traced_items.items)
    roots = tracing.roots()[:n]
    return roots if n and len(roots) == n else None


def named(span, names: tp.Sequence[str]) -> list:
    """`span`'s descendants named one of `names`, depth first."""
    out = []
    for child in span.children:
        if child.name in names:
            out.append(child)
        out.extend(named(child, names))
    return out


def per_item(view, read: tp.Callable) -> tp.Optional[float]:
    """The mean over the first pass's roots of `read(root)`; None where
    any root reads None."""
    roots = first_pass_roots(view)
    if not roots:
        return None
    values = [read(root) for root in roots]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def spans_sum(names: tp.Sequence[str], value: str) -> tp.Callable:
    """A `read` for `per_item`: the sum of `value` ('host_ms' or
    'device_ms') over a root's spans named one of `names`; None where it
    has none of them or one lacks the value."""
    def read(root):
        spans = named(root, names)
        values = [getattr(s, value) for s in spans]
        if not values or any(v is None for v in values):
            return None
        return sum(values)
    return read

"""`cross_attn_ms`: on a fake run view it sums the device time of the
cross-attention step kernel per traced request, and reads nothing unless
the trace holds exactly layers x forwards of its calls per request (a
program without the kernel, a missing call, no trace)."""
import types

from harness import manifest, trace as trace_mod

LAYERS, FORWARDS, ITEMS = 3, 5, 2
NAME = ("void (anonymous namespace)::cross_attn_step_kernel<__nv_bfloat16, "
        "__nv_bfloat16, 16>(__nv_bfloat16 const*, ...)")


def _view(calls, traced=True, items=ITEMS):
    device = [trace_mod.Span(NAME, 1000 * i, 1000 * i + 250)
              for i in range(calls)]
    device.append(trace_mod.Span("void decode_attn_kernel<...>", 0, 900))
    trace = (trace_mod.Trace(device, [], (0, 1000 * max(calls, 1)))
             if traced else None)
    cell = types.SimpleNamespace(
        config={"transformer_lm": {"num_layers": LAYERS}})
    return types.SimpleNamespace(
        state=types.SimpleNamespace(forwards=FORWARDS), trace=trace,
        cell=cell,
        traced_items=types.SimpleNamespace(items=[None] * items))


def _read(view):
    return manifest.load_module("metrics", "cross_attn_ms").read(view, "gen")


def test_reads_device_ms_per_traced_request():
    calls = ITEMS * LAYERS * FORWARDS
    assert _read(_view(calls)) == calls * 250 / 1e6 / ITEMS


def test_reads_nothing_without_every_call():
    for calls in (0, ITEMS * LAYERS * FORWARDS - 1,
                  ITEMS * LAYERS * FORWARDS + 1):
        assert _read(_view(calls)) is None
    assert _read(_view(ITEMS * LAYERS * FORWARDS, traced=False)) is None
    assert _read(_view(0, items=0)) is None

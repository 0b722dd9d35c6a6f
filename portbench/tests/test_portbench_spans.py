"""The per-layer metrics that read the program's spans: on a fake run view
and fake roots each reads the roots of the first traced pass (the first
`len(traced_items)` recorded) and averages them per item, and reads
nothing on a CPU, without a trace, or where a root lacks its span. The
program's spans nested in a traced item leave the trace's window and
busy time as they were, so `device_idle` and `window_s` do not move
because of them."""
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from audiocraft_tpu_torch.utils import tracing
from harness import manifest, trace as trace_mod

N = 2  # items per traced pass


class FakeSpan:
    def __init__(self, name, host_ms=None, device_ms=None, children=(),
                 counters=None):
        self.name, self.host_ms, self.device_ms = name, host_ms, device_ms
        self.children, self.counters = list(children), counters or {}


def _generate_root(k):
    """A request's tree; its numbers grow with k."""
    decode = FakeSpan("lm.decode", 3000.0 + k, None, [
        FakeSpan("lm.warmup_step", 7.0),
        FakeSpan("lm.graph.sync", 20.0 + k),
        FakeSpan("lm.graph.release", 60.0 + k),
        FakeSpan("lm.graph.capture", 70.0 + k),
        FakeSpan("lm.replays", 1.0, 3400.0 + k)])
    return FakeSpan("generate", 3900.0 + k, None, [
        FakeSpan("lm.conditions", 12.0, 10.0 + k),
        FakeSpan("lm.prefill", 5.0, 4.0 + k),
        decode,
        FakeSpan("codec.decode", 150.0, 140.0 + k)],
        {"num_device_alloc": 30 + k, "num_device_free": 20 + k})


def _step_root(k):
    return FakeSpan("solver.step", 40.0 + k, None, [
        FakeSpan("solver.batch", 0.1),
        FakeSpan("solver.forward", 9.0, 70.0 + k),
        FakeSpan("solver.backward", 20.0, 120.0 + k),
        FakeSpan("solver.optimizer", 8.0, 20.0 + k)],
        {"num_device_alloc": k, "num_device_free": 0})


# family -> (roots of item k, the first pass's mean over k = 0, 1)
EXPECTED = {
    "conditioning_ms": (_generate_root, 10.5),
    "prefill_ms": (_generate_root, 4.5),
    "capture_ms": (_generate_root, 131.0),
    "codec_device_ms": (_generate_root, 140.5),
    "device_allocs": (_generate_root, 51.0),
    "forward_ms": (_step_root, 70.5),
    "backward_ms": (_step_root, 120.5),
    "optimizer_ms": (_step_root, 20.5),
    "host_step_ms": (_step_root, 40.5),
}


def _view(trace=object()):
    items = types.SimpleNamespace(items=[(i, 1.0, 1.0) for i in range(N)])
    return types.SimpleNamespace(trace=trace, traced_items=items)


@pytest.fixture
def fake_roots(monkeypatch):
    """roots(make): the first pass's N roots, then the second pass's (ten
    times larger numbers), as `tracing.roots()` returns them."""
    def set_roots(make):
        roots = [make(k) for k in range(N)] + [make(10 * k + 100)
                                               for k in range(N)]
        monkeypatch.setattr(tracing, "roots", lambda: roots)
        return roots
    return set_roots


def test_every_new_metric_is_in_the_manifest():
    bench = manifest.load_manifest()
    families = {m["name"].partition(".")[0]: m for m in bench["per_layer"]}
    assert set(EXPECTED) <= set(families)
    for family in EXPECTED:
        assert families[family]["source"] in ("program_span",
                                              "program_counter")


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_reader_averages_the_first_pass(family, fake_roots, monkeypatch):
    make, want = EXPECTED[family]
    fake_roots(make)
    read = manifest.load_module("metrics", family).read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert read(_view(), "x") == pytest.approx(want)
    assert read(_view(trace=None), "x") is None  # untraced


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_reader_reads_nothing_on_a_cpu(family, fake_roots):
    make, _ = EXPECTED[family]
    fake_roots(make)
    assert not torch.cuda.is_available()
    assert manifest.load_module("metrics", family).read(_view(), "x") is None


@pytest.mark.parametrize("family", sorted(EXPECTED))
def test_reader_reads_nothing_without_its_span(family, monkeypatch):
    """Roots of the other entry, or too few roots: nothing."""
    make, _ = EXPECTED[family]
    other = _step_root if make is _generate_root else _generate_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    read = manifest.load_module("metrics", family).read
    for roots in ([other(k) for k in range(N)], [make(0)]):
        monkeypatch.setattr(tracing, "roots", lambda roots=roots: roots)
        if family == "device_allocs" and len(roots) == N:
            continue  # both roots count the allocator
        assert read(_view(), "x") is None, roots


class FakeEvent:
    def __init__(self, name, start, end, cuda, annotation=False):
        self._args = (name, start, end, cuda, annotation)

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def end_ns(self):
        return self._args[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._args[3]
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._args[4]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


PROGRAM = {"generate", "lm.conditions", "lm.prefill", "lm.decode",
           "codec.decode", "solver.step", "solver.forward"}


def test_device_pass_window_and_busy_time_ignore_program_spans():
    """The card's pass alone: the item's and the program's spans are
    annotations on the card's timeline; the window stays the item's."""
    kernels = [FakeEvent("k", 100 + 50 * i, 130 + 50 * i, True)
               for i in range(10)]
    item = [FakeEvent(trace_mod.ITEM_SPAN, 100, 580, True, True)]
    program = [FakeEvent("generate", 100, 580, True, True),
               FakeEvent("lm.prefill", 100, 180, True, True),
               FakeEvent("codec.decode", 400, 580, True, True)]
    plain = trace_mod.read(_prof(kernels + item), torch)
    nested = trace_mod.read(_prof(kernels + item + program), torch)
    assert nested.window == plain.window == (100, 580)
    assert nested.busy_s == plain.busy_s == 10 * 30 / 1e9
    assert nested.device == plain.device


def test_cpu_profile_window_and_busy_time_ignore_program_spans():
    """Under a CPU profile the program's spans of a tiny generate are host
    events of their own names inside the item's span; leaving them out
    changes neither the window nor the busy time."""
    from audiocraft_tpu_torch.models import MusicGen
    mg = MusicGen.get_pretrained("debug", device="cpu")
    mg.set_generation_params(duration=0.2, use_sampling=False)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace_mod.ITEM_SPAN):
            mg.generate(["calm piano"])
    events = list(prof.profiler.kineto_results.events())
    names = {e.name() for e in events}
    assert {"generate", "lm.conditions", "lm.prefill", "lm.decode",
            "codec.decode"} <= names
    with_spans = trace_mod.read(_prof(events), torch)
    without = trace_mod.read(_prof([e for e in events
                                    if e.name() not in PROGRAM]), torch)
    assert with_spans.window == without.window
    assert with_spans.busy_s == without.busy_s
    (item,) = [e for e in events if e.name() == trace_mod.ITEM_SPAN]
    assert with_spans.window == (item.start_ns(), item.end_ns())
    (root,) = tracing.roots()
    assert item.start_ns() <= root.start_ns <= root.end_ns <= item.end_ns()
    tracing.clear()

"""Spans of the program's phases, on the profiler's clock.

    from audiocraft_tpu_torch.utils import tracing
    with tracing.span("lm.prefill", device=True):
        ...

Spans are on after `enable()` (until `disable()`) and while a
`torch.profiler` records, so a profiled run (the solvers' `Profiler`, a
benchmark's traced pass) sees them with no switch of its own. Off, `span`
returns a shared no-op context after one flag check: it records nothing.

On, a span records its name, attributes, an id, its parent's id (spans nest
per thread) and its root's id, which every span of one request or step
shares; its host start and end in Unix-epoch nanoseconds, the clock of
`torch.profiler`'s events; and a `record_function` of its name, so it shows
on the profiler's timeline and in its Chrome trace. With `device=True` and
CUDA in use it also records a CUDA event on the current stream at each end
(not while that stream is capturing a graph). A root span on CUDA counts
the caching allocator's cudaMalloc and cudaFree calls over its block
(`num_device_alloc`, `num_device_free`). Finished roots are kept, in order,
in a bounded deque that `roots()` reads.
"""
import collections
import itertools
import threading
import time
import typing as tp

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_ROOTS = 1024
ALLOCATOR_COUNTERS = ("num_device_alloc", "num_device_free")

_enabled = False
_roots: tp.Deque["Span"] = collections.deque(maxlen=MAX_ROOTS)
_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def roots() -> tp.List["Span"]:
    """The finished root spans, oldest first (the last `MAX_ROOTS`)."""
    return list(_roots)


def clear() -> None:
    _roots.clear()


def _allocator_counts() -> tp.Dict[str, int]:
    # the nested form of `torch.cuda.memory_stats()`: the same counters
    # without flattening every other statistic in Python
    stats = torch.cuda.memory_stats_as_nested_dict()
    return {k: stats.get(k, 0) for k in ALLOCATOR_COUNTERS}


class Span:
    """One phase of a request or step; entered once, as a context."""

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.attrs, self._device = name, attrs, device
        self.id = next(_ids)
        self.parent_id: tp.Optional[int] = None
        self.root_id = self.id
        self.start_ns = self.end_ns = None
        self.children: tp.List[Span] = []
        self.counters: tp.Dict[str, int] = {}
        self._events: tp.Optional[tp.Tuple[torch.cuda.Event,
                                           torch.cuda.Event]] = None
        self._allocs: tp.Optional[tp.Dict[str, int]] = None
        self._record = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent_id, self.root_id = stack[-1].id, stack[-1].root_id
        cuda = torch.cuda.is_initialized()
        if not stack and cuda:
            self._allocs = _allocator_counts()
        self._record = torch.profiler.record_function(self.name)
        self._record.__enter__()
        self.start_ns = time.time_ns()
        if self._device and cuda \
                and not torch.cuda.is_current_stream_capturing():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        stack = _local.stack
        stack.pop()
        if self._events is not None and self._device:
            self._events[1].record()
        if self.end_ns is None:
            self.end_ns = time.time_ns()
        self._record.__exit__(*exc)
        self._record = None
        if self._allocs is not None:
            now = _allocator_counts()
            self.counters.update(
                {k: now[k] - self._allocs[k] for k in ALLOCATOR_COUNTERS})
        if stack:
            stack[-1].children.append(self)
        else:
            _roots.append(self)

    def set_host(self, start_ns: int, end_ns: int) -> None:
        """Take the host times of a block that the caller timed itself, on
        `time.time_ns()`, so that the span and the caller's number are one
        reading."""
        self.start_ns, self.end_ns = start_ns, end_ns

    def set_events(self, start: torch.cuda.Event,
                   end: torch.cuda.Event) -> None:
        """Take a pair of CUDA events that the caller records itself."""
        self._events, self._device = (start, end), False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> tp.Optional[float]:
        """Device ms from the stream's reaching the start event to its
        reaching the end event (waits for the end); None without events."""
        if self._events is None:
            return None
        start, end = self._events
        end.synchronize()
        return start.elapsed_time(end)

    @property
    def self_ms(self) -> float:
        """Host ms less what the children's host intervals cover."""
        covered, cursor = 0, self.start_ns
        for c in sorted(self.children, key=lambda c: c.start_ns):
            a, b = max(c.start_ns, cursor), min(c.end_ns, self.end_ns)
            if b > a:
                covered += b - a
                cursor = b
        return self.host_ms - covered / 1e6


class _Off:
    """The shared span of tracing off: a context that does nothing."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set_host(self, start_ns: int, end_ns: int) -> None:
        pass

    def set_events(self, start, end) -> None:
        pass


_OFF = _Off()


def span(name: str, device: bool = False, **attrs):
    """A span of the block, or the shared no-op context when tracing is
    off. `device=True` adds CUDA events on the current stream."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, device, attrs)

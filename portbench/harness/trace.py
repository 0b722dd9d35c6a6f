"""Reading a `torch.profiler` run: the device's operations and the host's
spans on one timeline, the traced window, the device's busy time (the
union of its operations' intervals), kernel times by name, and the
breakdown of the result line (device operations by group, the longest idle
gaps named by what the host was doing)."""
import dataclasses
import re
import typing as tp

ITEM_SPAN = "portbench.item"

# `scripts/torch_profile_train.py::GROUPS` and `group_of`, copied, with
# the decode-attention kernel's own group
GROUPS = (("decode_attention", ("decode_attn_kernel",)),
          ("flash_attention_forward", ("fwd_kernel",)),
          ("flash_attention_backward", ("dkdv_kernel", "dq_kernel",
                                        "delta_kernel")),
          ("gemm", ("gemm", "nvjet", "sm90_xmma", "cutlass", "cublas")),
          ("optimizer", ("multi_tensor_apply", "foreach")),
          ("dtype_casts_and_copies", ("copy_kernel",)),
          ("layer_norm", ("layer_norm",)))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


@dataclasses.dataclass
class Span:
    name: str
    start: int  # ns, on the profiler's clock
    end: int


@dataclasses.dataclass
class Trace:
    device: tp.List[Span]   # kernels, copies and sets on the card
    host: tp.List[Span]     # host operations and annotations
    window: tp.Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self) -> tp.List[Span]:
        lo, hi = self.window
        return [s for s in self.device if s.end > lo and s.start < hi]

    def busy_intervals(self) -> tp.List[tp.Tuple[int, int]]:
        lo, hi = self.window
        merged: tp.List[tp.List[int]] = []
        for s in sorted(self.in_window(), key=lambda s: s.start):
            a, b = max(s.start, lo), min(s.end, hi)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels(self, pattern: str) -> tp.List[Span]:
        rx = re.compile(pattern)
        return [s for s in self.in_window() if rx.search(s.name)]

    def device_ops(self, top: int = 10) -> tp.List[tp.List]:
        """[name, seconds] of the operations that took most device time:
        by group, and by the kernel's own name where it has no group."""
        totals: tp.Dict[str, float] = {}
        for s in self.in_window():
            group = group_of(s.name)
            key = s.name[:96] if group == "other" else group
            totals[key] = totals.get(key, 0.0) + (s.end - s.start) / 1e9
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def kernel_table(self, top: int = 30) -> tp.List[tp.List]:
        """[name, calls, seconds] of the device operations by name."""
        totals: tp.Dict[str, tp.List] = {}
        for s in self.in_window():
            row = totals.setdefault(s.name[:160], [0, 0.0])
            row[0] += 1
            row[1] += (s.end - s.start) / 1e9
        return [[k, n, t] for k, (n, t) in sorted(
            totals.items(), key=lambda kv: -kv[1][1])[:top]]

    def idle_gaps(self, top: int = 10) -> tp.List[tp.List]:
        """[what the host was doing, seconds] of the longest stretches of
        the window in which nothing ran on the card: the innermost host
        span covering the gap's middle."""
        lo, hi = self.window
        gaps, cursor = [], lo
        for a, b in self.busy_intervals():
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            gaps.append((cursor, hi))
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (a + b) // 2
            covering = [s for s in self.host if s.start <= mid <= s.end]
            name = (max(covering, key=lambda s: s.start).name
                    if covering else "no host span")
            out.append([name[:96], (b - a) / 1e9])
        return out


def read(prof, torch) -> Trace:
    """The profiler's events. The window runs from the first item span's
    start to the last one's end: the host's spans where the host was
    traced, else their ranges on the card's timeline, else the card's
    first and last operation."""
    device, host, items, marks = [], [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        span = Span(e.name(), e.start_ns(), e.end_ns())
        if e.device_type() != cuda:
            host.append(span)
            if span.name == ITEM_SPAN:
                items.append(span)
        elif e.is_user_annotation() or span.name == ITEM_SPAN:
            marks.append(span)
        else:
            device.append(span)
    bounds = items or marks or device
    if not bounds:
        raise RuntimeError("the trace holds no item span and no device "
                           "operation")
    return Trace(device, host, (min(s.start for s in bounds),
                                max(s.end for s in bounds)))

#!/usr/bin/env python3
"""Where a benchmark cell's device idle time falls among the program's
spans (`audiocraft_tpu_torch.utils.tracing`), and what the spans cost.

    python3 scripts/torch_span_breakdown.py --workload <cell> --seed <n>
        [--pairs 5] [--out build/span_breakdown.<cell>.json]

Sets the cell up as `portbench/run.py` does (its entry's `setup`: weights
from the seed, warm-up), then:

1. Cost: `--pairs` pairs of whole items (requests or steps), each item
   once with `tracing.enable()` and once without, alternating which goes
   first; host seconds of each item, ending in a synchronise. Then the
   host cost of one span, off, on, with CUDA events, and as a root.
2. Idle: one traced item under `torch.profiler` with the card's activity
   alone (as the benchmark's first traced pass), then one with the host's
   too. The stretches of the item's window in which nothing ran on the
   card are put down to the innermost program span whose host interval
   covers their middle (the spans and the profiler share a clock); a
   stretch over 1 ms outside every non-root span is listed with the host
   events that cover it (second pass), as are the CUDA runtime calls
   (launches, copies, synchronises, cudaMalloc / cudaFree) by span. The
   in-memory spans' starts are checked against the profiler's host events
   of the same names.

Writes the JSON to `--out` and prints a summary line. Needs a CUDA card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "portbench"))
sys.path.insert(0, str(ROOT))

import run as bench_run  # noqa: E402
from harness import manifest, trace as trace_mod  # noqa: E402


def _walk(span):
    yield span
    for child in span.children:
        yield from _walk(child)


def _tree(span) -> dict:
    return {"name": span.name, "host_ms": span.host_ms,
            "self_ms": span.self_ms, "device_ms": span.device_ms,
            "counters": span.counters, "attrs": span.attrs,
            "start_ms": span.start_ns / 1e6,
            "children": [_tree(c) for c in span.children]}


def _innermost(root, t_ns):
    """The path of spans (root first) whose host interval covers t_ns."""
    path, node = [], root
    while node is not None and node.start_ns <= t_ns <= node.end_ns:
        path.append(node.name)
        node = next((c for c in node.children
                     if c.start_ns <= t_ns <= c.end_ns), None)
    return path


def _gaps(trace):
    lo, hi = trace.window
    gaps, cursor = [], lo
    for a, b in trace.busy_intervals():
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        gaps.append((cursor, hi))
    return gaps


RUNTIME = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
           "cudaGraphLaunch", "cudaMemcpyAsync", "cudaStreamSynchronize",
           "cudaDeviceSynchronize", "cudaMalloc", "cudaFree")


def _host_calls(host, root) -> dict:
    """CUDA runtime calls by innermost program span: count and host ms."""
    out = {}
    for s in host:
        if s.name not in RUNTIME:
            continue
        key = "/".join(_innermost(root, s.start)) or "outside the root"
        row = out.setdefault(key, {}).setdefault(s.name, [0, 0.0])
        row[0] += 1
        row[1] += (s.end - s.start) / 1e6
    return out


def _span_costs(tracing, torch, n: int = 2000) -> dict:
    """Host microseconds per span: off; on, nested (a flag check, a
    `record_function` and two clock reads); on with CUDA events; a root
    (the allocator's counters read twice)."""
    def timed(body, depth_root: bool) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        if depth_root:
            with tracing.span("cost.root"):
                for _ in range(n):
                    body()
        else:
            for _ in range(n):
                body()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e6

    def plain():
        with tracing.span("cost"):
            pass

    def device():
        with tracing.span("cost", device=True):
            pass

    tracing.disable()
    out = {"off_us": timed(plain, False)}
    tracing.enable()
    try:
        out["on_us"] = timed(plain, True)
        out["on_device_us"] = timed(device, True)
        out["root_us"] = timed(plain, False)
    finally:
        tracing.disable()
        tracing.clear()
    return out


def _attribute(trace, root, host=None) -> dict:
    """Idle time by innermost span, and the stretches over 1 ms that no
    non-root span covers (with what the host's trace shows there)."""
    by_span, outside = {}, []
    for a, b in _gaps(trace):
        mid = (a + b) // 2
        path = _innermost(root, mid)
        key = "/".join(path) or "outside the root"
        by_span[key] = by_span.get(key, 0.0) + (b - a) / 1e6
        if (b - a) > 1_000_000 and len(path) < 2:
            covering = []
            if host is not None:
                covering = sorted((s for s in host if s.start <= mid <= s.end),
                                  key=lambda s: s.start)
            outside.append({"at_ms": (a - trace.window[0]) / 1e6,
                            "ms": (b - a) / 1e6, "spans": path,
                            "host": [s.name[:80] for s in covering][-4:]})
    return {"window_ms": trace.window_s * 1e3, "busy_ms": trace.busy_s * 1e3,
            "idle_ms": (trace.window_s - trace.busy_s) * 1e3,
            "idle_by_span_ms": dict(sorted(by_span.items(),
                                           key=lambda kv: -kv[1])),
            "gaps_over_1ms": sum(1 for a, b in _gaps(trace)
                                 if b - a > 1_000_000),
            "outside_non_root_spans": outside}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--pairs", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    bench_run._environment()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from audiocraft_tpu_torch.utils import tracing
    if not torch.cuda.is_available():
        print("torch_span_breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    ctx = bench_run.Context(cell, args.seed, device, False, torch)
    entry = manifest.load_module("entries", cell.workload["entry"])
    state = entry.setup(ctx)
    ctx.sync()
    index = 0

    def item(on: bool) -> float:
        nonlocal index
        if on:
            tracing.enable()
        t = time.perf_counter()
        try:
            entry.item(state, index, ctx)
            ctx.sync()
            return time.perf_counter() - t
        finally:
            tracing.disable()
            index += 1

    times = {"on": [], "off": []}
    for p in range(args.pairs):
        for on in ((True, False) if p % 2 == 0 else (False, True)):
            times["on" if on else "off"].append(item(on))
    cost = {k: {"median_s": statistics.median(v), "runs_s": v}
            for k, v in times.items()}
    means = {}  # the traced items' spans, with no profiler
    for root in tracing.roots():
        for s in _walk(root):
            row = means.setdefault(s.name, {"host_ms": [], "device_ms": []})
            row["host_ms"].append(s.host_ms)
            if s.device_ms is not None:
                row["device_ms"].append(s.device_ms)
    cost["spans_on_ms"] = {k: {m: statistics.mean(v) if v else None
                               for m, v in row.items()}
                           for k, row in means.items()}
    tracing.clear()
    cost["on_over_off"] = (cost["on"]["median_s"] / cost["off"]["median_s"]
                           - 1.0)

    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "power_limit": bench_run._power_limit(), "cost": cost,
           "span_cost": _span_costs(tracing, torch)}
    for name, activities in (
            ("device_pass", [ProfilerActivity.CUDA]),
            ("host_pass", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        tracing.clear()
        with profile(activities=activities) as prof:
            with record_function(trace_mod.ITEM_SPAN):
                entry.item(state, index, ctx)
                ctx.sync()
        index += 1
        trace = trace_mod.read(prof, torch)
        (root,) = tracing.roots()
        host = trace.host if name == "host_pass" else None
        got = _attribute(trace, root, host)
        got["spans"] = _tree(root)
        if host is not None:  # the same clock: span starts vs the events
            got["host_calls_by_span"] = _host_calls(host, root)
            starts = {}
            for s in host:
                starts.setdefault(s.name, s.start)
            got["clock_offset_us"] = {
                s.name: (s.start_ns - starts[s.name]) / 1e3
                for s in _walk(root) if s.name in starts}
        out[name] = got
    tracing.clear()
    path = Path(args.out or ROOT / "build"
                / f"span_breakdown.{args.workload}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    d = out["device_pass"]
    print(json.dumps({"workload": args.workload,
                      "on_over_off": cost["on_over_off"],
                      "on_s": cost["on"]["median_s"],
                      "span_cost": out["span_cost"],
                      "off_s": cost["off"]["median_s"],
                      "idle_ms": d["idle_ms"], "window_ms": d["window_ms"],
                      "idle_by_span_ms": d["idle_by_span_ms"],
                      "outside": d["outside_non_root_spans"],
                      "host_pass_outside": out["host_pass"][
                          "outside_non_root_spans"],
                      "clock_offset_us": out["host_pass"].get(
                          "clock_offset_us")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark of `audiocraft_tpu_torch` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights made on the card from the seed, the cell's own shapes
warmed up) is timed from the start of this process to the first timed
call. Then whole requests or steps run back to back until `--seconds`
have passed; the cell's end-to-end metrics are taken over all of them and
all of the window's time. With `--trace 1` the same window runs with the
benchmark's own spans on, then a few more whole items run under
`torch.profiler`, and the cell's per-layer metrics are printed in place of
the end-to-end ones. Once the window has closed and the peak memory is
read, the program is freed and the plain reference in
`portbench/reference/` judges what the timed path produced. The last
lines of standard error are the numbers compared, each with its limit;
the last line of standard output is the result as one JSON object.

Needs a CUDA card: without one (or with fewer than the cell asks for) it
exits with code 1 and prints no result. Kernel builds stay inside the
checkout (`build/`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(ROOT))

from harness import manifest, trace as trace_mod  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "audiocraft_tpu"}
MAX_FAILED = 3


def _environment() -> None:
    """Caches inside the checkout, so that nothing outside it is read or
    written (Triton's and torch's extension builds); optional libraries
    kept from loading JAX; the program's warnings off standard error.
    (The T5 conditioner's tokenizer: `harness/conditioning.py`.)"""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    logging.getLogger("audiocraft_tpu_torch").setLevel(logging.ERROR)


class Context:
    """What an entry is given: the cell, the seed, the device, whether the
    run is traced, and torch."""

    def __init__(self, cell, seed, device, traced, torch):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.traced, self.torch = traced, torch

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


class Window:
    """The timed items: (index, seconds, work) each, and the window's
    length."""

    def __init__(self):
        self.items, self.attempted, self.failed = [], 0, 0
        self.seconds = 0.0


def run_window(entry, state, ctx: Context, seconds: float, first: int = 0,
               count=None, span=None) -> Window:
    """Whole items back to back from index `first`, until `seconds` have
    passed (or `count` items are done), each ending in a synchronise."""
    w = Window()
    i = first
    t0 = time.perf_counter()
    while True:
        w.attempted += 1
        t = time.perf_counter()
        try:
            if span is not None:
                with span():
                    work = entry.item(state, i, ctx)
                    ctx.sync()
            else:
                work = entry.item(state, i, ctx)
                ctx.sync()
            w.items.append((i, time.perf_counter() - t, work))
        except Exception:  # a failed request counts, the run goes on
            traceback.print_exc()
            w.failed += 1
        i += 1
        done = time.perf_counter() - t0
        if w.failed >= MAX_FAILED or (count is not None and i - first >= count) \
                or (count is None and done >= seconds):
            break
    w.seconds = time.perf_counter() - t0
    return w


class RunView:
    """What a per-layer metric reader sees: the cell, the entry's state,
    the timed window and the trace (None when untraced)."""

    def __init__(self, cell, state, window, trace, traced_items):
        self.cell, self.state, self.window = cell, state, window
        self.trace, self.traced_items = trace, traced_items


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _traced_items(entry, state, ctx: Context, cell, window: Window):
    """`traced_items` more whole items under `torch.profiler`, twice: with
    the card's activity alone (its operations, their busy time and the
    window; the host not slowed by recording its operations), then with
    the host's too, which names the idle gaps. Both passes' items count in
    the window's attempted and failed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch = ctx.torch
    n = int(cell.workload["traced_items"])
    first = window.items[-1][0] + 1 if window.items else 0

    def span():
        return record_function(trace_mod.ITEM_SPAN)

    device = [ProfilerActivity.CUDA if ctx.device.type == "cuda"
              else ProfilerActivity.CPU]
    entry.before_trace(state, ctx)
    with profile(activities=device) as prof:
        items = run_window(entry, state, ctx, 0.0, first, n, span)
    entry.after_trace(state, ctx)
    trace = trace_mod.read(prof, torch)
    with profile(activities=sorted({ProfilerActivity.CPU, *device},
                                   key=str)) as prof:
        named = run_window(entry, state, ctx, 0.0, first + n, n, span)
    gaps = trace_mod.read(prof, torch).idle_gaps()
    for w in (items, named):
        window.attempted += w.attempted
        window.failed += w.failed
    return trace, items, gaps


def run_cell(cell, seed: int, seconds: float, traced: bool, device, torch,
             count=None) -> dict:
    """One run of `cell`; returns the result's fields and the checks.
    `count` (tests) times that many items in place of `seconds`."""
    ctx = Context(cell, seed, device, traced, torch)
    entry = manifest.load_module("entries", cell.workload["entry"])
    state = entry.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - T_START
    print("portbench: setup " + json.dumps(
        {k: t - T_START for k, t in getattr(state, "marks", {}).items()}),
        flush=True)

    window = run_window(entry, state, ctx, seconds, count=count)
    results = {}
    if not traced:
        e2e = {"setup_s": setup_s,
               **entry.end_to_end(state, window, ctx)}
        results = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in e2e}
    trace = breakdown = None
    if traced:
        trace, items, gaps = _traced_items(entry, state, ctx, cell, window)
        view = RunView(cell, state, window, trace, items)
        for m in cell.per_layer:
            family, _, suffix = m["name"].partition(".")
            value = manifest.load_module("metrics", family).read(view, suffix)
            if value is not None:
                results[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": trace.device_ops(), "idle_gaps": gaps}
        print("portbench: kernels " + json.dumps(trace.kernel_table()),
              flush=True)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    if device.type == "cuda":
        dev["power_limit"] = _power_limit()
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
    entry.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check(state, ctx)
    correct = (window.failed == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": window.attempted,
           "failed": window.failed, "metrics": results, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    import torch
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), torch)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the correctness limits are set from, for one cell.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out <file>.jsonl]

In one process: the cell's program is built and warmed once; for each
seed its weights, sampler and traffic are loaded anew and the timed path
runs at the cell's own size, then the numbers that `run.py` compares are
read against the reference: the entry's `calibration_readings` says what
runs (a serving cell: its first sampled and first greedy request; a
training cell: the three checked steps of a fresh optimizer). For each
control seed the control is read too: the reference in float8 put in the
program's place (and, in a training cell, the reference with half the
batch left out, the loss the mean over the rest). One JSON line per seed.
The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(0, str(BENCH_DIR.parent))

import run  # noqa: E402
from harness import manifest  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    run._environment()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    cell = manifest.resolve(manifest.load_manifest(), args.workload)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    control = {int(x) for x in args.control_seeds.split(",") if x}
    ctx = run.Context(cell, seeds[0], torch.device("cuda", 0), False, torch)
    entry = manifest.load_module("entries", cell.workload["entry"])
    t = time.perf_counter()
    s = entry.setup(ctx)
    ctx.sync()
    print(json.dumps({"workload": cell.name, "setup_s": time.perf_counter() - t,
                      "card": torch.cuda.get_device_name(0),
                      "power_limit": run._power_limit()}), flush=True)
    for seed in seeds:
        ctx.seed = seed
        out = entry.calibration_readings(s, ctx, seed in control)
        line = json.dumps({"workload": cell.name, "seed": seed, **out})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as sink:
                sink.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""MAGNeT-small requests through the stage graphs and through eager steps,
in turns, in one process on the CUDA card.

    python3 scripts/torch_magnet_graphs.py [--pairs 10] [--seed 0]

Builds MAGNeT-small at full width (`builders.get_magnet_small_lm`, seeded
random weights, bf16) with the 32 kHz EnCodec, and answers the same request
(2 texts x 10 s, the default generation parameters, the same seed) with
each non-overlapping stage replayed as one CUDA graph (`graph`), with its
steps run one by one (`eager`, `models.lm._replay_decode_steps` swapped for
a loop). After one warm-up round, `--pairs` rounds alternate the order.
Prints one JSON line: the card's name and power limit, each mode's host
seconds per request (synchronised), their medians, in how many rounds
`graph` beat `eager`, and each graph request's capture seconds (one per
stage). Needs one CUDA card.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TEXTS = ["90s rock song with loud guitars and heavy drums",
         "calm lo-fi piano with soft rain in the background"]
MODES = ("graph", "eager")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from audiocraft_tpu_torch.models import MAGNeT, builders
    from audiocraft_tpu_torch.models import lm as lm_module

    if not torch.cuda.is_available():
        print("torch_magnet_graphs: no CUDA device is available",
              file=sys.stderr)
        return 1
    lm = builders.get_magnet_small_lm(device="cuda", dtype=torch.bfloat16,
                                      seed=args.seed)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=args.seed + 1)
    model = MAGNeT("magnet-small (random weights)", codec, lm,
                   max_duration=10, device="cuda")
    replay, stats = lm_module._replay_decode_steps, lm_module.decode_graph_stats
    stage_captures, capture_s = [], []
    model.set_custom_progress_callback(
        lambda done, total: stage_captures.append(stats.last_capture_s))

    def eager(step, steps, device, generator):
        for _ in range(steps):
            step()

    def request(mode: str) -> float:
        lm_module._replay_decode_steps = eager if mode == "eager" else replay
        try:
            model.set_seed(args.seed)
            stage_captures.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.generate(TEXTS, return_tokens=True)
            torch.cuda.synchronize()
            if mode == "graph":
                capture_s.append(list(stage_captures))
            return time.perf_counter() - t0
        finally:
            lm_module._replay_decode_steps = replay

    for mode in MODES:      # warm-up: cuBLAS handles, allocator
        request(mode)
    seconds = {mode: [] for mode in MODES}
    capture_s.clear()
    for i in range(args.pairs):
        for mode in (MODES if i % 2 == 0 else MODES[::-1]):
            seconds[mode].append(request(mode))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": card, "request": "2 texts x 10 s, default parameters",
        "median_s": {m: statistics.median(v) for m, v in seconds.items()},
        "graph_faster_rounds": sum(g < e for g, e in zip(seconds["graph"],
                                                          seconds["eager"])),
        "rounds": args.pairs, "seconds": seconds,
        "graph_capture_s": capture_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

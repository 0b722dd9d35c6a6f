#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's MusicGen-small generation.

    python3 scripts/torch_profile_decode.py [--frames 100] [--seed 0]

Builds full-width MusicGen-small (T5-base conditioner, 24-layer LM; seeded
random weights, bf16) on the CUDA card and, for two configurations (2 texts
with a bf16 KV cache; 16 texts with an int8 cache), runs `LMModel.generate`
for `--frames` frames twice: once plain, timed with the host clock around a
synchronised run, and once under `torch.profiler`. Prints one JSON line per
configuration: wall seconds per LM forward, device kernel time per forward
(the sum of the profiled CUDA kernels), the device's idle share
(1 - kernel time / wall time), kernel launches per forward, and the kernels
taking the most device time. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes

    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    lm = builders.get_musicgen_small_lm(device="cuda", dtype=torch.bfloat16,
                                        seed=args.seed)
    forwards = len(lm.pattern_provider.get_pattern(args.frames).layout) - 1
    texts = ["90s rock song with loud guitars", "calm lo-fi piano"]

    for prompts, cache in ((2, torch.bfloat16), (16, torch.int8)):
        attrs = [ConditioningAttributes(text={"description": texts[i % 2]})
                 for i in range(prompts)]

        def run():
            g = torch.Generator("cuda").manual_seed(args.seed)
            lm.generate(conditions=attrs, max_gen_len=args.frames,
                        gen=GenParams(top_k=250), cache_dtype=cache,
                        generator=g, device="cuda")
            torch.cuda.synchronize()

        run()  # warm-up: cuBLAS handles, allocator, kernel build
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        print(json.dumps({
            "config": f"{prompts} texts x {args.frames} frames, CFG batch "
                      f"{2 * prompts}, {str(cache).replace('torch.', '')} cache",
            "card": card, "forwards": forwards,
            "wall_ms_per_forward": wall * 1e3 / forwards,
            "device_kernel_ms_per_forward": device_us / 1e3 / forwards,
            "device_idle_share": 1 - device_us / 1e6 / wall,
            "kernel_launches_per_forward": launches / forwards,
            "top_kernels": [{"name": e.key[:80],
                             "ms_per_forward": e.self_device_time_total
                             / 1e3 / forwards,
                             "calls_per_forward": e.count / forwards}
                            for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's LM generation.

    python3 scripts/torch_profile_decode.py [--frames 100] [--seed 0]
        [--model small|melody|style|audiogen]

Builds a full-width LM (seeded random weights, bf16) on the CUDA card:
MusicGen-small (T5-base conditioner, 24-layer LM) by default, or the medium
MusicGen-melody LM (48 layers; T5-base and the chroma of 10 s of seeded
harmonic audio prepended), the medium MusicGen-Style LM (48 layers; the
style tokens of the same audio, through a seeded full-width MERT, and
T5-base prepended) or the medium AudioGen LM (48 layers, T5-large by
cross-attention). For two configurations of the small LM (2 texts with a
bf16 KV cache; 16 texts with an int8 cache), or 2 texts with a bf16 cache
for the others, it runs `LMModel.generate`
for `--frames` frames twice: once plain, timed with the host clock around a
synchronised run, and once under `torch.profiler`. Prints one JSON line per
configuration: wall seconds per LM forward, device kernel time per forward
(the sum of the profiled CUDA kernels, those replayed from a CUDA graph
included), the device's idle share (1 - kernel time / wall time), kernels
run per forward, the host's launch calls per forward (kernel launches and
CUDA graph launches), the kernels taking the most device time, and, where
the tree decodes through a CUDA graph, its capture's host seconds and memory.
`profile_generate` is shared with `chip_smoke.py`. Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

TEXTS = ["90s rock song with loud guitars", "calm lo-fi piano"]
CONFIGS = ((2, "bfloat16"), (16, "int8"))  # texts, KV cache dtype


def profile_generate(torch, lm, prompts: int, cache: str, frames: int,
                     seed: int = 0, attrs=None) -> dict:
    """Time and profile `lm.generate` (top-k 250 sampling, CFG) of `prompts`
    texts (or of the conditions `attrs`) over `frames` frames; one warm-up
    run first."""
    from torch.profiler import ProfilerActivity, profile

    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    forwards = len(lm.pattern_provider.get_pattern(frames).layout) - 1
    if attrs is None:
        attrs = [ConditioningAttributes(text={"description": TEXTS[i % 2]})
                 for i in range(prompts)]

    def run():
        g = torch.Generator("cuda").manual_seed(seed)
        lm.generate(conditions=attrs, max_gen_len=frames,
                    gen=GenParams(top_k=250), cache_dtype=getattr(torch, cache),
                    generator=g, device="cuda")
        torch.cuda.synchronize()

    run()  # warm-up: cuBLAS handles, allocator, kernel build
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    host_launches = sum(e.count for e in events
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.key.startswith(("cudaLaunchKernel",
                                              "cudaGraphLaunch")))
    graph_launches = sum(e.count for e in events
                         if e.key.startswith("cudaGraphLaunch"))
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    out = {
        "config": f"{prompts} texts x {frames} frames, CFG batch "
                  f"{2 * prompts}, {cache} cache",
        "forwards": forwards,
        "wall_ms_per_forward": wall * 1e3 / forwards,
        "device_kernel_ms_per_forward": device_us / 1e3 / forwards,
        "device_idle_share": 1 - device_us / 1e6 / wall,
        "kernel_launches_per_forward": sum(e.count for e in kernels) / forwards,
        "host_launch_calls_per_forward": host_launches / forwards,
        "graph_launches_per_forward": graph_launches / forwards,
        "top_kernels": [{"name": e.key[:80],
                         "ms_per_forward": e.self_device_time_total
                         / 1e3 / forwards,
                         "calls_per_forward": e.count / forwards}
                        for e in top]}
    stats = getattr(lm_module, "decode_graph_stats", None)
    if stats is not None:
        out["graph_capture_s"] = stats.last_capture_s
        out["graph_capture_bytes"] = stats.last_capture_bytes
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--model", default="small",
                        choices=["small", "melody", "style", "audiogen"])
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from audiocraft_tpu_torch.models import builders

    if not torch.cuda.is_available():
        print("torch_profile_decode: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build = {"small": builders.get_musicgen_small_lm,
             "melody": builders.get_musicgen_melody_lm,
             "style": builders.get_musicgen_style_lm,
             "audiogen": builders.get_audiogen_medium_lm}[args.model]
    lm = build(device="cuda", dtype=torch.bfloat16, seed=args.seed)
    attrs = (melody_conditions(torch, lm)
             if args.model in ("melody", "style") else None)
    configs = CONFIGS if args.model == "small" else CONFIGS[:1]
    for prompts, cache in configs:
        print(json.dumps({"card": card, "model": args.model,
                          **profile_generate(torch, lm, prompts, cache,
                                             args.frames, args.seed, attrs)}),
              flush=True)
    return 0


def melody_conditions(torch, lm, seconds: int = 10):
    """The 2 texts, each with 10 s of seeded harmonic audio at the model's
    32 kHz as its melody (no stem separator: the chroma of the full mix)
    or its style."""
    from audiocraft_tpu_torch.modules.conditioners import (
        ConditioningAttributes, WavCondition)
    g = torch.Generator().manual_seed(3)
    t = torch.arange(seconds * 32000) / 32000
    attrs = []
    for text in TEXTS:
        f0 = 110.0 * 2 ** (int(torch.randint(0, 24, (1,), generator=g)) / 12)
        wav = sum(0.3 / h * torch.sin(2 * torch.pi * h * f0 * t)
                  for h in (1, 2, 3))
        attrs.append(ConditioningAttributes(
            text={"description": text},
            wav={"self_wav": WavCondition(wav[None, None].to("cuda"),
                                          torch.tensor([wav.shape[-1]]),
                                          [32000], [None])}))
    return attrs


if __name__ == "__main__":
    sys.exit(main())

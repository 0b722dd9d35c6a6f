#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's MusicGen-small LM train step.

    python3 scripts/torch_profile_train.py [--batch 16] [--seconds 30]
        [--checkpointing none] [--steps 3] [--seed 0]

Builds the MusicGen solver from `configs/solver/musicgen/default.yaml` at
full width (T5-base conditioner, 24-layer LM, f32 parameters, bf16
autocast, AdamW) on the CUDA card, with seeded random weights and seeded
random codes [batch, 4, 50 * seconds], and runs `MusicGenSolver.run_step`:
two warm-up steps, `--steps` steps timed with the host clock around a
synchronised run, then `--steps` steps under `torch.profiler`. Prints one
JSON line: wall seconds per step, device kernel time per step (the sum of
the profiled CUDA kernels), the device's idle share (1 - kernel time / wall
time), kernel launches per step, device time per kernel group (the
flash-attention kernels, GEMMs, the optimizer, casts and copies, layer
norms, the rest) and the kernels taking the most device time. Needs one
CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

GROUPS = (("flash_attention_forward", ("fwd_kernel",)),
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=int, default=30)
    parser.add_argument("--checkpointing", default="none")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiocraft_tpu_torch.config import apply_overrides, load_config
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.solvers import get_solver

    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = load_config("solver/musicgen/default")
    apply_overrides(cfg, [f"dataset.batch_size={args.batch}",
                          "transformer_lm.dtype=bfloat16",
                          f"transformer_lm.checkpointing={args.checkpointing}",
                          f"seed={args.seed}"])
    solver = get_solver(cfg)
    lm = solver.model
    frames = 50 * args.seconds
    g = torch.Generator("cuda").manual_seed(args.seed)
    batch = {"codes": torch.randint(0, lm.card, (args.batch, 4, frames),
                                    device="cuda", generator=g),
             "tokenized": lm.condition_provider.tokenize(
                 [ConditioningAttributes(text={"description": f"track {i}"})
                  for i in range(args.batch)])}

    def steps(n: int) -> None:
        for i in range(n):
            solver.run_step(i, batch, {})
        torch.cuda.synchronize()

    steps(2)  # warm-up: cuBLAS handles, allocator, kernel build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    steps(args.steps)
    wall = (time.perf_counter() - t0) / args.steps
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(args.steps)
    # device kernels only: user-annotated ranges (e.g. the optimizer step's)
    # span kernels already counted
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.self_device_time_total for e in kernels) / args.steps
    launches = sum(e.count for e in kernels) / args.steps
    groups: dict = {}
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / args.steps
        groups[group_of(e.key)] = groups.get(group_of(e.key), 0.0) + ms
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    print(json.dumps({
        "config": f"solver/musicgen/default, batch {args.batch} x "
                  f"{args.seconds} s ({frames} frames), bf16 autocast, "
                  f"checkpointing {args.checkpointing}",
        "card": card, "wall_s_per_step": wall,
        "device_kernel_s_per_step": device_us / 1e6,
        "device_idle_share": 1 - device_us / 1e6 / wall,
        "kernel_launches_per_step": launches,
        "max_memory_allocated": peak,
        "device_ms_per_step_by_group": groups,
        "top_kernels": [{"name": e.key[:90],
                         "ms_per_step": e.self_device_time_total / 1e3
                         / args.steps,
                         "calls_per_step": e.count / args.steps}
                        for e in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

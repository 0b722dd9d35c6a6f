#!/usr/bin/env python3
"""Int4-KV decode attention (K3) on the card: the counterpart of
`scripts/pallas_int4_decode.py`'s main().

    python3 scripts/torch_int4_decode.py [--steps 500] [--seed 0]

Packs seeded bf16 K/V [B, S, H, D] = [512, 512, 16, 64] (MusicGen-small's
attention at a CFG batch of 256 x 2; S covers the 504 pattern slots of a
10 s clip) into the int4 layout (`quant_pack_kv`) and attends one query per
(row, head) at length 384 through K3 (`int4_decode_attention`), through K1
(`decode_attention`) over the int8 cache of the same K/V, and through K1 over
the bf16 cache. Prints each path's max error relative to the max of f32
attention over the bf16 K/V, then, with a card, each path's device ms per
call (median of 50 calls, L2 flushed; `utils.timing.time_ms`), the cache
bytes it reads and its effective GB/s, and a --steps decode loop through K3
that feeds each output back as the next query (the JAX script's scan). One
JSON line each, with the card's name and power limit. Without a card it
prints the correctness lines only, at B=4, S=64, on the CPU (the kernels'
plain versions).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, S, D = 512, 16, 512, 64


def valid_length(S: int) -> int:
    """The JAX script's length: three quarters of the cache."""
    return S - S // 4


def make_inputs(torch, B, H, S, D, device, seed=0):
    """Seeded bf16 q [B, H, D] and k, v [B, S, H, D]."""
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(*shape, device=device, generator=g).to(torch.bfloat16)
            for shape in ((B, H, D), (B, S, H, D), (B, S, H, D))]


def caches(torch, q, k, v):
    """The three caches of the same K/V and a call of each path on q:
    {path: (fn(query), cache bytes read at the valid length)}."""
    from audiocraft_tpu_torch.modules.transformer import KVCache
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.ops.int4_decode_attention import (
        int4_decode_attention, quant_pack_kv)
    length = valid_length(k.shape[1])
    k4, v4t, ks4, vs4 = quant_pack_kv(k, v)
    (k8, ks8), (v8, vs8) = KVCache._quantize(k), KVCache._quantize(v)
    frac = length / k.shape[1]  # every path reads the valid prefix only
    return {
        "int4-k3": (lambda x: int4_decode_attention(x, k4, v4t, ks4, vs4,
                                                    length),
                    frac * sum(t.nbytes for t in (k4, v4t, ks4, vs4))),
        "int8-k1": (lambda x: decode_attention(x, k8, v8, length, k_scale=ks8,
                                               v_scale=vs8),
                    frac * sum(t.nbytes for t in (k8, v8, ks8, vs8))),
        "bf16-k1": (lambda x: decode_attention(x, k, v, length),
                    frac * (k.nbytes + v.nbytes)),
    }


def relative_errors(torch, q, k, v, paths):
    """max |out - ref| / max |ref| for each path, ref = f32 attention over
    the bf16 K/V at the valid length."""
    length = valid_length(k.shape[1])
    scores = torch.einsum("bhd,bshd->bhs", q.float(),
                          k[:, :length].float()) / q.shape[-1] ** 0.5
    ref = torch.einsum("bhs,bshd->bhd", scores.softmax(-1),
                       v[:, :length].float())
    scale = ref.abs().max()
    return {name: ((fn(q).float() - ref).abs().max() / scale).item()
            for name, (fn, _) in paths.items()}


def decode_loop(torch, fn, q, steps: int):
    """`steps` calls of `fn`, each output fed back as the next query."""
    for _ in range(steps):
        q = (fn(q) * 1.0000001).to(q.dtype)
    return q


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    on_card = torch.cuda.is_available()
    shape = (B, H, S, D) if on_card else (4, H, 64, D)
    device = "cuda" if on_card else "cpu"
    q, k, v = make_inputs(torch, *shape, device, args.seed)
    paths = caches(torch, q, k, v)
    errors = relative_errors(torch, q, k, v, paths)
    for name, err in errors.items():
        print(json.dumps({"path": name, "rel_err_vs_f32": err,
                          "shape": dict(zip("BHSD", shape)),
                          "length": valid_length(shape[2])}), flush=True)
    if not on_card:
        print("CPU correctness only; run on a CUDA card for timing")
        return 0

    from audiocraft_tpu_torch.utils.timing import time_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for name, (fn, nbytes) in paths.items():
        ms = time_ms(lambda: fn(q), flush_bytes=128 << 20)
        print(json.dumps({"path": name, "ms": ms, "cache_bytes": nbytes,
                          "effective_gb_per_s": nbytes / ms / 1e6,
                          "card": card}), flush=True)
    fn = paths["int4-k3"][0]
    decode_loop(torch, fn, q, 5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    final = decode_loop(torch, fn, q, args.steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    print(json.dumps({"path": "int4-k3 decode loop", "steps": args.steps,
                      "wall_ms_per_step": seconds * 1e3 / args.steps,
                      "finite": bool(torch.isfinite(final).all()),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one JSON line:
  device   the card's name and count (and nvidia-smi's name and power limit);
  build    compiles every kernel of the port from `audiocraft_tpu_torch/csrc`;
  kernels  holds each kernel against its plain PyTorch version at the main
           path's shapes and times kernel, plain version and a library call;
  reference  the debug MusicGen, greedy in f32: tokens on the card equal the
           CPU's;
  slice    full-width MusicGen-small (T5-base text encoder, 24-layer LM,
           EnCodec 32 kHz decoder; seeded random weights, bf16) answers 3
           requests of 2 texts x 10 s, then one 16-prompt LM generation over
           an int8 KV cache; checks shapes, finiteness, code range, and that
           every decode-attention step launched the hand-written kernel.
Then the `{"kernels": [...]}` summary, and last `{"ok": true, "device": ...}`.
Any failed check raises, so the script exits non-zero without the last line.
It needs no network and imports nothing of JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

TOKENS_PER_SECOND = 50      # EnCodec 32 kHz frame rate
DURATION = 10               # seconds of audio per request
N_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores, published
SPIN_CYCLES = 2_000_000     # about 1 ms at the H100's clock
TEXTS = ["90s rock song with loud guitars and heavy drums",
         "calm lo-fi piano with soft rain in the background"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _time_ms(fn, n: int = 50, flush_bytes: int = 0) -> float:
    """Median device milliseconds of `fn()` over n warm calls, each timed
    with its own CUDA events. Before each call a buffer larger than L2 is
    rewritten (with `flush_bytes`), so the inputs come from HBM as in the
    decode loop, where the other layers' traffic evicts them; then the
    device spins for about a millisecond, so that the events and `fn`'s
    kernels are all queued before the device reaches them and the interval
    holds device work only, not the host's launch latency."""
    import torch
    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    for _ in range(5):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[n // 2]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    # f32 checks hold f32 math: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=False, cudnn_allow_tf32=False)
    return card


def phase_build():
    from audiocraft_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS)
    report = [line.strip() for log in logs.values() for line in log.splitlines()
              if "registers" in line or "spill" in line]
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in report if "Used " in line})
    spills = [line for line in report if "spill" in line
              and "0 bytes spill stores, 0 bytes spill loads" not in line]
    emit("build", kernels=list(_build.KERNELS),
         seconds=round(time.perf_counter() - t0, 3),
         registers_per_thread=regs, spill_lines=spills[:8])


def _cache(torch, B, S, H, D, kind, g):
    from audiocraft_tpu_torch.modules.transformer import KVCache
    k = torch.randn(B, S, H, D, device="cuda", generator=g)
    v = torch.randn(B, S, H, D, device="cuda", generator=g)
    if kind == "int8":
        (k, ks), (v, vs) = KVCache._quantize(k), KVCache._quantize(v)
        return k, v, dict(k_scale=ks, v_scale=vs)
    dtype = getattr(torch, kind)
    return k.to(dtype), v.to(dtype), {}


def _kernel_bytes_and_ops(B, H, D, length, kind, q_dtype_bytes):
    """HBM bytes (each input read once, the output written once) and f32
    operations of one decode-attention call over `length` valid slots."""
    n = B * length * H
    kv_elem = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    bytes_ = 2 * n * D * kv_elem + 2 * B * H * D * q_dtype_bytes
    ops = 4 * n * D  # q.k and p.v multiply-adds
    if kind == "int8":
        bytes_ += 2 * n * 2       # bf16 scales
        ops += 2 * n * D          # dequantization
    return bytes_, ops


def phase_kernels(torch, S):
    """K1 vs its plain version at the path's shapes, then timings."""
    import torch.nn.functional as F
    from audiocraft_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    H, D = 16, 64
    g = torch.Generator("cuda").manual_seed(0)
    tol = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}
    worst = {}
    checks = 0
    for B in (4, 8, 32, 64):
        for kind in ("float32", "bfloat16", "int8"):
            q_dtype = torch.float32 if kind == "float32" else torch.bfloat16
            q = torch.randn(B, H, D, device="cuda", generator=g).to(q_dtype)
            k, v, scales = _cache(torch, B, S, H, D, kind, g)
            for length, window in ((1, None), (37, None), (S - 1, None),
                                   (S, None), (300, 64)):
                out = decode_attention(q, k, v, length, past_context=window,
                                       **scales)
                torch.cuda.synchronize()
                ref = decode_attention_reference(q, k, v, length,
                                                 past_context=window, **scales)
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= tol[kind]:
                    raise AssertionError(
                        f"decode_attention B={B} {kind} length={length} "
                        f"window={window}: max abs err {err} > {tol[kind]}")
                worst[kind] = max(worst.get(kind, 0.0), err)
                checks += 1
    emit("kernel_check", kernel="decode_attention", checks=checks,
         shapes=dict(B=[4, 8, 32, 64], S=S, H=H, D=D,
                     lengths=[1, 37, S - 1, S], window=[300, 64]),
         max_abs_err=worst, tolerance=tol)

    timings = []
    for B, kind, length in ((32, "int8", S), (4, "bfloat16", S),
                            (32, "int8", S // 2)):
        q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
        k, v, scales = _cache(torch, B, S, H, D, kind, g)
        flush = 128 << 20  # > 50 MB of L2
        ms = _time_ms(lambda: decode_attention(q, k, v, length, **scales),
                      flush_bytes=flush)
        plain_ms = _time_ms(lambda: decode_attention_reference(
            q, k, v, length, **scales), flush_bytes=flush)
        if scales:
            kd = (k.float() * scales["k_scale"][..., None].float()).to(torch.bfloat16)
            vd = (v.float() * scales["v_scale"][..., None].float()).to(torch.bfloat16)
        else:
            kd, vd = k, v
        ql = q[:, :, None]                               # [B, H, 1, D]
        kl = kd[:, :length].transpose(1, 2).contiguous()  # [B, H, len, D]
        vl = vd[:, :length].transpose(1, 2).contiguous()
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl),
                              flush_bytes=flush)
        nbytes, ops = _kernel_bytes_and_ops(B, H, D, length, kind, 2)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        timings.append(dict(B=B, S=S, H=H, D=D, length=length, cache=kind,
                            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound,
                            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                            >= ops / F32_FLOPS else "operations",
                            roofline_share=bound / ms))
    emit("kernel_timing", kernel="decode_attention", l2_flushed=True,
         statistic="median of 50 calls",
         library="torch.nn.functional.scaled_dot_product_attention on the "
                 "dequantized bf16 cache [B, H, len, D]", timings=timings)
    return worst, timings


def phase_reference(torch):
    """Debug MusicGen, greedy, f32: the card's tokens equal the CPU's."""
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    cpu = builders.get_debug_lm_model(device="cpu")
    gpu = builders.get_debug_lm_model(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    for cache_dtype in (torch.float32, torch.int8):
        kw = dict(conditions=attrs, max_gen_len=40, cache_dtype=cache_dtype,
                  gen=GenParams(use_sampling=False))
        a = cpu.generate(device="cpu", **kw)
        b = gpu.generate(device="cuda", **kw).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"debug greedy tokens differ ({cache_dtype})")
    codec_cpu = builders.get_debug_compression_model(device="cpu")
    codec_gpu = builders.get_debug_compression_model(device="cuda")
    codec_gpu.load_state_dict(codec_cpu.state_dict())
    wa = codec_cpu.decode(a, device="cpu")
    wb = codec_gpu.decode(a, device="cuda").cpu()
    err = (wa - wb).abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"debug codec decode differs by {err}")
    emit("reference", model="debug", tokens_equal=True, frames=40,
         caches=["float32", "int8"], wav_max_abs_err=err, wav_tolerance=1e-4)


def phase_slice(torch, card):
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    t0 = time.perf_counter()
    lm = builders.get_musicgen_small_lm(device="cuda", dtype=torch.bfloat16,
                                        seed=0)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    mg = MusicGen("musicgen-small (random weights)", codec, lm, device="cuda")
    mg.set_generation_params(duration=DURATION)  # sampling, top-k 250, cfg 3
    mg.set_seed(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    frames = DURATION * TOKENS_PER_SECOND
    steps = len(lm.pattern_provider.get_pattern(frames).layout)
    forwards = steps - 1  # the prefill over step 0, then one per slot

    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = 0
    request_s = []
    for _ in range(N_REQUESTS):
        t = time.perf_counter()
        wav, tokens = mg.generate(TEXTS, return_tokens=True)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t)
        if tuple(wav.shape) != (2, 1, frames * 640):
            raise AssertionError(f"waveform shape {tuple(wav.shape)}")
        if not torch.isfinite(wav).all():
            raise AssertionError("non-finite waveform")
        if not (int(tokens.min()) >= 0 and int(tokens.max()) < 2048):
            raise AssertionError("codes outside [0, 2048)")
    attrs = [ConditioningAttributes(text={"description": TEXTS[i % 2]})
             for i in range(16)]
    t = time.perf_counter()
    codes = lm.generate(conditions=attrs, max_gen_len=frames,
                        gen=GenParams(top_k=250), cache_dtype=torch.int8,
                        generator=torch.Generator("cuda").manual_seed(1),
                        device="cuda")
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t
    launches = decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    if tuple(codes.shape) != (16, 4, frames):
        raise AssertionError(f"int8 codes shape {tuple(codes.shape)}")
    if not (int(codes.min()) >= 0 and int(codes.max()) < 2048):
        raise AssertionError("int8 codes outside [0, 2048)")
    expected = lm.num_layers * forwards * (N_REQUESTS + 1)
    if launches != expected:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {expected}")
    emit("slice", model="musicgen-small (T5-base, 24-layer LM, EnCodec 32 kHz; "
         "seeded random weights, bf16)", card=card, setup_s=setup_s,
         requests=N_REQUESTS, texts_per_request=len(TEXTS),
         audio_s_per_text=DURATION, request_s=request_s,
         audio_s_per_s=[len(TEXTS) * DURATION / s for s in request_s],
         int8_cache_prompts=16, int8_generate_s=int8_s,
         int8_audio_s_per_s=16 * DURATION / int8_s,
         pattern_steps=steps, forwards_per_generate=forwards,
         decode_attention_launches=launches, expected_launches=expected,
         max_memory_allocated=peak)
    return launches


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "audiocraft_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(audiocraft_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    card = phase_device(torch)
    phase_build()
    frames = DURATION * TOKENS_PER_SECOND
    from audiocraft_tpu_torch.modules.patterns import DelayedPatternProvider
    S = len(DelayedPatternProvider(4).get_pattern(frames).layout)
    worst, timings = phase_kernels(torch, S)
    phase_reference(torch)
    launches = phase_slice(torch, card)

    main_t = timings[0]
    print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "audiocraft_tpu_torch/csrc/decode_attention.cu",
        "replaces": "audiocraft_tpu/ops/flash_attention.py:94",
        "launches": launches, "max_abs_err": max(worst.values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shape": {k: main_t[k] for k in ("B", "S", "H", "D", "length",
                                          "cache")}}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

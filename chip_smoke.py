#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printing one JSON line:
  device   the card's name and count (and nvidia-smi's name and power limit);
  build    compiles every kernel of the port from `audiocraft_tpu_torch/csrc`;
  kernel_check / kernel_timing  hold each kernel (decode attention K1, causal
           flash attention K2 forward and backward) against its plain PyTorch
           version at the main paths' shapes, and time kernel, plain version
           and a library call; K1 also over cases that reach every cluster
           size 1..8 and every load path (B 1-512, S 504 and 1500, H 5/16/24,
           D 64/66/128, windows 0 and 64) and is timed at B 4 bf16, B 32 int8
           and B 512 int8 and bf16, and at S/8 and S/2 of the cache, its
           length always read from the device; K1 is then captured into a
           CUDA graph whose replays step its device length from 1 to S,
           each output held against the plain version; K2 is checked at
           the edges of its tiles (T 127,
           128, 129, 1501; D 64 and 128), its backward twice on the same
           inputs for bit-identical gradients, and timed at T 1500 and 1501;
           the cross-attention step K4 over the serving shapes, Tc 1 and
           512, f32 caches, D 8, 24 and 128, at 1, 2 and 4 warps per (row,
           head), timed beside the plain attention it replaced and SDPA
           over the same stored K/V;
  reference  the debug MusicGen, greedy in f32: tokens on the card equal the
           CPU's; then a train step of a small K2-eligible LM in f32: CE and
           every gradient on the card match the CPU's, and
           checkpointing='torch' gives the same gradients;
  slice    full-width MusicGen-small (T5-base text encoder, 24-layer LM,
           EnCodec 32 kHz decoder; seeded random weights, bf16) answers 3
           requests of 2 texts x 10 s, then one 16-prompt LM generation over
           an int8 KV cache; checks shapes, finiteness, code range, that
           every generate decoded through one captured CUDA graph and that
           every decode-attention and cross-attention step launched its
           hand-written kernel (K1, K4; replays count the launches they
           hold); then 1 s of greedy
           tokens from the graph equals the same step run eagerly on the
           card (bf16 and int8 caches), and a profile at 100 frames gives
           wall and device ms per forward and the idle share;
  train    the MusicGen solver config at full width (T5-base, 24 layers,
           f32 parameters, bf16 autocast, AdamW) takes 5 steps on 16 x 30 s
           of seeded audio encoded by the full-width EnCodec; checks finite
           and falling CE and that every self-attention forward and backward
           launched K2;
  train_remat  the same solver and batch under checkpointing 'none',
           'torch', 'dots' and 'dots_nb' (selective checkpointing that saves
           the products' and K2's outputs), 3 steps each from the same
           weights: K2's launches per step (forward L, 2L under 'torch';
           backward L), the first step's gradients against 'none''s, the
           steady step time, the peak memory and device ms by kernel group;
  resume   2 more steps, `save_checkpoints`, a fresh solver that
           `restore`s them (weights equal bit for bit), then one step in
           each: equal CE and weights within 2 x lr;
  parallel the same LM and batch through `parallel/` on a one-rank NCCL
           group (mesh 1 x 1 x 1): `shard_lm`, 2 sharded steps against 2
           plain steps from the same weights (CE within 1e-5 relative,
           weights within 2 x lr, K2 on every layer), `save_sharded` with
           its `.tmp.done` token, a fresh sharded LM that restores and
           takes the 3rd step with the CE of the run that went on,
           bitwise; the epoch guard and `average_metrics`; then a SEANet
           codec under `time_group_norm`, card against CPU;
  magnet_train  MAGNeT-small training at full width (8 x 10 s): two steps
           of each codebook stage, then two `run_step`s; finite CE, ms per
           step, peak memory, no K2 launch (non-causal attention);
  style_train  MusicGen-Style training at full width: the style
           conditioner's training forward (batch-norm statistics, RVQ EMA,
           quantizer dropout and dead codes) on the card against the CPU in
           f64, then 3 `run_step`s of the medium LM on 4 x 30 s with the
           conditioner in its eval forward (its buffers unchanged) and K2 on
           every layer;
  int4_kernel_check / int4_kernel_timing  hold the int4-KV decode attention
           K3 against its plain version (B 1, 2, 4, 512; D 64, 128; S 504, 512;
           lengths 1, 33, 384, S; with and without a window of 7; and a
           30,000-slot cache with windows past 28,672 slots), then time
           it at scripts/pallas_int4_decode.py's shape (B 512, H 16, S 512,
           D 64) beside its plain version and K1 over the int8 and the bf16
           cache of the same K/V;
  int4_path  the path of scripts/torch_int4_decode.py (the counterpart of
           the JAX script's main): pack, attend, errors against f32
           attention, and a decode loop through K3; checks the launches;
  variants full-width MusicGen-small serving variants (bf16, seeded random
           weights, 5 s per text): W8A8 int8 weights (1 text, then 2; logit
           drift of one forward against bf16), two-step CFG, continuation of
           2 s of 44.1 kHz stereo audio, and musicgen-stereo-small (8
           interleaved codebooks); first holds K1 against its plain version
           at these runs' shapes (B 2 and 4, the 5 s cache of 254 slots);
           checks shapes, finiteness, code range and that every
           decode-attention step launched K1;
  melody   full-width MusicGen-melody (medium LM: d 1536, 24 heads, 48
           layers; T5-base and the chroma prepended; EnCodec 32 kHz; seeded
           random weights, bf16) with a full-width HTDemucs set as its stem
           separator: 2 texts x 10 s against 10 s of 44.1 kHz stereo under
           batched, two-step and double CFG, after K1 is held against its
           plain version at H 24 over each stream's rows and capacity
           (pattern steps plus prefix) and timed at B 4; checks shapes,
           finiteness, code range, one decode graph per generate, K1's
           launches (layers x (forwards - 1) per stream: the prefill sits
           behind the prefix), and 1 s of greedy tokens from the graph
           against the eager step (one stream and two); prints the request
           split into stem separation, conditions, prefill, replays and
           codec decode;
  audiogen full-width AudioGen-medium (medium LM, T5-large by
           cross-attention, EnCodec 16 kHz; seeded random weights, bf16): 2
           texts x 10 s, then 12 s through the sliding window, with the same
           checks, K1 first held and timed at H 24 over its 254 slots;
  style    full-width MusicGen-Style (medium LM; the style tokens of a 3 s
           excerpt through a full-width MERT, f32, and T5-base prepended;
           EnCodec 32 kHz; seeded random weights, bf16): 2 texts x 10 s
           against 2 clips of 10 s of 32 kHz music, top-k 250, CFG 3,
           under batched CFG, double CFG (beta 5) and with eval_q 1, after
           K1 is held against its plain version at H 24 over the request's
           rows (4 and 6) and capacity (504 pattern steps plus 15 style and
           the text tokens) and timed there; the same checks as melody,
           graph against eager steps under batched and double CFG, and the
           request split into resample + MERT, the style conditioner, T5,
           prefill, replays and codec decode;
  magnet   full-width MAGNeT-small (24 layers of 1024, T5-base by
           cross-attention, EnCodec 32 kHz; seeded random weights, bf16): 2
           texts x 10 s with the default generation parameters; checks
           [2, 4, 498] codes below the card's size (no mask token left),
           finite audio, one CUDA graph per stage and that K1 did not run,
           and that greedy tokens of the graphs equal the eager steps';
           prints the request, each stage's device time, the ms per forward
           (B 4 x 498 steps) with its kernels by device time, and the peak
           memory;
  mbd      full-width Multi-Band Diffusion (`solver/diffusion/default` over
           `model/score/basic`, 4 bands at 32 kHz: a DiffusionUnet of
           48-192-768-3072 channels with a 3072 BiLSTM per band, an 8-band
           processor, 20 reverse steps; EnCodec 32 kHz; seeded random
           weights, f32): `tokens_to_wav` on 2 x 10 s of seeded MusicGen
           codes, then `regenerate` on 2 x 2 s of 44.1 kHz audio; checks
           shapes and finiteness, and one band's U-Net and the 32-band split
           on a 1 s slice against the CPU; prints the request split into
           codec decode, condition, each band's reverse process and re-EQ,
           ms per U-Net forward with its kernels, the BiLSTM's share and the
           peak memory;
  audioseal  AudioSeal at its base widths (16 bits, SEANet 128 / 32
           filters, 2 LSTM layers, detector output 32; seeded random
           weights, f32): watermarks the slice's 2 x 10 s of audio, taken to
           16 kHz, with a seeded message, and detects it; checks both
           against the CPU and that the detection probabilities sum to 1;
           prints ms for each;
  jasco    JASCO chords + drums at full width (`solver/jasco/chords_drums` at
           `model_scale/small`: dim 1024, 16 heads, 24 layers, T5-base by
           cross-attention; EnCodec 32 kHz; seeded random weights, f32) with
           a full-width HTDemucs separating the drums: 2 texts x 10 s with
           chords and 10 s of seeded drums by Dormand-Prince (cfg_coef_all
           5), then 50 Euler steps; checks shapes, finiteness, the Euler
           step count and one forward on a short sequence against the CPU;
           prints each request split into tokenize (drum separation and
           encode), conditions (T5), solve (with its evaluations) and codec
           decode, ms per forward at B 4 x 500 with its kernels, and the
           peak memory;
  loaders  full-width MusicGen-small (`solver/musicgen/default`, seeded,
           f32) saved as upstream does, without its T5 keys, loads through
           `loaders.load_lm_model`; with the in-memory model's T5 weights its
           greedy tokens for 2 texts x 1 s equal the in-memory model's,
           through K1; EnCodec 32 kHz saved as `compression_state_dict.bin`
           and as a Hugging Face snapshot (HF names, weight-normed,
           `model.safetensors` from the port's numpy writer) decodes them to
           the in-memory codec's waveform; prints the load seconds;
  mbd_train  `DiffusionSolver` at `solver/diffusion/default`'s widths at
           32 kHz over that codec package: 1 s segments at the largest batch
           of 128 / 64 / 32 / 16 that fits, 5 `run_step`s (step s, audio-s/s,
           peak memory, the condition's codec pass, the U-Net's forward and
           backward with its BiLSTM's share, the loss per step), then the
           loss and every gradient on 2 rows against the CPU;
  jasco_train  `JascoSolver` at smoke-jasco's model over the same codec:
           16 rows of 10 s, each with its clip as `self_wav` (HTDemucs
           separates the drums) and seeded frame chords, 5 `run_step`s split
           into separation + drum latents, latents, tokenize and the train
           step, then the loss on 2 rows of 2 s against the CPU;
  codec_train  `CompressionSolver` at `solver/compression/
           encodec_musicgen_32khz` with ratios 8-5-4-4 (the codec
           MusicGen-small decodes with; MS-STFT adversary, balancer, f32):
           1 s clips at the largest batch of 64 / 32 / 16 that fits, 5
           `run_step`s with k-means on the first (step s, audio-s/s, peak
           memory, device ms of the generator's forward, the discriminator
           update, the balanced losses' gradients and the backward with
           Adam; each loss first to last; codebooks inited and codes
           expired), then card against CPU on 2 rows from the same state: a
           step with the discriminator's update (the losses before it, the
           discriminator within 2 x lr after it) and one without (every
           loss, every gradient); the saved checkpoint loaded as a
           `compression_model_checkpoint` (codes and decode equal);
  watermark_train  `WatermarkSolver` at `solver/watermark/default`'s widths
           (16 bits, SEANet 128 / 32 filters, ratios 8-5-4-2; l1, msspec, TF
           loudness ratio over 4 bands, detection, decoding; balancer; f32)
           with `dataset.segment_duration=1.0` (the composed config's null
           raises in both packages): 1 s rows at the largest batch of 128 /
           64 / 32 that fits, 5 steps whose draws cover the pad, mix and none
           masks and the four default effects (step s, audio-s/s, peak
           memory, device ms of the generator forward, the balanced losses
           with their gradient, the detection and decoding losses' forward
           and backward, and Adam; each loss first to last), then card
           against CPU on 2 rows (every loss, every gradient), each of the 12
           non-codec effects of `watermark/robustness.yaml`, the loudness
           biquad on the TF-loudness rows in f64 against its recurrence, and
           one `evaluate` pass;
  clap     MusicGen-small with `conditioner=clapemb2music` (HTSAT-base and
           RoBERTa-base towers with 512-wide projections from a seeded
           checkpoint the phase writes in the Hugging Face layout, a
           synthetic 50265-entry byte-level vocabulary, RVQ 12 x 1024; LM
           bf16): 2 texts x 10 s as joint conditions through the decode graph
           (the request split into text tower, conditioner and generate) and
           through `MusicGen.generate` (its rows null), K1's launches; the
           audio tower's ms per 10 s window of a 30 s clip; the embeddings
           card against CPU; greedy tokens over 1 s card against CPU in f32;
  dac      DAC 44.1 kHz at the dac package's default geometry (seeded, f32)
           saved as a dac `weights.pth` and read through
           `DAC.get_pretrained`: encode and decode 2 x 10 s (ms, peak
           memory), then codes (but near-ties of the cosine lookup, recorded)
           and decode card against CPU on 2 x 1 s;
  data_train  the data plane and the training entry point: 64 stereo 16-bit
           WAVs of 60 s at 44.1 kHz (0.68 GB, synthesised from a seed, with
           JSON sidecars) under a temporary directory, their manifest from
           `python -m audiocraft_tpu_torch.data.audio_dataset`; the loader
           alone at 0 and 8 worker processes (segments/s, audio-s/s, the
           first batch bitwise equal at both); then `train.main` with
           `solver=musicgen/musicgen_base_32khz` over that datasource (16 x
           30 s resampled to 32 kHz mono by the workers, the loaders
           phase's EnCodec package, bf16 autocast, 6 updates, a
           checkpoint): step s and the share spent waiting in
           `next(loader)`, K2's launches, and its generate stage (2 greedy
           samples of 10 s stored by the sample manager, K1's launches);
           the checkpoint exported as a package and read back by
           `loaders.load_lm_model` (greedy tokens equal the in-memory
           model's); the same step on one batch held on the card; peak
           memory; then the loader's worker processes and fork server
           are stopped;
  evaluate the evaluate stage through the grid CLI
           (`musicgen.musicgen_pretrained_32khz_eval --run --max-jobs 1`
           with `-o` overrides) over data_train's checkpoint and WAVs: 16
           segments of 10 s in 2 batches of 8, each generated at 10 s
           (top-k 250, CFG 3.0) through K1's decode graph, then FAD over
           VGGish, KLD over PaSST-S, CLAP text consistency (the clap
           phase's towers) and chroma cosine, the towers at their published
           widths from seeded checkpoints, f32 without TF32: the result's
           keys, K1's launches, every tower and the LM on the card, per
           batch the generate s and each update's host and other s, the
           computes' s, peak memory; the towers on 2 generated clips card
           against CPU (relative L2); then the script checks that no
           process it started is left.
Then the `{"kernels": [...]}` summary, and last `{"ok": true, "device": ...}`.
Any failed check raises, so the script exits non-zero without the last line.
It needs no network and imports nothing of JAX.
"""
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

TOKENS_PER_SECOND = 50      # EnCodec 32 kHz frame rate
DURATION = 10               # seconds of audio per request
N_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, published
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores, published
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores, published
TRAIN_BATCH = 16
TRAIN_SECONDS = 30
TRAIN_STEPS = 5
TEXTS = ["90s rock song with loud guitars and heavy drums",
         "calm lo-fi piano with soft rain in the background"]
VARIANT_SECONDS = 5         # audio seconds per text in the variants phase
PROMPT_SECONDS = 2          # of 44.1 kHz stereo audio, to continue
INT4_SHAPE = dict(B=512, H=16, S=512, D=64)  # scripts/pallas_int4_decode.py
INT4_STEPS = 100            # decode-loop steps of the int4 path


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _children() -> list:
    """(pid, command line) of every live process whose parent is this one."""
    found = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            fields = stat[stat.rindex(")") + 2:].split()
            if int(fields[1]) == os.getpid() and fields[0] != "Z":
                cmd = (entry / "cmdline").read_bytes().replace(b"\0", b" ")
                found.append((int(entry.name), cmd.decode(errors="replace")))
        except (OSError, ValueError):
            pass  # ended while being read
    return found


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
    regs, spills, warnings = set(), [], []
    for log in logs.values():
        function = ""
        for line in log.splitlines():
            if "Function properties for " in line:
                function = line.split("Function properties for ")[1].strip()
            elif "Used " in line and "registers" in line:
                regs.add(int(line.split("Used ")[1].split()[0]))
            elif "spill" in line and " 0 bytes spill stores, 0 bytes spill loads" \
                    not in line:
                spills.append(f"{function[-70:]}: {line.strip()}")
            elif "warning" in line.lower():
                warnings.append(line.strip()[-160:])
    emit("build", kernels=list(_build.KERNELS),
         seconds=round(time.perf_counter() - t0, 3),
         registers_per_thread=sorted(regs), spill_lines=spills[:8],
         ptxas_warnings=warnings[:8])


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
        ops += 2 * n              # one scale on each score and weight
    return bytes_, ops


K1_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}


def check_decode_attention(torch, batches, S, path, seed=0, H=16,
                           kinds=("float32", "bfloat16", "int8"), cases=None):
    """K1 vs its plain version at a path's batches and cache capacity S
    (D 64), over `kinds` of cache; (length, window) `cases`, by default
    lengths 1, 37, S - 1, S and a window of 64; lengths on the device.
    Emits one `kernel_check` line and returns the worst error per cache."""
    from audiocraft_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference, length_tensor)
    D = 64
    g = torch.Generator("cuda").manual_seed(seed)
    if cases is None:
        cases = ((1, None), (37, None), (S - 1, None), (S, None),
                 (min(300, S - 4), 64))
    worst = {}
    checks = 0
    for B in batches:
        for kind in kinds:
            q_dtype = torch.float32 if kind == "float32" else torch.bfloat16
            q = torch.randn(B, H, D, device="cuda", generator=g).to(q_dtype)
            k, v, scales = _cache(torch, B, S, H, D, kind, g)
            for length, window in cases:
                out = decode_attention(q, k, v, length_tensor(length, "cuda"),
                                       past_context=window, **scales)
                torch.cuda.synchronize()
                ref = decode_attention_reference(q, k, v, length,
                                                 past_context=window, **scales)
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= K1_TOL[kind]:
                    raise AssertionError(
                        f"decode_attention {path} B={B} S={S} {kind} "
                        f"length={length} window={window}: max abs err {err} "
                        f"> {K1_TOL[kind]}")
                worst[kind] = max(worst.get(kind, 0.0), err)
                checks += 1
    emit("kernel_check", kernel="decode_attention", path=path, checks=checks,
         shapes=dict(B=list(batches), S=S, H=H, D=D, caches=list(kinds),
                     length_window=[list(c) for c in cases]),
         max_abs_err=worst, tolerance=K1_TOL)
    return worst


def check_decode_attention_splits(torch, seed=5):
    """K1 vs its plain version over the cases that reach every cluster size
    1..8 of `split_count` (sized by the cache's capacity S) and every load
    path: B 1, 2, 4 and 512; S 504 and 1500, and S 64, 96, 128 and 224 at
    B 1; (H, D) (16, 64), (5, 66) (rows 4- or 2-byte aligned) and (24, 128);
    lengths 1, 33, 100, 130, 200, 250, S - 1 and S (those within S);
    windows of 0 and 64 at the end of the cache and of 64 at S // 2; f32,
    bf16 and int8 caches; lengths on the device. Emits one `kernel_check`
    line; returns the worst error per cache."""
    from audiocraft_tpu_torch.ops.decode_attention import (
        _sm_count, decode_attention, decode_attention_reference, length_tensor,
        split_count)
    g = torch.Generator("cuda").manual_seed(seed)
    shapes = [(B, S, H, D) for B in (1, 2, 4) for S in (504, 1500)
              for H, D in ((16, 64), (5, 66), (24, 128))] + [(512, 504, 16, 64)]
    shapes += [(1, S, 16, 64) for S in (64, 96, 128, 224)]
    worst, splits, checks = {}, set(), 0
    for B, S, H, D in shapes:
        cases = [(length, None) for length in
                 (1, 33, 100, 130, 200, 250, S - 1, S) if length <= S]
        cases += [(S, 0), (S, 64), (S // 2, 64)]
        splits.add(split_count(B, H, S, _sm_count(0)))
        for kind in ("float32", "bfloat16", "int8"):
            q_dtype = torch.float32 if kind == "float32" else torch.bfloat16
            q = torch.randn(B, H, D, device="cuda", generator=g).to(q_dtype)
            k, v, scales = _cache(torch, B, S, H, D, kind, g)
            for length, window in cases:
                out = decode_attention(q, k, v, length_tensor(length, "cuda"),
                                       past_context=window, **scales)
                torch.cuda.synchronize()
                ref = decode_attention_reference(q, k, v, length,
                                                 past_context=window, **scales)
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= K1_TOL[kind]:
                    raise AssertionError(
                        f"decode_attention B={B} S={S} H={H} D={D} {kind} "
                        f"length={length} window={window}: max abs err {err} "
                        f"> {K1_TOL[kind]}")
                worst[kind] = max(worst.get(kind, 0.0), err)
                checks += 1
            del k, v, scales
    if splits != set(range(1, 9)):
        raise AssertionError(f"the split cases reached cluster sizes "
                             f"{sorted(splits)}, not 1..8")
    emit("kernel_check", kernel="decode_attention", path="splits",
         checks=checks, shapes=[dict(B=B, S=S, H=H, D=D)
                                for B, S, H, D in shapes],
         lengths=[1, 33, 100, 130, 200, 250, "S-1", "S"],
         windows=[["S", 0], ["S", 64], ["S//2", 64]],
         cluster_sizes=sorted(splits), max_abs_err=worst, tolerance=K1_TOL)
    return worst


def phase_kernels(torch, S):
    """K1 vs its plain version at the slice path's shapes, then timings."""
    H = 16
    worst = check_decode_attention(torch, (4, 8, 32, 64), S, "slice")
    for kind, err in check_decode_attention_splits(torch).items():
        worst[kind] = max(worst[kind], err)
    g = torch.Generator("cuda").manual_seed(0)

    # the main shapes at the full cache and, as early decode steps see it,
    # at S / 8 and S / 2 (the cluster stays sized by the capacity S)
    timings = time_decode_attention(torch, S, H, (
        (32, "int8", S), (4, "bfloat16", S), (32, "int8", S // 2),
        (512, "int8", S), (512, "bfloat16", S), (4, "bfloat16", S // 8),
        (4, "bfloat16", S // 2), (32, "int8", S // 8)), g)
    return worst, timings


def time_decode_attention(torch, S, H, shapes, g, path="slice"):
    """K1 at each (B, cache kind, length) of `shapes` over a capacity S
    (D 64, bf16 q, the length on the device), beside its plain version and
    scaled_dot_product_attention over the dequantized valid window, with
    the bound; L2 flushed. Emits one `kernel_timing` line."""
    import torch.nn.functional as F
    from audiocraft_tpu_torch.ops.decode_attention import (
        _sm_count, decode_attention, decode_attention_reference, length_tensor,
        split_count)
    from audiocraft_tpu_torch.utils.timing import time_ms
    D = 64
    timings = []
    for B, kind, length in shapes:
        q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
        k, v, scales = _cache(torch, B, S, H, D, kind, g)
        flush = 128 << 20  # > 50 MB of L2
        device_length = length_tensor(length, "cuda")
        ms = time_ms(lambda: decode_attention(q, k, v, device_length,
                                              **scales), flush_bytes=flush)
        plain_ms = time_ms(lambda: decode_attention_reference(
            q, k, v, length, **scales), flush_bytes=flush)
        if scales:
            kd = (k.float() * scales["k_scale"][..., None].float()).to(torch.bfloat16)
            vd = (v.float() * scales["v_scale"][..., None].float()).to(torch.bfloat16)
        else:
            kd, vd = k, v
        ql = q[:, :, None]                               # [B, H, 1, D]
        kl = kd[:, :length].transpose(1, 2).contiguous()  # [B, H, len, D]
        vl = vd[:, :length].transpose(1, 2).contiguous()
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(ql, kl, vl),
                              flush_bytes=flush)
        nbytes, ops = _kernel_bytes_and_ops(B, H, D, length, kind, 2)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        del kd, vd, kl, vl
        timings.append(dict(B=B, S=S, H=H, D=D, length=length, cache=kind,
                            n_split=split_count(B, H, S, _sm_count(0)),
                            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound,
                            bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                            >= ops / F32_FLOPS else "operations",
                            roofline_share=bound / ms))
    emit("kernel_timing", kernel="decode_attention", path=path,
         l2_flushed=True, statistic="median of 50 calls",
         library="torch.nn.functional.scaled_dot_product_attention on the "
                 "dequantized bf16 cache [B, H, len, D]", timings=timings)
    return timings


def phase_graph_kernel(torch, S):
    """K1 with a device length captured once into a CUDA graph, as the
    decode step replays it: each replay adds one to the length on the
    device, from 1 to S, and every output is held against the plain version
    at that length. The slice's shapes (B 4 over a bf16 cache, B 32 over an
    int8 one), each without and with a window of 64."""
    from audiocraft_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    H, D = 16, 64
    g = torch.Generator("cuda").manual_seed(6)
    worst, checks = {}, 0
    for B, kind in ((4, "bfloat16"), (32, "int8")):
        q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
        k, v, scales = _cache(torch, B, S, H, D, kind, g)
        for window in (None, 64):
            length = torch.zeros(1, dtype=torch.int32, device="cuda")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up outside the capture
                decode_attention(q, k, v, length + 1, past_context=window,
                                 **scales)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                length.add_(1)
                out = decode_attention(q, k, v, length, past_context=window,
                                       **scales)
            torch.cuda.current_stream().wait_stream(side)
            for step in range(1, S + 1):
                graph.replay()
                ref = decode_attention_reference(q, k, v, step,
                                                 past_context=window, **scales)
                err = (out.float() - ref.float()).abs().max().item()
                if not err <= K1_TOL[kind]:
                    raise AssertionError(
                        f"decode_attention in a CUDA graph B={B} {kind} "
                        f"length={step} window={window}: max abs err {err} > "
                        f"{K1_TOL[kind]}")
                worst[kind] = max(worst.get(kind, 0.0), err)
                checks += 1
            if int(length) != S:
                raise AssertionError(f"the device length reached "
                                     f"{int(length)}, not {S}")
            del graph
    emit("kernel_check", kernel="decode_attention", path="graph",
         checks=checks, shapes=[dict(B=4, cache="bfloat16"),
                                dict(B=32, cache="int8")],
         S=S, H=H, D=D, lengths=f"1..{S}, one per replay", windows=[None, 64],
         max_abs_err=worst, tolerance=K1_TOL)
    return worst


def _fused_qkv(torch, B, T, H, D, dtype, g):
    """q, k, v [B, T, H, D] as strided chunks of one [B, T, 3HD] leaf, the
    layout the transformer's fused projection gives the kernel."""
    x = torch.randn(B, T, 3 * H * D, device="cuda", generator=g).to(dtype)
    x.requires_grad_(True)
    return x, [t.reshape(B, T, H, D) for t in x.chunk(3, dim=-1)]


def _flash_bytes_and_ops(B, T, H, D, backward):
    """HBM bytes (each input read once, each output written once) and
    tensor-core operations of one causal attention call, bf16."""
    n = B * T * H * D
    causal_pairs = T * (T + 1) // 2
    fwd_ops = 4 * B * H * D * causal_pairs
    if backward:  # q, k, v, out, dO, lse in; dq, dk, dv out
        return 8 * n * 2 + B * H * T * 4, 2.5 * fwd_ops
    return 4 * n * 2 + B * H * T * 4, fwd_ops  # q, k, v in; out, lse out


def phase_flash_kernels(torch):
    """K2 forward and backward vs their plain version, a determinism check,
    then timings at T 1500 and the training length 1501."""
    from audiocraft_tpu_torch.ops.flash_causal_attention import (
        _backward, _forward, flash_causal_attention,
        flash_causal_attention_reference)
    H = 16
    g = torch.Generator("cuda").manual_seed(1)
    tol = {"float32": {"out": 1e-5, "grad": 1e-4},
           "bfloat16": {"out": 2e-2, "grad": 2e-2}}
    worst = {}
    checks = 0
    # T at the edges of the 64- and 128-row tiles, and the training length
    lengths = (1, 63, 64, 65, 127, 128, 129, 300, 1500, 1501)
    cases = [(B, T, 64) for B in (1, 4, 16) for T in lengths]
    cases += [(4, 300, 128), (2, 257, 128)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for B, T, D in cases:
            x, (q, k, v) = _fused_qkv(torch, B, T, H, D, dtype, g)
            dout = torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype)
            out = flash_causal_attention(q, k, v)
            out.backward(dout)
            torch.cuda.synchronize()
            # the plain version in f32 on the same (rounded) inputs
            refs = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
            ref = flash_causal_attention_reference(*refs)[0]
            ref.backward(dout.float())
            got = [out] + [t.reshape(B, T, H, D) for t in x.grad.chunk(3, -1)]
            want = [ref] + [t.grad for t in refs]
            for i, (a, b) in enumerate(zip(got, want)):
                kind = "out" if i == 0 else "grad"
                err = (a.float() - b.float()).abs()
                bound = tol[name][kind] * (1 + b.float().abs())
                if not bool((err <= bound).all()):
                    raise AssertionError(
                        f"flash_causal_attention {name} B={B} T={T} D={D} "
                        f"{['out', 'dq', 'dk', 'dv'][i]}: max abs err "
                        f"{err.max().item()} beyond atol = rtol = "
                        f"{tol[name][kind]}")
                worst[f"{name}_{kind}"] = max(worst.get(f"{name}_{kind}", 0.0),
                                              err.max().item())
            checks += 1
    # the backward is deterministic: two calls on the same inputs, bit for bit
    B, T, D = 16, 1501, 64
    _, (q, k, v) = _fused_qkv(torch, B, T, H, D, torch.bfloat16, g)
    q, k, v = (t.detach() for t in (q, k, v))
    dout = torch.randn(B, T, H, D, device="cuda", generator=g).to(torch.bfloat16)
    out, lse = _forward(q, k, v)
    first = _backward(q, k, v, out, lse, dout)
    second = _backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("flash_causal_attention backward: two calls on the "
                             "same inputs differ")
    del first, second
    emit("kernel_check", kernel="flash_causal_attention", checks=checks,
         shapes=dict(B=[1, 4, 16], T=list(lengths), H=H, D=64,
                     also=[dict(B=4, T=300, D=128), dict(B=2, T=257, D=128)]),
         backward_bit_identical=dict(B=B, T=T, H=H, D=D, dtype="bfloat16",
                                     calls=2, identical=True),
         inputs="chunks of one fused [B, T, 3HD] tensor (row stride 3HD)",
         compared="output and dq, dk, dv from a seeded dO, against the plain "
                  "version in f32 on the same inputs",
         max_abs_err=worst, tolerance="|err| <= tol * (1 + |plain|)",
         tol=tol)

    timings = {T: _time_flash(torch, 16, T, H, 64, g) for T in (1500, 1501)}
    return worst, timings


def _time_flash(torch, B, T, H, D, g):
    """K2 forward and backward at one bf16 shape beside the plain version and
    scaled_dot_product_attention, L2 flushed."""
    import torch.nn.functional as F
    from audiocraft_tpu_torch.ops.flash_causal_attention import (
        _backward, _forward, flash_causal_attention_reference)
    from audiocraft_tpu_torch.utils.timing import time_ms
    flush = 128 << 20
    _, (q, k, v) = _fused_qkv(torch, B, T, H, D, torch.bfloat16, g)
    q, k, v = (t.detach() for t in (q, k, v))
    dout = torch.randn(B, T, H, D, device="cuda", generator=g).to(torch.bfloat16)
    out, lse = _forward(q, k, v)
    ms = time_ms(lambda: _forward(q, k, v), flush_bytes=flush)
    bwd_ms = time_ms(lambda: _backward(q, k, v, out, lse, dout),
                      flush_bytes=flush)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_ms = time_ms(lambda: flash_causal_attention_reference(*leaves),
                        flush_bytes=flush)
    ref = flash_causal_attention_reference(*leaves)[0]
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        ref, leaves, dout, retain_graph=True), flush_bytes=flush)
    del ref
    heads = [t.transpose(1, 2).contiguous().requires_grad_(True)
             for t in (q, k, v)]
    dout_h = dout.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, is_causal=True), flush_bytes=flush)
    lib = F.scaled_dot_product_attention(*heads, is_causal=True)
    library_bwd_ms = time_ms(lambda: torch.autograd.grad(
        lib, heads, dout_h, retain_graph=True), flush_bytes=flush)
    del lib
    timing = {}
    for tag, t_ms, t_plain, t_lib, backward in (
            ("forward", ms, plain_ms, library_ms, False),
            ("backward", bwd_ms, plain_bwd_ms, library_bwd_ms, True)):
        nbytes, ops = _flash_bytes_and_ops(B, T, H, D, backward)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS) * 1e3
        timing[tag] = dict(
            ms=t_ms, plain_ms=t_plain, library_ms=t_lib, bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_FLOPS
            else "operations", roofline_share=bound / t_ms,
            tflops=ops / t_ms / 1e9)
    timing["forward_plus_backward"] = {
        key: timing["forward"][key] + timing["backward"][key]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    emit("kernel_timing", kernel="flash_causal_attention", l2_flushed=True,
         statistic="median of 50 calls", shape=dict(B=B, T=T, H=H, D=D,
                                                    dtype="bfloat16"),
         library="torch.nn.functional.scaled_dot_product_attention(is_causal="
                 "True) on [B, H, T, D] copies; backward alone through "
                 "torch.autograd.grad", **timing)
    return timing


def _cross_step_bytes_and_ops(B, H, Tc, D, kv_bytes, q_bytes):
    """HBM bytes (K and V read once, q read and the output written once)
    and f32 operations of one cross-attention step over Tc keys."""
    n = B * H * Tc * D
    return 2 * n * kv_bytes + 2 * B * H * D * q_bytes, 4 * n


# B, H, Tc, D, dtype of q, k and v: the serving cells' steps (MusicGen-small
# at 192 rows, MusicGen-medium at 4), one key (two-step CFG's null stream)
# and T5's longest, f32 caches, and the head dims at the edges of the lane
# layout (D 128: a row over all 32 lanes in f32; D 8: a lane a key in bf16;
# D 24 in f32: idle lanes in each group)
K4_CASES = ((192, 16, 40, 64, "bfloat16"),
            (4, 24, 40, 64, "bfloat16"),
            (8, 16, 1, 64, "bfloat16"),
            (4, 16, 512, 64, "bfloat16"),
            (6, 16, 77, 64, "float32"),
            (6, 32, 129, 128, "bfloat16"),
            (3, 8, 65, 128, "float32"),
            (5, 5, 300, 8, "bfloat16"),
            (3, 5, 17, 24, "float32"))
# against the plain version on the same inputs, by the output's dtype:
# absolute and relative elementwise (bf16: one ulp, 2^-7 of the value at
# most, where the two f32 results round apart), and the relative L2
# distance from the f32 plain version (bf16 rounding alone reads about
# 1e-3; a key left out at Tc 512 reads several per cent)
K4_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (4e-3, 8e-3)}
K4_REL_L2 = 4e-3
# (label, B, H, Tc): the serving cells' shapes and T5's longest at 192 rows
K4_TIMED = (("gen96", 192, 16, 40), ("req2", 4, 24, 40),
            ("gen96_tc512", 192, 16, 512))


def phase_cross_attention_kernels(torch):
    """K4 vs its plain version over `K4_CASES`, each through the wrapper and
    through the C launcher at 1, 2 and 4 warps to a (row, head); then
    timings at `K4_TIMED` (D 64, bf16) beside the plain version, the route
    it replaced (the plain attention, bf16 compute, over the fused
    projection's strided K/V views) and the library: one
    `scaled_dot_product_attention` call over the same stored [B, H, Tc, D]
    K/V. Emits a `kernel_check` and a `kernel_timing` line; returns the
    worst error per output dtype and the timings."""
    import torch.nn.functional as F
    from audiocraft_tpu_torch.ops.attention import dot_product_attention
    from audiocraft_tpu_torch.ops.cross_attention_step import (
        _DTYPE_CODES, _launcher, _sm_count, cross_attention_step,
        cross_attention_step_reference, warps_per_head)
    from audiocraft_tpu_torch.utils.timing import time_ms
    g = torch.Generator("cuda").manual_seed(7)
    worst, worst_rel, checks = {}, {}, 0
    for B, H, Tc, D, name in K4_CASES:
        q, k, v = (torch.randn(*shape, device="cuda", generator=g).to(
            getattr(torch, name)) for shape in ((B, H, D), (B, H, Tc, D),
                                                (B, H, Tc, D)))
        ref = cross_attention_step_reference(q, k, v).float()
        exact = cross_attention_step_reference(q.float(), k.float(),
                                               v.float())
        outs = [cross_attention_step(q, k, v)]
        for wph in (1, 2, 4):
            out = torch.empty_like(q)
            err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, H, Tc, D, _DTYPE_CODES[q.dtype],
                              wph, torch.cuda.current_stream().cuda_stream)
            if err:
                raise AssertionError(f"cross_attention_step launch at {wph} "
                                     f"warps per head: CUDA error {err}")
            outs.append(out)
        torch.cuda.synchronize()
        atol, rtol = K4_TOL[name]
        for out in outs:
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            rel = (torch.linalg.vector_norm(out.float() - exact)
                   / torch.linalg.vector_norm(exact)).item()
            if not (bool((diff <= atol + rtol * ref.abs()).all())
                    and rel < K4_REL_L2):
                raise AssertionError(
                    f"cross_attention_step B={B} H={H} Tc={Tc} D={D} "
                    f"{name}: max abs err {err}, relative L2 {rel} (limits "
                    f"{atol} + {rtol} x |ref|, {K4_REL_L2})")
            worst[name] = max(worst.get(name, 0.0), err)
            worst_rel[name] = max(worst_rel.get(name, 0.0), rel)
            checks += 1
    emit("kernel_check", kernel="cross_attention_step", checks=checks,
         shapes=[dict(B=B, H=H, Tc=Tc, D=D, dtype=name)
                 for B, H, Tc, D, name in K4_CASES],
         warps_per_head=["wrapper", 1, 2, 4], max_abs_err=worst,
         max_rel_l2=worst_rel, tolerance=K4_TOL, rel_l2_limit=K4_REL_L2)

    D, flush, timings = 64, 128 << 20, []
    for label, B, H, Tc in K4_TIMED:
        E = H * D
        q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
        kv = torch.randn(B, Tc, 2 * E, device="cuda", generator=g).to(
            torch.bfloat16)
        k_view, v_view = (t.reshape(B, Tc, H, D) for t in kv.chunk(2, dim=-1))
        k, v = (t.transpose(1, 2).contiguous() for t in (k_view, v_view))
        ms = time_ms(lambda: cross_attention_step(q, k, v), flush_bytes=flush)
        plain_ms = time_ms(lambda: cross_attention_step_reference(q, k, v),
                           flush_bytes=flush)
        q4 = q[:, None]
        einsum_ms = time_ms(lambda: dot_product_attention(
            q4, k_view, v_view, as_float32=False), flush_bytes=flush)
        q_sdpa = q[:, :, None]  # [B, H, 1, D]
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q_sdpa, k, v), flush_bytes=flush)
        nbytes, ops = _cross_step_bytes_and_ops(B, H, Tc, D, 2, 2)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        timings.append(dict(
            cell=label, B=B, H=H, Tc=Tc, D=D, dtype="bfloat16",
            warps_per_head=warps_per_head(B, H, _sm_count(0)), ms=ms,
            plain_ms=plain_ms, einsum_ms=einsum_ms, library_ms=library_ms,
            bound_ms=bound,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOPS
            else "operations", roofline_share=bound / ms))
        del kv, k_view, v_view, k, v
    emit("kernel_timing", kernel="cross_attention_step", l2_flushed=True,
         statistic="median of 50 calls",
         einsum="the route before this kernel: dot_product_attention "
                "(bf16 compute, f32 logits) over [B, Tc, H, D] strided views "
                "of the fused [B, Tc, 2E] projection",
         library="F.scaled_dot_product_attention, q [B, H, 1, D], over the "
                 "stored [B, H, Tc, D] K/V", timings=timings)
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


def _toy_train_lm(device, checkpointing="none"):
    """A small K2-eligible LM: dim 128, 2 heads (D 64), 2 layers, card 64,
    lookup-table text conditioning, f32."""
    from audiocraft_tpu_torch.models.presets import musicgen_lm
    from audiocraft_tpu_torch.modules.conditioners import LUTConditioner
    import torch
    torch.manual_seed(0)
    cond = {"description": LUTConditioner(n_bins=256, dim=128, output_dim=128,
                                          device=device)}
    lm = musicgen_lm("xsmall", card=64, dim=128, num_heads=2,
                     conditioners=cond, checkpointing=checkpointing,
                     device=device)
    lm.reset_parameters(0)
    return lm


def phase_reference_train(torch):
    """One f32 train step of a small K2-eligible LM at T = 299 frames (300
    pattern steps): CE and every gradient on the card (K2) match the CPU's
    (plain version); 'torch' checkpointing matches 'none' on the card and
    launches K2's forward twice as often."""
    import numpy as np
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers import builders as sb
    from audiocraft_tpu_torch.solvers.musicgen import train_step
    codes = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 4, 299)))
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    runs = {}
    for device, mode in (("cpu", "none"), ("cuda", "none"), ("cuda", "torch")):
        lm = _toy_train_lm(device, mode)
        if device == "cuda":
            lm.load_state_dict(runs["cpu", "none"][2])
        if device == "cpu":
            state = {k: v.clone() for k, v in lm.state_dict().items()}
        else:
            state = None
        opt = sb.get_optimizer(lm.parameters(), {"lr": 0.0})
        fca.launches = fca.backward_launches = 0
        m = train_step(lm, opt, codes.to(device),
                       lm.condition_provider.tokenize(attrs))
        grads = {n: p.grad.detach().cpu() for n, p in lm.named_parameters()}
        runs[device, mode] = (m["ce"].item(), grads, state,
                              (fca.launches, fca.backward_launches))
    ce_cpu, g_cpu, _, _ = runs["cpu", "none"]
    ce_gpu, g_gpu, _, launches_none = runs["cuda", "none"]
    ce_remat, g_remat, _, launches_remat = runs["cuda", "torch"]
    ce_err = abs(ce_cpu - ce_gpu)
    grad_err = max((g_cpu[n] - g_gpu[n]).abs().max().item() for n in g_cpu)
    remat_err = max((g_remat[n] - g_gpu[n]).abs().max().item() for n in g_gpu)
    if not ce_err <= 1e-5:
        raise AssertionError(f"toy train step CE differs by {ce_err} (card vs CPU)")
    if not grad_err <= 1e-4:
        raise AssertionError(f"toy train step gradients differ by {grad_err}")
    if not (abs(ce_remat - ce_gpu) <= 1e-6 and remat_err <= 1e-6):
        raise AssertionError(f"checkpointing='torch' differs from 'none' by "
                             f"{remat_err} (CE {ce_remat} vs {ce_gpu})")
    if launches_none != (2, 2) or launches_remat != (4, 2):
        raise AssertionError(f"K2 (forward, backward) launches {launches_none} "
                             f"without and {launches_remat} with remat, "
                             f"expected (2, 2) and (4, 2)")
    emit("reference_train", model="dim 128, 2 heads (D 64), 2 layers, card 64, "
         "f32", frames=299, ce_cpu=ce_cpu, ce_card=ce_gpu, ce_abs_err=ce_err,
         ce_tolerance=1e-5, grad_max_abs_err=grad_err, grad_tolerance=1e-4,
         remat_grad_max_abs_err=remat_err, remat_tolerance=1e-6,
         k2_launches_none=launches_none, k2_launches_torch=launches_remat)


def _eager_decode_steps(step, steps, device, generator):
    """The decode steps of `LMModel.generate` run one by one on the card,
    without the graph: the eager side of the graph-vs-eager check."""
    for _ in range(steps):
        step()


def _script(name: str):
    """A module of `scripts/` (they are not a package)."""
    import importlib.util
    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_slice(torch, card):
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.cross_attention_step import \
        cross_attention_step
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

    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    stats = lm_module.decode_graph_stats
    graph = dict(capture_s=[], capture_bytes=[], replay_ms_per_step=[])

    def note_graph():
        graph["capture_s"].append(stats.last_capture_s)
        graph["capture_bytes"].append(stats.last_capture_bytes)
        graph["replay_ms_per_step"].append(stats.last_replay_ms_per_step())

    torch.cuda.reset_peak_memory_stats()
    captures = stats.captures
    decode_attention.launches = fca.launches = fca.backward_launches = 0
    cross_attention_step.launches = 0
    request_s = []
    for _ in range(N_REQUESTS):
        t = time.perf_counter()
        wav, tokens = mg.generate(TEXTS, return_tokens=True)
        torch.cuda.synchronize()
        request_s.append(time.perf_counter() - t)
        note_graph()
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
    cross_launches = cross_attention_step.launches
    flash_launches = fca.launches + fca.backward_launches
    peak = torch.cuda.max_memory_allocated()
    note_graph()
    if stats.captures - captures != N_REQUESTS + 1:
        raise AssertionError(f"{stats.captures - captures} decode graphs "
                             f"captured for {N_REQUESTS + 1} generates")
    if tuple(codes.shape) != (16, 4, frames):
        raise AssertionError(f"int8 codes shape {tuple(codes.shape)}")
    if not (int(codes.min()) >= 0 and int(codes.max()) < 2048):
        raise AssertionError("int8 codes outside [0, 2048)")
    expected = lm.num_layers * forwards * (N_REQUESTS + 1)
    if launches != expected:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {expected}")
    if cross_launches != expected:  # the same single-step forwards
        raise AssertionError(f"cross_attention_step launched {cross_launches} "
                             f"times, expected {expected}")

    # about 1 s of greedy tokens: the graph's equal the step run eagerly
    short = dict(conditions=attrs[:2], max_gen_len=TOKENS_PER_SECOND,
                 gen=GenParams(use_sampling=False), device="cuda")
    cache_kinds = (torch.bfloat16, torch.int8)
    graph_tokens = [lm.generate(cache_dtype=c, **short) for c in cache_kinds]
    replay = lm_module._replay_decode_steps
    lm_module._replay_decode_steps = _eager_decode_steps
    try:
        eager_tokens = [lm.generate(cache_dtype=c, **short)
                        for c in cache_kinds]
    finally:
        lm_module._replay_decode_steps = replay
    for c, a, b in zip(cache_kinds, graph_tokens, eager_tokens):
        if not torch.equal(a, b):
            raise AssertionError(f"greedy tokens of the graph and of the "
                                 f"eager step differ ({c})")
    # per-forward wall and device time and the idle share, at 100 frames
    profiled = [_script("torch_profile_decode").profile_generate(
        torch, lm, prompts, cache, 100) for prompts, cache in
        ((2, "bfloat16"), (16, "int8"))]
    emit("slice", model="musicgen-small (T5-base, 24-layer LM, EnCodec 32 kHz; "
         "seeded random weights, bf16)", card=card, setup_s=setup_s,
         requests=N_REQUESTS, texts_per_request=len(TEXTS),
         audio_s_per_text=DURATION, request_s=request_s,
         audio_s_per_s=[len(TEXTS) * DURATION / s for s in request_s],
         int8_cache_prompts=16, int8_generate_s=int8_s,
         int8_audio_s_per_s=16 * DURATION / int8_s,
         pattern_steps=steps, forwards_per_generate=forwards,
         decode_attention_launches=launches, expected_launches=expected,
         cross_attention_step_launches=cross_launches,
         flash_causal_attention_launches=flash_launches,
         max_memory_allocated=peak,
         decode_graph=dict(graph, captures=N_REQUESTS + 1,
                           note="one capture per generate (3 bf16 requests, "
                                "then the int8 generate); replay ms per step "
                                "from CUDA events around the replays"),
         graph_vs_eager=dict(frames=TOKENS_PER_SECOND, texts=2, greedy=True,
                             caches=["bfloat16", "int8"], tokens_equal=True),
         profile_100_frames=[{k: p[k] for k in (
             "config", "wall_ms_per_forward", "device_kernel_ms_per_forward",
             "device_idle_share", "kernel_launches_per_forward",
             "host_launch_calls_per_forward", "graph_capture_s",
             "graph_capture_bytes")} for p in profiled])
    return launches, cross_launches, wav


def _seeded_music(torch, batch: int, seconds: int, sample_rate: int = 32000):
    """[batch, 1, seconds * sample_rate] of periodic audio: a few harmonics
    with seeded pitches, amplitudes and phases per row, plus a little noise."""
    g = torch.Generator("cuda").manual_seed(3)
    t = torch.arange(seconds * sample_rate, device="cuda") / sample_rate
    f0 = 110.0 * 2 ** (torch.randint(0, 24, (batch, 1), device="cuda",
                                     generator=g) / 12)
    wav = torch.zeros(batch, t.numel(), device="cuda")
    for h in range(1, 5):
        amp = torch.rand(batch, 1, device="cuda", generator=g) / h
        phase = 2 * torch.pi * torch.rand(batch, 1, device="cuda", generator=g)
        wav += amp * torch.sin(2 * torch.pi * h * f0 * t + phase)
    wav += 0.01 * torch.randn(wav.shape, device="cuda", generator=g)
    return (0.3 * wav / wav.abs().amax(dim=-1, keepdim=True))[:, None]


def phase_train(torch, card):
    """MusicGen-small LM training at full width through the solver's entry
    points: 5 run_steps on 16 x 30 s of encoded audio."""
    from audiocraft_tpu_torch.config import apply_overrides, load_config
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers import get_solver
    t0 = time.perf_counter()
    cfg = load_config("solver/musicgen/default")
    apply_overrides(cfg, [f"dataset.batch_size={TRAIN_BATCH}",
                          "transformer_lm.dtype=bfloat16"])
    solver = get_solver(cfg)  # CUDA
    lm = solver.model
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    codes, _ = codec.encode(_seeded_music(torch, TRAIN_BATCH, TRAIN_SECONDS))
    frames = TRAIN_SECONDS * TOKENS_PER_SECOND
    if tuple(codes.shape) != (TRAIN_BATCH, 4, frames):
        raise AssertionError(f"encoded codes {tuple(codes.shape)}")
    del codec
    texts = [f"{TEXTS[i % 2]}, take {i}" for i in range(TRAIN_BATCH)]
    batch = {"codes": codes, "padding_mask": torch.ones(
        TRAIN_BATCH, frames, dtype=torch.bool, device="cuda"),
        "tokenized": lm.condition_provider.tokenize(
            [ConditioningAttributes(text={"description": t}) for t in texts])}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = fca.launches = fca.backward_launches = 0
    ces, step_s = [], []
    for idx in range(TRAIN_STEPS):
        t = time.perf_counter()
        metrics = solver.run_step(idx, batch, {})
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        ces.append(float(metrics["ce"]))
    launches = (fca.launches, fca.backward_launches, decode_attention.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(ce) for ce in ces):
        raise AssertionError(f"non-finite CE {ces}")
    if not ces[-1] < ces[0]:
        raise AssertionError(f"CE did not fall over {TRAIN_STEPS} steps: {ces}")
    expected = lm.num_layers * TRAIN_STEPS
    if launches[:2] != (expected, expected):
        raise AssertionError(f"K2 forward/backward launched {launches[:2]} "
                             f"times, expected {expected} each")
    # model FLOPs as bench.py counts them: 6 N per token over the LM without
    # its conditioners, plus 12 L T^2 d per sample of attention
    n_trunk = sum(p.numel() for n, p in lm.named_parameters()
                  if not n.startswith("condition_provider"))
    T = frames + 1  # pattern steps the LM sees (keep_only_valid_steps)
    flops = (6 * n_trunk * TRAIN_BATCH * T
             + 12 * lm.num_layers * T * T * lm.dim * TRAIN_BATCH)
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    emit("train", model="musicgen-small LM (T5-base cross-attention, 24 "
         "layers, d 1024, 16 heads, 4 x 2048 codes; seeded random weights, "
         "f32 params, bf16 autocast, AdamW, max_norm 1.0)", card=card,
         config="solver/musicgen/default + dataset.batch_size=16 "
                "transformer_lm.dtype=bfloat16", batch=TRAIN_BATCH,
         seconds_per_item=TRAIN_SECONDS, frames=frames, setup_s=setup_s,
         step_s=step_s, steady_step_s=steady, ce=ces,
         grad_norm_last=float(metrics["grad_norm"]),
         audio_s_per_s=TRAIN_BATCH * TRAIN_SECONDS / steady,
         tokens_per_s=TRAIN_BATCH * frames * 4 / steady,
         model_flops_per_step=flops, trunk_params=n_trunk,
         mfu_vs_989_tflops=flops / steady / BF16_FLOPS,
         k2_forward_launches=launches[0], k2_backward_launches=launches[1],
         expected_launches=expected, decode_attention_launches=launches[2],
         max_memory_allocated=peak)
    return launches, solver, batch


REMAT_STEPS = 3
# bf16 autocast rounds every product's inputs to 8 bits of mantissa
# (2^-8 = 3.9e-3 relative); a recompute replays the same kernels on the
# same inputs, so only sums that the card orders by atomics (the embedding
# and cross-entropy gradients) may move, by a few bf16 ulps of the largest
# entry of a gradient
REMAT_GRAD_RTOL = 2e-2
MAGNET_TRAIN_BATCH = 8      # cut from magnet_32khz's 192 to fit one card
STYLE_TRAIN_BATCH = 4       # cut from musicgen_style_32khz's to fit one card
STYLE_TRAIN_SECONDS = 30
# the style conditioner runs in f64 for its card-vs-CPU check, except its
# attention logits, which are f32 as in the JAX package (1e-7 relative
# apart on card and CPU); through 8 layers of random weights that grows to
# about 1e-5 of the largest entry in the residual rows that replace the
# dead codes (8e-6 measured on an H100)
STYLE_F64_TOL = 1e-4


def _kernel_groups(torch, fn):
    """Device ms of one call of `fn` by kernel group (the groups of
    `scripts/torch_profile_train.py`), through `_profile_kernels`."""
    group_of = _script("torch_profile_train").group_of
    device_ms, kernels = _profile_kernels(torch, fn, reps=1, top=100000)
    groups: dict = {}
    for k in kernels:
        group = group_of(k["name"])
        groups[group] = groups.get(group, 0.0) + k["ms_per_forward"]
    return device_ms, groups


def phase_train_remat(torch, card, solver, batch):
    """The train phase's solver and batch under each checkpointing policy
    ('none', 'torch', 'dots', 'dots_nb'): the same initial weights, 3
    `run_step`s each; K2's launches per step (forward L under 'none',
    'dots' and 'dots_nb', 2L under 'torch'; backward L), the first step's
    gradients against 'none''s, the steady step time, the peak memory and
    a profiled step's device time by kernel group."""
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    lm = solver.model
    L = lm.num_layers
    init = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    expected = {"none": (L, L), "torch": (2 * L, L), "dots": (L, L),
                "dots_nb": (L, L)}
    runs, reference = {}, None
    for mode in expected:
        lm.load_state_dict(init)
        solver.optimizer.optimizer.state.clear()
        lm.transformer.checkpointing = mode
        resident = _release(torch)
        torch.cuda.reset_peak_memory_stats()
        fca.launches = fca.backward_launches = 0
        step_s, ces, grad_err = [], [], 0.0
        for idx in range(REMAT_STEPS):
            t = time.perf_counter()
            metrics = solver.run_step(idx, batch, {})
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            ces.append(float(metrics["ce"]))
            if idx:
                continue
            grads = {n: p.grad.detach().clone()
                     for n, p in lm.named_parameters() if p.grad is not None}
            if reference is None:
                reference = grads
                continue
            for name, g0 in reference.items():
                err = float((grads[name] - g0).abs().max())
                grad_err = max(grad_err, err / max(float(g0.abs().max()),
                                                   1e-30))
            del grads
        launches = (fca.launches / REMAT_STEPS,
                    fca.backward_launches / REMAT_STEPS)
        peak = torch.cuda.max_memory_allocated()
        if launches != expected[mode]:
            raise AssertionError(f"checkpointing={mode!r}: K2 launched "
                                 f"{launches} (forward, backward) per step, "
                                 f"expected {expected[mode]}")
        if not all(math.isfinite(ce) for ce in ces):
            raise AssertionError(f"checkpointing={mode!r}: CE {ces}")
        if not grad_err <= REMAT_GRAD_RTOL:
            raise AssertionError(f"checkpointing={mode!r}: gradients differ "
                                 f"from 'none' by {grad_err} of their largest "
                                 f"entry, beyond {REMAT_GRAD_RTOL}")
        device_ms, groups = _kernel_groups(
            torch, lambda: solver.run_step(REMAT_STEPS, batch, {}))
        runs[mode] = dict(
            step_s=step_s, steady_step_s=sorted(step_s[1:])[len(step_s) // 2 - 1],
            ce=ces, k2_launches_per_step=launches,
            grad_max_rel_err_vs_none=grad_err if mode != "none" else 0.0,
            max_memory_allocated=peak, resident_bytes_before=resident,
            profiled_step_device_ms=device_ms, device_ms_by_group=groups)
    lm.transformer.checkpointing = "none"
    lm.load_state_dict(init)
    solver.optimizer.optimizer.state.clear()
    del init, reference
    base = runs["none"]["steady_step_s"]
    launches = {m: r["k2_launches_per_step"] for m, r in runs.items()}
    emit("train_remat", card=card, batch=TRAIN_BATCH,
         seconds_per_item=TRAIN_SECONDS, steps=REMAT_STEPS, layers=L,
         grad_tolerance=f"max |g - g_none| <= {REMAT_GRAD_RTOL} x max |g_none| "
                        f"per parameter (bf16 autocast)",
         step_s_vs_none={m: r["steady_step_s"] / base for m, r in runs.items()},
         **runs)
    return launches


def phase_resume(torch, card, solver, batch):
    """Checkpoint and resume at full width: 2 steps, `save_checkpoints`, a
    fresh solver (`get_solver`) that `restore`s them (weights equal bit
    for bit), then one more step in each: the same CE, and weights within
    2 x lr of each other (the card sums the embedding gradients with
    atomics, so Adam's first steps on near-zero gradients may differ in
    sign; on the CPU the resumed step is bitwise, `tests/
    test_torch_solvers.py`)."""
    import shutil
    from audiocraft_tpu_torch.solvers import get_solver
    folder = Path(__file__).resolve().parent / "build" / "smoke_resume"
    shutil.rmtree(folder, ignore_errors=True)
    solver.cfg["folder"] = str(folder)
    try:
        for idx in range(2):
            solver.run_step(idx, batch, {})
        _, save_s = _timed(torch, solver.save_checkpoints)
        path = solver.checkpoint_path()
        t0 = time.perf_counter()
        fresh = get_solver(solver.cfg)
        build_s = time.perf_counter() - t0
        restored, restore_s = _timed(torch, fresh.restore)
        if not restored or fresh.epoch != solver.epoch:
            raise AssertionError("the fresh solver did not restore the "
                                 "checkpoint")
        ours, theirs = solver.model.state_dict(), fresh.model.state_dict()
        unequal = [k for k in ours if not torch.equal(ours[k], theirs[k])]
        if unequal:
            raise AssertionError(f"restored weights differ: {unequal[:5]}")
        ce_a = float(solver.run_step(2, batch, {})["ce"])
        ce_b = float(fresh.run_step(2, batch, {})["ce"])
        torch.cuda.synchronize()
        lr = solver.optimizer.optimizer.param_groups[0]["lr"]
        diffs = [(ours[k].float() - theirs[k].float()).abs() for k in ours
                 if ours[k].is_floating_point()]
        weight_err = max(float(d.max()) for d in diffs)
        moved = sum(int((d > 0).sum()) for d in diffs)
        total = sum(d.numel() for d in diffs)
        if not abs(ce_a - ce_b) <= 1e-5 * abs(ce_a):
            raise AssertionError(f"resumed CE {ce_b} vs {ce_a}")
        if not weight_err <= 2 * lr:
            raise AssertionError(f"resumed weights differ by {weight_err} "
                                 f"(> 2 x lr = {2 * lr})")
        emit("resume", card=card, checkpoint_bytes=path.stat().st_size,
             save_s=save_s, fresh_solver_build_s=build_s, restore_s=restore_s,
             ce_continued=ce_a, ce_resumed=ce_b, weights_max_abs_diff=weight_err,
             weights_differing_share=moved / total, weight_tolerance=2 * lr,
             ce_tolerance="1e-5 relative")
        del fresh, ours, theirs, diffs
    finally:
        shutil.rmtree(folder, ignore_errors=True)


PARALLEL_STEPS = 2
CODEC_TGN_SECONDS = 2
# the codec's f32 decode on the card (TF32 off) against the CPU's, as
# relative L2 over the waveform: both sum in their own orders, about 1e-6
CODEC_TGN_RTOL = 1e-4


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _codec_time_group_norm(torch, card):
    """EnCodec 32 kHz's SEANet (`solver/compression/encodec_musicgen_32khz`)
    under `norm: time_group_norm` with `norm_params: {epsilon: 1e-5}`,
    seeded random weights: the encoder's latents and the decoder's
    waveform on the card (f32, TF32 off) against the CPU's."""
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.utils.utils import no_tf32
    cfg = load_config("solver/compression/encodec_musicgen_32khz")
    cfg["encodec"]["seanet"].update(norm="time_group_norm",
                                    norm_params={"epsilon": 1e-5})
    torch.manual_seed(3)
    cpu = builders.get_compression_model(cfg, device="cpu")
    n_norms = sum(type(m).__name__ == "TimeGroupNorm" for m in cpu.modules())
    dev = builders.get_compression_model(cfg, device="cuda")
    dev.load_state_dict(cpu.state_dict())
    x = _seeded_music(torch, 2, CODEC_TGN_SECONDS).float()
    with torch.no_grad(), no_tf32():
        z_cpu = cpu.encoder(x.cpu())
        y_cpu = cpu.decoder(z_cpu)
        z_dev, t = _timed(torch, lambda: dev.encoder(x))
        y_dev, t_dec = _timed(torch, lambda: dev.decoder(z_cpu.to("cuda")))
    errs = {"latent_rel_l2": _rel_l2(z_dev.cpu(), z_cpu),
            "decode_rel_l2": _rel_l2(y_dev.cpu(), y_cpu)}
    if not all(e <= CODEC_TGN_RTOL for e in errs.values()):
        raise AssertionError(f"time_group_norm codec: card vs CPU {errs} "
                             f"beyond {CODEC_TGN_RTOL}")
    return dict(codec_time_group_norm=dict(
        config="solver/compression/encodec_musicgen_32khz + "
               "seanet.norm=time_group_norm, norm_params.epsilon=1e-5",
        group_norms=n_norms, batch=2, seconds=CODEC_TGN_SECONDS,
        encode_s=t, decode_s=t_dec, tolerance=f"relative L2 <= "
        f"{CODEC_TGN_RTOL} (f32, TF32 off)", **errs))


def phase_parallel(torch, card, solver, batch):
    """The sharded training path on a one-rank NCCL group at full width:
    the train phase's solver LM (T5-base, 24 x 1024, f32 parameters, bf16
    autocast) and encoded batch (16 x 30 s). `parallel.distrib.init` on a
    free local port, a 1 x 1 x 1 mesh, `shard_lm`, then 2 sharded steps
    against 2 plain `train_step`s from the same weights (CE within 1e-5
    relative, weights within 2 x lr; K2 forward and backward on every
    layer of every step); `save_sharded` (token present), the 3rd step of
    the run that goes on, a freshly built and sharded LM that
    `restore_sharded`s and takes the same 3rd step (CE bitwise equal);
    the epoch guard and `average_metrics` on the group; then a SEANet
    codec under `time_group_norm`, card against CPU."""
    import shutil
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.parallel import distrib
    from audiocraft_tpu_torch.parallel.checkpoint import (restore_sharded,
                                                          save_sharded)
    from audiocraft_tpu_torch.parallel.composed_check import (
        init_optimizer_state, load_train_state, train_state)
    from audiocraft_tpu_torch.parallel.mesh import create_mesh
    from audiocraft_tpu_torch.parallel.sharding import shard_lm
    from audiocraft_tpu_torch.solvers.musicgen import train_step
    from torch.distributed.tensor import DTensor
    phase_t0 = time.perf_counter()
    lm, dtype = solver.model, solver.compute_dtype
    codes, tokenized = batch["codes"], batch["tokenized"]
    L = lm.num_layers
    folder = Path(__file__).resolve().parent / "build" / "smoke_parallel"
    shutil.rmtree(folder, ignore_errors=True)
    init = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    del solver.optimizer

    # ---- the plain step from these weights
    optimizer = solver.new_optimizer()
    plain_ce = [float(train_step(lm, optimizer, codes, tokenized,
                                 dropout_seed=i, compute_dtype=dtype)["ce"])
                for i in range(PARALLEL_STEPS)]
    plain = {k: v.detach().clone() for k, v in lm.state_dict().items()}
    lr = optimizer.optimizer.param_groups[0]["lr"]
    del optimizer
    lm.load_state_dict(init)
    _release(torch)

    try:
        t = time.perf_counter()
        distrib.init(f"tcp://127.0.0.1:{_free_port()}", world_size=1,
                     rank=0, device="cuda")
        mesh = create_mesh(dp=1, fsdp=1, tp=1)
        shard_lm(lm, mesh)
        optimizer = solver.new_optimizer()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        if not all(isinstance(p, DTensor) for p in lm.parameters()):
            raise AssertionError("shard_lm left a parameter unsharded")

        # ---- sharded steps: the plain step's CE and weights, through K2
        torch.cuda.reset_peak_memory_stats()
        fca.launches = fca.backward_launches = 0
        ces, step_s = [], []
        for i in range(PARALLEL_STEPS):
            m, s = _timed(torch, lambda: train_step(
                lm, optimizer, codes, tokenized, dropout_seed=i,
                compute_dtype=dtype, mesh=mesh))
            ces.append(float(m["ce"]))
            step_s.append(s)
        launches = (fca.launches, fca.backward_launches)
        peak = torch.cuda.max_memory_allocated()
        expected = L * PARALLEL_STEPS
        if launches != (expected, expected):
            raise AssertionError(f"sharded steps: K2 launched {launches} "
                                 f"(forward, backward), expected {expected} "
                                 f"each")
        ce_err = max(abs(a - b) / abs(b) for a, b in zip(ces, plain_ce))
        if not ce_err <= 1e-5:
            raise AssertionError(f"sharded CE {ces} vs plain {plain_ce}")
        ours = lm.state_dict()
        weight_err = max(
            float((ours[k].to_local().float() - v.float()).abs().max())
            for k, v in plain.items() if v.is_floating_point())
        if not weight_err <= 2 * lr:
            raise AssertionError(f"sharded weights differ from the plain "
                                 f"step's by {weight_err} (> 2 x lr)")
        del plain, ours

        # ---- sharded save, then the run goes on for one step
        state = train_state(lm, optimizer)
        path, save_s = _timed(torch, lambda: save_sharded(
            state, folder, name="parallel"))
        token = path.parent / f"{path.name}.tmp.done"
        if not token.exists():
            raise AssertionError(f"no {token.name} after save_sharded")
        written = path.stat().st_size
        del state
        ce3 = float(train_step(lm, optimizer, codes, tokenized,
                               dropout_seed=PARALLEL_STEPS,
                               compute_dtype=dtype, mesh=mesh)["ce"])
        del optimizer
        solver.model = lm = None
        _release(torch)

        # ---- a fresh sharded LM restores and takes the same step
        t = time.perf_counter()
        solver.model = fresh = builders.get_lm_model(solver.cfg,
                                                     device="cuda", seed=9)
        shard_lm(fresh, mesh)
        fresh_opt = solver.new_optimizer()
        init_optimizer_state(fresh_opt.optimizer)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t
        restored, restore_s = _timed(torch, lambda: restore_sharded(
            folder, train_state(fresh, fresh_opt), name="parallel"))
        load_train_state(fresh, fresh_opt, restored)
        step = int(restored["step"])
        del restored
        if step != PARALLEL_STEPS:
            raise AssertionError(f"restored step {step}")
        ce3_restored = float(train_step(
            fresh, fresh_opt, codes, tokenized, dropout_seed=PARALLEL_STEPS,
            compute_dtype=dtype, mesh=mesh)["ce"])
        if ce3_restored != ce3:
            raise AssertionError(f"restored CE {ce3_restored} != {ce3}")
        distrib.check_epoch_consistency(step)
        avg = distrib.average_metrics({"ce": ce3}, count=1)
        if avg != {"ce": ce3}:
            raise AssertionError(f"average_metrics {avg} on one rank")
        backend = torch.distributed.get_backend()
        del fresh, fresh_opt
    finally:
        distrib.close()
        shutil.rmtree(folder, ignore_errors=True)
    _release(torch)
    codec = _codec_time_group_norm(torch, card)
    emit("parallel", card=card, backend=backend, world_size=1,
         mesh={"dp": 1, "fsdp": 1, "tp": 1}, layers=L, batch=TRAIN_BATCH,
         seconds_per_item=TRAIN_SECONDS, setup_s=setup_s, step_s=step_s,
         ce=ces, plain_ce=plain_ce, ce_max_rel_err=ce_err,
         weights_max_abs_diff=weight_err, weight_tolerance=2 * lr,
         k2_forward_launches=launches[0], k2_backward_launches=launches[1],
         expected_launches=expected, max_memory_allocated=peak,
         save_s=save_s, bytes_written=written, fresh_lm_build_s=fresh_s,
         restore_s=restore_s, ce_continued=ce3, ce_restored=ce3_restored,
         restored_step=step, **codec,
         phase_s=time.perf_counter() - phase_t0)


def phase_magnet_train(torch, card):
    """MAGNeT-small training at full width (`solver/magnet/magnet_32khz`:
    24 layers of 1024, T5-base by cross-attention, the parallel pattern;
    seeded random weights, f32 parameters, bf16 autocast, AdamW) on 8 x
    10 s of seeded audio encoded by the full-width EnCodec: two steps of
    each stage (the mask drawn by the solver), then two `run_step`s; finite
    CE, ms per step and stage, peak memory, and no K2 launch (the
    non-causal LM takes the plain attention in both packages)."""
    from audiocraft_tpu_torch.config import apply_overrides, load_config
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers import get_solver
    t0 = time.perf_counter()
    cfg = load_config("solver/magnet/magnet_32khz")
    apply_overrides(cfg, [f"dataset.batch_size={MAGNET_TRAIN_BATCH}",
                          "transformer_lm.dtype=bfloat16"])
    solver = get_solver(cfg)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    codes, _ = codec.encode(_seeded_music(torch, MAGNET_TRAIN_BATCH,
                                          MAGNET_SECONDS))
    del codec
    B, K, T = codes.shape
    texts = [f"{TEXTS[i % 2]}, take {i}" for i in range(B)]
    tokenized = solver.model.condition_provider.tokenize(
        [ConditioningAttributes(text={"description": t}) for t in texts])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fca.launches = fca.backward_launches = 0
    per_stage = {}
    for stage in range(K):
        times, ces = [], []
        for _ in range(2):
            mask = solver._draw_mask(solver._mask_rng, B, T)
            metrics, seconds = _timed(torch, lambda: solver.masked_step(
                codes, tokenized, None, stage, mask))
            times.append(seconds)
            ces.append(float(metrics["ce"]))
        per_stage[stage] = dict(step_s=times, ce=ces)
    batch = {"codes": codes, "tokenized": tokenized}
    run_ces = [float(_timed(torch, lambda: solver.run_step(i, batch, {}))[0]
                     ["ce"]) for i in range(2)]
    launches = (fca.launches, fca.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    ces = [c for v in per_stage.values() for c in v["ce"]] + run_ces
    if not all(math.isfinite(c) for c in ces):
        raise AssertionError(f"MAGNeT training CE {ces}")
    if launches != (0, 0):
        raise AssertionError(f"K2 launched {launches} times in MAGNeT "
                             f"training (its attention is non-causal)")
    emit("magnet_train", card=card, config="solver/magnet/magnet_32khz + "
         f"dataset.batch_size={B} transformer_lm.dtype=bfloat16",
         batch=B, frames=T, setup_s=setup_s, per_stage=per_stage,
         run_step_ce=run_ces, k2_launches=launches,
         max_memory_allocated=peak, resident_bytes_before=resident)
    del solver, codes, tokenized, batch


def phase_style_train(torch, card):
    """MusicGen-Style training at full width (`solver/musicgen/
    musicgen_style_32khz` at the medium scale; MERT of HuBERT-base width
    bound to the style conditioner (style transformer 8 x 512, RVQ 6 x
    1024), T5-base; seeded random weights, f32 parameters, bf16 autocast).
    First the style conditioner's training forward on the MERT features of
    4 x 30 s of seeded music, on the card against the CPU in f64 (but for
    the attention's f32 logits, so that no nearest-code choice falls
    differently): the output, the batch
    norm's running statistics and every codebook after the step, with the
    quantizer dropout and dead-code draws from the conditioner's seeded
    generator; then its f32 training forward timed on the card; then 3
    `run_step`s of the LM (the conditioner in its eval forward, its buffers
    unchanged), with K2's launches, ms per step and peak memory."""
    import copy
    from audiocraft_tpu_torch.config import apply_overrides
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.modules.conditioners import (
        ConditioningAttributes, WavCondition, bind_feat_extractor)
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers import get_solver
    t0 = time.perf_counter()
    cfg = builders._medium_config("solver/musicgen/musicgen_style_32khz")
    apply_overrides(cfg, [f"dataset.batch_size={STYLE_TRAIN_BATCH}",
                          "transformer_lm.dtype=bfloat16"])
    solver = get_solver(cfg)
    lm = solver.model
    style = lm.condition_provider.conditioners["self_wav"]
    bind_feat_extractor(style, builders.get_mert_base("cuda", seed=1))
    B = STYLE_TRAIN_BATCH
    clips = _seeded_music(torch, B, STYLE_TRAIN_SECONDS)
    attrs = [ConditioningAttributes(text={"description": TEXTS[i % 2]})
             for i in range(B)]
    for a, wav in zip(attrs, clips):
        a.wav["self_wav"] = WavCondition(wav[None], torch.tensor(
            [wav.shape[-1]]), [32000], [None])
    tokenized = lm.condition_provider.tokenize(attrs)
    feats = tokenized["self_wav"]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    outs = {}
    for device in ("cuda", "cpu"):
        cond = copy.deepcopy(style).to(device=device, dtype=torch.float64)
        cond.set_seed(0)
        cond.train()
        out = cond({k: v.to(device, torch.float64) for k, v in feats.items()})
        buffers = {k: v.detach() for k, v in cond.state_dict().items()
                   if "batch_norm" in k or "rvq" in k}
        outs[device] = (out[0].detach(), buffers)
        del cond
    errs = {"output": _card_vs_cpu("style training output", outs["cuda"][0],
                                   outs["cpu"][0], STYLE_F64_TOL)}
    for name, want in outs["cpu"][1].items():
        if want.is_floating_point():
            errs[name] = _card_vs_cpu(f"style {name}", outs["cuda"][1][name],
                                      want, STYLE_F64_TOL)
        elif not torch.equal(outs["cuda"][1][name].cpu(), want):
            raise AssertionError(f"style {name} differs")
    del outs
    cond = copy.deepcopy(style).train()
    cond({k: v for k, v in feats.items()})
    _, forward_s = _timed(torch, lambda: cond(feats))
    del cond

    before = {k: v.clone() for k, v in style.state_dict().items()
              if "batch_norm" in k or "rvq" in k}
    frames = STYLE_TRAIN_SECONDS * TOKENS_PER_SECOND
    codes = torch.randint(0, lm.card, (B, 4, frames), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(2))
    batch = {"codes": codes, "tokenized": tokenized}
    resident = _release(torch)
    torch.cuda.reset_peak_memory_stats()
    fca.launches = fca.backward_launches = 0
    step_s, ces = [], []
    for idx in range(3):
        metrics, seconds = _timed(torch, lambda: solver.run_step(idx, batch, {}))
        step_s.append(seconds)
        ces.append(float(metrics["ce"]))
    launches = (fca.launches, fca.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    after = style.state_dict()
    if not all(torch.equal(v, after[k]) for k, v in before.items()):
        raise AssertionError("the style conditioner's statistics or codebooks "
                             "moved in an LM step")
    if not all(math.isfinite(c) for c in ces):
        raise AssertionError(f"style LM CE {ces}")
    if launches != (3 * lm.num_layers, 3 * lm.num_layers):
        raise AssertionError(f"K2 launched {launches}, expected "
                             f"{3 * lm.num_layers} forward and backward")
    emit("style_train", card=card, config="solver/musicgen/"
         "musicgen_style_32khz at model_scale/medium + dataset.batch_size="
         f"{B} transformer_lm.dtype=bfloat16", batch=B,
         seconds_per_item=STYLE_TRAIN_SECONDS, setup_s=setup_s,
         style_tokens=int(feats["mert"].shape[1]),
         conditioner_card_vs_cpu_f64_max_abs_err=errs,
         conditioner_tolerance=f"{STYLE_F64_TOL} x max(1, max |CPU|), f64 "
                               f"(the attention's logits in f32)",
         conditioner_training_forward_s=forward_s, lm_step_s=step_s, ce=ces,
         k2_launches=launches, max_memory_allocated=peak,
         resident_bytes_before=resident)
    del solver, lm, style, batch, tokenized


def _int4_bytes_and_ops(B, H, D, length):
    """HBM bytes (the valid window of the packed K and V, their bf16 scales,
    q and out, each once) and f32 operations (q.k and p.v multiply-adds and
    the nibble decodes) of one int4 decode-attention call, bf16 q."""
    n = B * length * H
    bytes_ = 2 * n * D // 2 + 2 * n * 2 * 2 + 2 * B * H * D * 2
    return bytes_, 6 * n * D


def phase_int4_kernels(torch):
    """K3 vs its plain version on seeded bf16 K/V packed by quant_pack_kv,
    then timings at the JAX script's shape."""
    from audiocraft_tpu_torch.modules.transformer import KVCache
    from audiocraft_tpu_torch.ops.decode_attention import (decode_attention,
                                                           length_tensor)
    from audiocraft_tpu_torch.ops.int4_decode_attention import (
        int4_decode_attention, int4_decode_attention_reference, quant_pack_kv)
    from audiocraft_tpu_torch.utils.timing import time_ms
    H, tol = 16, 1e-2
    g = torch.Generator("cuda").manual_seed(4)
    worst, checks = 0.0, 0
    # (B, D, S, lengths, windows); the last case's windows pass the 28,672
    # slots the kernel's earlier design held in shared memory
    cases = [(B, D, S, (1, 33, 384, S), (None, 7)) for B in (1, 2, 4, 512)
             for D in (64, 128) for S in (504, 512)]
    cases.append((2, 64, 30_000, (30_000, 29_001), (None, 7, 28_800)))
    for B, D, S, lengths, windows in cases:
        k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
                .to(torch.bfloat16) for _ in range(2))
        q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
        packed = quant_pack_kv(k, v)
        for length in lengths:
            for window in windows:
                out = int4_decode_attention(q, *packed, length, window)
                torch.cuda.synchronize()
                ref = int4_decode_attention_reference(
                    q, *packed, length, window).float()
                err = (out.float() - ref).abs()
                if not bool((err <= tol * ref.abs().clamp_min(1.0)).all()):
                    raise AssertionError(
                        f"int4_decode_attention B={B} D={D} S={S} "
                        f"length={length} window={window}: max abs err "
                        f"{err.max().item()} beyond {tol} * max(1, |plain|)")
                worst = max(worst, err.max().item())
                checks += 1
        del k, v, packed
    emit("int4_kernel_check", kernel="int4_decode_attention", checks=checks,
         shapes=dict(B=[1, 2, 4, 512], H=H, D=[64, 128], S=[504, 512],
                     lengths=[1, 33, 384, "S"], window=[None, 7],
                     long=dict(B=2, D=64, S=30_000, lengths=[30_000, 29_001],
                               window=[None, 7, 28_800])),
         inputs="seeded bf16 K/V packed by quant_pack_kv, bf16 q",
         max_abs_err=worst, tolerance="|err| <= 1e-2 * max(1, |plain|)")

    B, S, D = INT4_SHAPE["B"], INT4_SHAPE["S"], INT4_SHAPE["D"]
    flush = 128 << 20
    k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
            .to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, H, D, device="cuda", generator=g).to(torch.bfloat16)
    packed = quant_pack_kv(k, v)
    (k8, ks8), (v8, vs8) = KVCache._quantize(k), KVCache._quantize(v)
    timings = []
    for length in (S - S // 4, S):
        ms = time_ms(lambda: int4_decode_attention(q, *packed, length),
                      flush_bytes=flush)
        plain_ms = time_ms(lambda: int4_decode_attention_reference(
            q, *packed, length), flush_bytes=flush)
        k1_length = length_tensor(length, "cuda")  # K1 reads it on the device
        k1_int8_ms = time_ms(lambda: decode_attention(
            q, k8, v8, k1_length, k_scale=ks8, v_scale=vs8), flush_bytes=flush)
        k1_bf16_ms = time_ms(lambda: decode_attention(q, k, v, k1_length),
                              flush_bytes=flush)
        nbytes, ops = _int4_bytes_and_ops(B, H, D, length)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3
        timings.append(dict(
            B=B, S=S, H=H, D=D, length=length, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by="bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / F32_FLOPS else "operations", roofline_share=bound / ms,
            bytes=nbytes, effective_gb_per_s=nbytes / ms / 1e6,
            library_ms=None, k1_int8_ms=k1_int8_ms, k1_bf16_ms=k1_bf16_ms))
    emit("int4_kernel_timing", kernel="int4_decode_attention", l2_flushed=True,
         statistic="median of 50 calls",
         library="none: no single PyTorch call attends over an int4 cache; "
                 "yardsticks: K1 (decode_attention) over the int8 and the "
                 "bf16 cache of the same K/V", timings=timings)
    return worst, timings


def phase_int4_path(torch, card):
    """scripts/torch_int4_decode.py's path at its shape: pack, attend through
    K3 (and K1 over the int8 and bf16 caches), errors against f32 attention,
    then INT4_STEPS decode steps through K3 feeding each output back."""
    from audiocraft_tpu_torch.ops.int4_decode_attention import \
        int4_decode_attention
    script = _script("torch_int4_decode")
    shape = [INT4_SHAPE[k] for k in "BHSD"]
    int4_decode_attention.launches = 0
    q, k, v = script.make_inputs(torch, *shape, "cuda", seed=0)
    paths = script.caches(torch, q, k, v)
    errors = script.relative_errors(torch, q, k, v, paths)
    t = time.perf_counter()
    final = script.decode_loop(torch, paths["int4-k3"][0], q, INT4_STEPS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    launches = int4_decode_attention.launches
    if launches != INT4_STEPS + 1:
        raise AssertionError(f"int4_decode_attention launched {launches} "
                             f"times, expected {INT4_STEPS + 1}")
    if not bool(torch.isfinite(final).all()):
        raise AssertionError("non-finite output of the int4 decode loop")
    if not (0.02 < errors["int4-k3"] < 0.35 and errors["int8-k1"] < 0.03):
        raise AssertionError(f"errors against f32 attention out of range: "
                             f"{errors}")
    emit("int4_path", script="scripts/torch_int4_decode.py", card=card,
         shape=INT4_SHAPE, length=script.valid_length(INT4_SHAPE["S"]),
         rel_err_vs_f32=errors, decode_steps=INT4_STEPS,
         decode_loop_wall_ms_per_step=loop_s * 1e3 / INT4_STEPS,
         int4_decode_attention_launches=launches)
    return launches


def _k1_launches(lm, frames: int, prompt_frames: int = 0,
                 streams: int = 1) -> int:
    """Decode-attention launches of one generate: one per layer and stream
    for every single-step forward. The prefill is one only without a prompt
    and without prepended conditions (which put their prefix before it)."""
    pattern = lm.pattern_provider.get_pattern(frames)
    start = pattern.get_first_step_with_timesteps(prompt_frames)
    single_prefill = start == 1 and not lm.fuser.has_prepend
    single = len(pattern.layout) - 1 - start + (1 if single_prefill else 0)
    return lm.num_layers * single * streams


def _check_generation(torch, name, wav, tokens, shape, n_q, frames, launches,
                      expected):
    if tuple(wav.shape) != shape:
        raise AssertionError(f"{name}: waveform shape {tuple(wav.shape)}, "
                             f"expected {shape}")
    if not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"{name}: non-finite waveform")
    if tuple(tokens.shape) != (shape[0], n_q, frames):
        raise AssertionError(f"{name}: codes shape {tuple(tokens.shape)}")
    if not (int(tokens.min()) >= 0 and int(tokens.max()) < 2048):
        raise AssertionError(f"{name}: codes outside [0, 2048)")
    if launches != expected:
        raise AssertionError(f"{name}: decode_attention launched {launches} "
                             f"times, expected {expected}")


def phase_variants(torch, card):
    """MusicGen-small serving variants at full width, through the entry
    points a user calls."""
    from audiocraft_tpu_torch.data.audio_utils import convert_audio
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models.lm import quantize_lm_
    from audiocraft_tpu_torch.modules.patterns import DelayedPatternProvider
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    frames = int(VARIANT_SECONDS * TOKENS_PER_SECOND)
    samples = frames * 640
    uneven = [TEXTS[0], "calm piano"]  # 9 and 2 words
    # K1 at these runs' shapes: batch 2 (one text with CFG, or one stream of
    # two-step CFG) and 4 (two texts with CFG), over the cache of each pattern
    k1_worst = {}
    for S in sorted({len(provider.get_pattern(frames).layout) for provider in (
            DelayedPatternProvider(4),
            DelayedPatternProvider(8, delays=builders.STEREO_SMALL_DELAYS))}):
        for kind, err in check_decode_attention(torch, (2, 4), S,
                                                "variants").items():
            k1_worst[kind] = max(k1_worst.get(kind, 0.0), err)
    lm = builders.get_musicgen_small_lm(device="cuda", dtype=torch.bfloat16,
                                        seed=0)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    mg = MusicGen("musicgen-small (random weights)", codec, lm, device="cuda")
    mg.set_seed(0)
    runs = {}

    def run(name, texts, *, n_q=4, channels=1, prompt=None, streams=1,
            prompt_frames=0):
        decode_attention.launches = 0
        t = time.perf_counter()
        if prompt is None:
            wav, tokens = mg.generate(texts, return_tokens=True)
        else:
            wav, tokens = mg.generate_continuation(prompt, 44100, texts,
                                                   return_tokens=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = decode_attention.launches
        expected = _k1_launches(mg.lm, frames, prompt_frames, streams)
        _check_generation(torch, name, wav, tokens,
                          (len(texts), channels, samples), n_q, frames,
                          launches, expected)
        runs[name] = dict(texts=len(texts), request_s=seconds,
                          audio_s_per_s=len(texts) * VARIANT_SECONDS / seconds,
                          decode_attention_launches=launches)
        return wav, tokens

    mg.set_generation_params(duration=VARIANT_SECONDS)
    for i in range(2):
        run(f"bf16_b1_{i}", TEXTS[:1])

    mg.set_generation_params(duration=VARIANT_SECONDS, two_step_cfg=True)
    run("two_step_cfg", uneven, streams=2)
    cond, null = mg.lm.prepare_cfg_conditions(mg._prepare_tokens_and_attributes(
        uneven, None)[0], two_step=True)
    cond_len = cond["description"][0].shape[1]
    null_len = null["description"][0].shape[1]

    mg.set_generation_params(duration=VARIANT_SECONDS)
    prompt = _seeded_music(torch, 4, PROMPT_SECONDS,
                           sample_rate=44100).reshape(2, 2, -1)
    prompt_frames = int(PROMPT_SECONDS * TOKENS_PER_SECOND)
    _, tokens = run("continuation", TEXTS, prompt=prompt,
                    prompt_frames=prompt_frames)
    prompt_codes, _ = mg.compression_model.encode(
        convert_audio(prompt, 44100, 32000, 1), device="cuda")
    if tuple(prompt_codes.shape) != (2, 4, prompt_frames) or not torch.equal(
            tokens[..., :prompt_frames], prompt_codes):
        raise AssertionError("continuation: the prompt's codes are not kept")

    # W8A8: one forward against bf16 on the same weights, then quantized
    seq = torch.randint(0, 2048, (1, 4, 32), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    ct = mg.lm.compute_conditions(mg.lm.condition_provider.tokenize(
        mg._prepare_tokens_and_attributes(TEXTS[:1], None)[0]))
    with torch.no_grad():
        ref = mg.lm(seq, ct).float()
        quantize_lm_(mg.lm)
        out = mg.lm(seq, ct).float()
    drift = ((out - ref).abs().max() / ref.std()).item()
    corr = torch.corrcoef(torch.stack([ref.flatten(), out.flatten()]))[0, 1].item()
    if not (math.isfinite(drift) and corr > 0.9):
        raise AssertionError(f"W8A8 logits drift {drift}, correlation {corr}")
    for i in range(2):
        run(f"w8a8_b1_{i}", TEXTS[:1])
    run("w8a8_b2", TEXTS)
    del mg, lm, codec, ref, out
    torch.cuda.empty_cache()

    stereo_lm = builders.get_musicgen_stereo_small_lm(
        device="cuda", dtype=torch.bfloat16, seed=0)
    stereo_codec = builders.get_wrapped_compression_model(
        builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16, seed=1),
        {"interleave_stereo_codebooks": {"use": True, "per_timestep": False}})
    mg = MusicGen("musicgen-stereo-small (random weights)", stereo_codec,
                  stereo_lm, device="cuda")
    mg.set_seed(0)
    mg.set_generation_params(duration=VARIANT_SECONDS)
    run("stereo", TEXTS, n_q=8, channels=2)
    emit("variants", model="musicgen-small and musicgen-stereo-small (T5-base, "
         "24-layer LM, EnCodec 32 kHz; seeded random weights, bf16; sampling, "
         "top-k 250, cfg 3)", card=card, audio_s_per_text=VARIANT_SECONDS,
         runs=runs, w8a8_logit_drift_over_std=drift,
         w8a8_logit_correlation=corr,
         two_step_condition_lengths=dict(cond=cond_len, null=null_len),
         continuation_prompt="2 s of seeded stereo audio at 44.1 kHz, "
                             "converted to 32 kHz mono",
         stereo_delays=builders.STEREO_SMALL_DELAYS)
    return k1_worst


MELODY_SECONDS = 10         # of 44.1 kHz stereo melody, and of music
AUDIOGEN_SECONDS = (10, 12)  # per request; 12 s takes the sliding window
AUDIOGEN_RATE = 25          # EnCodec 16 kHz frame rate


def _timed(torch, fn):
    """(fn(), host seconds to the end of its device work)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _graph_vs_eager(torch, generate):
    """Greedy tokens of `generate()` through the decode graph, then with
    the decode steps run eagerly on the card; raises unless equal."""
    from audiocraft_tpu_torch.models import lm as lm_module
    graph_tokens = generate()
    replay = lm_module._replay_decode_steps
    lm_module._replay_decode_steps = _eager_decode_steps
    try:
        eager_tokens = generate()
    finally:
        lm_module._replay_decode_steps = replay
    if not torch.equal(graph_tokens, eager_tokens):
        raise AssertionError("greedy tokens of the graph and of the eager "
                             "step differ")
    return tuple(graph_tokens.shape)


def _capacities(lm, attrs, frames, two_step=False, beta=None):
    """(rows, cache capacity) of each stream of one generate: the pattern
    steps plus the stream's prepended conditions."""
    S = len(lm.pattern_provider.get_pattern(frames).layout)
    conds = lm.prepare_cfg_conditions(attrs, two_step, beta)
    streams = conds if isinstance(conds, tuple) else (conds,)
    return [(next(iter(ct.values()))[0].shape[0],
             S + lm.fuser.prepend_length(ct)) for ct in streams]


def phase_melody(torch, card):
    """Full-width MusicGen-melody (medium LM, T5-base and the chroma of
    2^14-point frames prepended, EnCodec 32 kHz; seeded random weights,
    bf16) with a full-width HTDemucs (seeded, f32) set as its stem
    separator: 2 texts x 10 s against 10 s of 44.1 kHz stereo melody under
    batched, two-step and double CFG, after K1 is held against its plain
    version at these requests' heads, batches and capacities."""
    from audiocraft_tpu_torch.data.audio_utils import convert_audio
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.modules.conditioners import (
        ClassifierFreeGuidanceDropout, WavCondition)
    from audiocraft_tpu_torch.modules.demucs import HTDemucs, separate_melody
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    t0 = time.perf_counter()
    lm = builders.get_musicgen_melody_lm(device="cuda", dtype=torch.bfloat16,
                                         seed=0)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    torch.manual_seed(2)
    separator = HTDemucs().to("cuda").eval()
    chroma = lm.condition_provider.conditioners["self_wav"]
    chroma.set_separator(separator)
    mg = MusicGen("musicgen-melody (random weights)", codec, lm,
                  device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    frames = MELODY_SECONDS * TOKENS_PER_SECOND
    hop = int(mg.sample_rate // mg.frame_rate)
    melody = _seeded_music(torch, 4, MELODY_SECONDS,
                           sample_rate=44100).reshape(2, 2, -1)
    modes = {"batched": {}, "two_step": {"two_step_cfg": True},
             "double": {"cfg_coef_beta": 5.0}}

    # K1 at these requests' shapes: rows and capacity of every stream
    melody32 = convert_audio(melody, 44100, 32000, 1)
    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    for a, wav in zip(attrs, melody32):
        a.wav["self_wav"] = WavCondition(wav[None], torch.tensor(
            [wav.shape[-1]]), [32000], [None])
    shapes = {mode: _capacities(lm, attrs, frames, "two_step_cfg" in kw,
                                kw.get("cfg_coef_beta"))
              for mode, kw in modes.items()}
    k1_worst = {}
    for B, S in sorted({shape for v in shapes.values() for shape in v}):
        cases = tuple((n, None) for n in (max(1, S // 8), S // 2, S))
        for kind, err in check_decode_attention(
                torch, (B,), S, "melody", seed=7, H=lm.num_heads,
                kinds=("bfloat16",), cases=cases).items():
            k1_worst[kind] = max(k1_worst.get(kind, 0.0), err)
    S_melody = shapes["batched"][0][1]
    timings = time_decode_attention(
        torch, S_melody, lm.num_heads,
        [(4, "bfloat16", n) for n in (S_melody // 8, S_melody // 2, S_melody)],
        torch.Generator("cuda").manual_seed(8), path="melody")

    stats = lm_module.decode_graph_stats
    runs, launches_total = {}, 0
    torch.cuda.reset_peak_memory_stats()
    for mode, kw in modes.items():
        mg.set_generation_params(duration=MELODY_SECONDS, **kw)
        mg.set_seed(0)
        captures = stats.captures
        decode_attention.launches = 0
        (wav, tokens), seconds = _timed(torch, lambda: mg.generate_with_chroma(
            TEXTS, melody, 44100, return_tokens=True))
        launches = decode_attention.launches
        launches_total += launches
        streams = 2 if mode == "two_step" else 1
        expected = _k1_launches(lm, frames, streams=streams)
        _check_generation(torch, f"melody {mode}", wav, tokens,
                          (2, 1, frames * hop), 4, frames, launches, expected)
        if stats.captures - captures != 1:
            raise AssertionError(f"melody {mode}: {stats.captures - captures} "
                                 f"decode graphs captured for one generate")
        runs[mode] = dict(request_s=seconds,
                          audio_s_per_s=len(TEXTS) * MELODY_SECONDS / seconds,
                          streams=[dict(rows=b, capacity=c)
                                   for b, c in shapes[mode]],
                          decode_attention_launches=launches,
                          expected_launches=expected,
                          replay_ms_per_step=stats.last_replay_ms_per_step(),
                          capture_s=stats.last_capture_s)
    peak = torch.cuda.max_memory_allocated()

    # where a batched request's time goes, piece by piece
    mg.set_generation_params(duration=MELODY_SECONDS)
    with torch.no_grad():
        _, separation_s = _timed(torch, lambda: separate_melody(
            separator, melody32, 32000))
        rows = attrs + ClassifierFreeGuidanceDropout(p=1.0)(attrs)
        tokenized, tokenize_s = _timed(
            torch, lambda: lm.condition_provider.tokenize(rows))
        conditions, conditions_s = _timed(
            torch, lambda: lm.compute_conditions(tokenized))
        prefix = lm.fuser.prepend_length(conditions)
        caches = lm.transformer.init_cache(4, S_melody, torch.bfloat16, "cuda")
        first = torch.full((4, 4, 1), lm.special_token_id, device="cuda")
        _, prefill_s = _timed(torch, lambda: lm(first, conditions,
                                                caches=caches))
    del caches
    codes, generate_s = _timed(torch, lambda: lm.generate(
        condition_tensors=conditions, num_samples=2, max_gen_len=frames,
        gen=lm_module.GenParams(**mg.generation_params),
        generator=mg.generator, device="cuda"))
    replay_ms = stats.last_replay_ms_per_step()
    _, decode_s = _timed(torch, lambda: mg.generate_audio(codes))
    breakdown = dict(
        stem_separation_s=separation_s,
        tokenize_s=tokenize_s,
        tokenize_note="stem separation and chroma of the 2 melodies, text "
                      "tokens",
        conditions_s=conditions_s,
        conditions_note="T5-base over 4 rows, the projections",
        prepend_length=prefix, prefill_s=prefill_s,
        prefill_note=f"one forward of {prefix + 1} steps over 4 rows",
        generate_s=generate_s, replay_ms_per_step=replay_ms,
        decode_steps=stats.last_replays[2],
        replays_s=replay_ms * stats.last_replays[2] / 1e3,
        codec_decode_s=decode_s)

    # 1 s of greedy tokens with a prefix: graph and eager steps agree, in
    # one stream (batched) and in two of different capacities (two-step)
    checked = []
    for kw in ({}, {"two_step_cfg": True}):
        mg.set_generation_params(duration=1, use_sampling=False, **kw)
        checked.append(_graph_vs_eager(torch, lambda: mg.generate_with_chroma(
            TEXTS, melody, 44100, return_tokens=True)[1]))
    chroma.set_separator(None)
    emit("melody", model="musicgen-melody (medium LM: d 1536, 24 heads, 48 "
         "layers, 4 x 2048 codes; T5-base and chroma prepended; EnCodec 32 "
         "kHz; seeded random weights, bf16), HTDemucs (full width, seeded, "
         "f32) as stem separator", card=card, setup_s=setup_s,
         texts=len(TEXTS), audio_s_per_text=MELODY_SECONDS,
         melody=f"{MELODY_SECONDS} s of seeded harmonic audio, 44.1 kHz "
                "stereo",
         chroma_len=chroma.chroma_len, runs=runs, breakdown=breakdown,
         max_memory_allocated=peak,
         graph_vs_eager=dict(seconds=1, greedy=True,
                             modes=["batched", "two_step"], shapes=checked,
                             tokens_equal=True))
    del mg, lm, codec, separator
    torch.cuda.empty_cache()
    return launches_total, k1_worst, timings


def phase_audiogen(torch, card):
    """Full-width AudioGen-medium (medium LM, T5-large by cross-attention,
    EnCodec 16 kHz; seeded random weights, bf16): 2 texts x 10 s, then a
    12 s request through the sliding window, after K1 is held against its
    plain version at these requests' shapes."""
    from audiocraft_tpu_torch.models import AudioGen, builders
    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    t0 = time.perf_counter()
    lm = builders.get_audiogen_medium_lm(device="cuda", dtype=torch.bfloat16,
                                         seed=0)
    codec = builders.get_encodec_16khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    ag = AudioGen("audiogen-medium (random weights)", codec, lm,
                  device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    frames = AUDIOGEN_SECONDS[0] * AUDIOGEN_RATE
    hop = int(ag.sample_rate // ag.frame_rate)
    S = len(lm.pattern_provider.get_pattern(frames).layout)
    k1_worst = check_decode_attention(
        torch, (4,), S, "audiogen", seed=9, H=lm.num_heads,
        kinds=("bfloat16",), cases=tuple((n, None) for n in (S // 8, S // 2, S)))
    timings = time_decode_attention(
        torch, S, lm.num_heads, [(4, "bfloat16", n) for n in (S // 8, S // 2, S)],
        torch.Generator("cuda").manual_seed(10), path="audiogen")

    windows = []
    lm_generate = ag._lm_generate

    def recording(prompt_tokens, attributes, max_gen_len):
        windows.append((0 if prompt_tokens is None else prompt_tokens.shape[-1],
                        max_gen_len))
        return lm_generate(prompt_tokens, attributes, max_gen_len)

    ag._lm_generate = recording
    stats = lm_module.decode_graph_stats
    runs, launches_total = {}, 0
    torch.cuda.reset_peak_memory_stats()
    for seconds in AUDIOGEN_SECONDS:
        ag.set_generation_params(duration=seconds)
        ag.set_seed(0)
        windows.clear()
        captures = stats.captures
        decode_attention.launches = 0
        (wav, tokens), request_s = _timed(torch, lambda: ag.generate(
            TEXTS, return_tokens=True))
        launches = decode_attention.launches
        launches_total += launches
        expected = sum(_k1_launches(lm, n, p) for p, n in windows)
        n = seconds * AUDIOGEN_RATE
        _check_generation(torch, f"audiogen {seconds} s", wav, tokens,
                          (2, 1, n * hop), 4, n, launches, expected)
        if stats.captures - captures != len(windows):
            raise AssertionError(f"audiogen: {stats.captures - captures} "
                                 f"decode graphs for {len(windows)} windows")
        runs[f"{seconds}s"] = dict(
            request_s=request_s, audio_s_per_s=len(TEXTS) * seconds / request_s,
            windows=[dict(prompt_frames=p, frames=f) for p, f in windows],
            decode_attention_launches=launches, expected_launches=expected,
            replay_ms_per_step=stats.last_replay_ms_per_step())
    peak = torch.cuda.max_memory_allocated()
    ag._lm_generate = lm_generate
    ag.set_generation_params(duration=1, use_sampling=False)
    shape = _graph_vs_eager(torch, lambda: ag.generate(
        TEXTS, return_tokens=True)[1])
    emit("audiogen", model="audiogen-medium (medium LM: d 1536, 24 heads, 48 "
         "layers, 4 x 2048 codes; T5-large by cross-attention; EnCodec 16 "
         "kHz; seeded random weights, bf16)", card=card, setup_s=setup_s,
         texts=len(TEXTS), runs=runs, max_memory_allocated=peak,
         graph_vs_eager=dict(seconds=1, greedy=True, shape=shape,
                             tokens_equal=True))
    del ag, lm, codec
    torch.cuda.empty_cache()
    return launches_total, k1_worst, timings


STYLE_SECONDS = 10          # of 32 kHz music per style clip, and of music


def phase_style(torch, card):
    """Full-width MusicGen-Style (medium LM, the style tokens of a 3 s
    excerpt through a full-width MERT and T5-base both prepended, EnCodec
    32 kHz; seeded random weights, bf16; MERT f32): 2 texts x 10 s against
    2 clips of 10 s under batched and double CFG and with eval_q 1, after
    K1 is held against its plain version at these requests' heads, rows
    and capacities."""
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.modules.conditioners import (
        ClassifierFreeGuidanceDropout, WavCondition)
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    t0 = time.perf_counter()
    lm = builders.get_musicgen_style_lm(device="cuda", dtype=torch.bfloat16,
                                        seed=0)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    mg = MusicGen("musicgen-style (random weights)", codec, lm, device="cuda")
    style = lm.condition_provider.conditioners["self_wav"]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    frames = STYLE_SECONDS * TOKENS_PER_SECOND
    hop = int(mg.sample_rate // mg.frame_rate)
    clips = _seeded_music(torch, 2, STYLE_SECONDS)          # [2, 1, T]
    eval_q, excerpt = style.eval_q, style.length      # 3, 3 s
    modes = {"batched": ({}, eval_q),
             "double": ({"cfg_coef_beta": 5.0}, eval_q), "eval_q1": ({}, 1)}

    attrs = mg._prepare_tokens_and_attributes(TEXTS, None)[0]
    for a, wav in zip(attrs, clips):
        a.wav["self_wav"] = WavCondition(wav[None], torch.tensor(
            [wav.shape[-1]]), [32000], [None])
    shapes = {mode: _capacities(lm, attrs, frames, False,
                                kw.get("cfg_coef_beta"))
              for mode, (kw, _) in modes.items()}
    k1_worst = {}
    for B, S in sorted({shape for v in shapes.values() for shape in v}):
        cases = tuple((n, None) for n in (max(1, S // 8), S // 2, S))
        for kind, err in check_decode_attention(
                torch, (B,), S, "style", seed=11, H=lm.num_heads,
                kinds=("bfloat16",), cases=cases).items():
            k1_worst[kind] = max(k1_worst.get(kind, 0.0), err)
    B4, S_style = shapes["batched"][0]
    B6 = shapes["double"][0][0]
    timings = time_decode_attention(
        torch, S_style, lm.num_heads,
        [(B4, "bfloat16", n) for n in (S_style // 8, S_style // 2, S_style)]
        + [(B6, "bfloat16", S_style)],
        torch.Generator("cuda").manual_seed(12), path="style")

    stats = lm_module.decode_graph_stats
    runs, launches_total = {}, 0
    torch.cuda.reset_peak_memory_stats()
    for mode, (kw, q) in modes.items():
        mg.set_style_conditioner_params(eval_q=q, excerpt_length=excerpt)
        mg.set_generation_params(duration=STYLE_SECONDS, **kw)
        mg.set_seed(0)
        captures = stats.captures
        decode_attention.launches = 0
        (wav, tokens), seconds = _timed(torch, lambda: mg.generate_with_chroma(
            TEXTS, clips, 32000, return_tokens=True))
        launches = decode_attention.launches
        launches_total += launches
        expected = _k1_launches(lm, frames)
        _check_generation(torch, f"style {mode}", wav, tokens,
                          (2, 1, frames * hop), 4, frames, launches, expected)
        if stats.captures - captures != 1:
            raise AssertionError(f"style {mode}: {stats.captures - captures} "
                                 f"decode graphs captured for one generate")
        runs[mode] = dict(request_s=seconds, eval_q=q,
                          audio_s_per_s=len(TEXTS) * STYLE_SECONDS / seconds,
                          rows=shapes[mode][0][0],
                          capacity=shapes[mode][0][1],
                          decode_attention_launches=launches,
                          expected_launches=expected,
                          replay_ms_per_step=stats.last_replay_ms_per_step(),
                          capture_s=stats.last_capture_s)
    peak = torch.cuda.max_memory_allocated()
    mg.set_style_conditioner_params(eval_q=eval_q, excerpt_length=excerpt)

    # where a batched request's time goes, piece by piece
    mg.set_generation_params(duration=STYLE_SECONDS)
    rows = attrs + ClassifierFreeGuidanceDropout(p=1.0)(attrs)
    provider = lm.condition_provider
    t5 = provider.conditioners["description"]
    with torch.no_grad():
        wavs = provider._collate_wavs(rows)["self_wav"]
        style_tokens, mert_s = _timed(torch, lambda: style.tokenize(wavs))
        _, style_s = _timed(torch, lambda: style(style_tokens))
        text = t5.tokenize([a.text["description"] for a in rows])
        _, t5_s = _timed(torch, lambda: t5(text))
        conditions = lm.compute_conditions(provider.tokenize(rows))
        prefix = lm.fuser.prepend_length(conditions)
        caches = lm.transformer.init_cache(B4, S_style, torch.bfloat16,
                                           "cuda")
        first = torch.full((B4, 4, 1), lm.special_token_id, device="cuda")
        _, prefill_s = _timed(torch, lambda: lm(first, conditions,
                                                caches=caches))
    del caches
    codes, generate_s = _timed(torch, lambda: lm.generate(
        condition_tensors=conditions, num_samples=2, max_gen_len=frames,
        gen=lm_module.GenParams(**mg.generation_params),
        generator=mg.generator, device="cuda"))
    replay_ms = stats.last_replay_ms_per_step()
    _, decode_s = _timed(torch, lambda: mg.generate_audio(codes))
    breakdown = dict(
        resample_mert_s=mert_s,
        resample_mert_note="3 s excerpts of 4 rows to 24 kHz mono, MERT "
                           "(f32) over them",
        style_conditioner_s=style_s,
        style_conditioner_note="embed, 8-layer transformer, batch norm, RVQ "
                               "at eval_q 3, every 15th step, projection",
        t5_s=t5_s, t5_note="T5-base over 4 rows and the projection",
        style_tokens=int(conditions["self_wav"][0].shape[1]),
        text_tokens=int(conditions["description"][0].shape[1]),
        prepend_length=prefix, prefill_s=prefill_s,
        prefill_note=f"one forward of {prefix + 1} steps over {B4} rows",
        generate_s=generate_s, replay_ms_per_step=replay_ms,
        decode_steps=stats.last_replays[2],
        replays_s=replay_ms * stats.last_replays[2] / 1e3,
        codec_decode_s=decode_s)

    def greedy_second():
        mg.set_seed(0)      # the same excerpts for graph and eager steps
        return mg.generate_with_chroma(TEXTS, clips, 32000,
                                       return_tokens=True)[1]

    checked = []
    for kw in ({}, {"cfg_coef_beta": 5.0}):
        mg.set_generation_params(duration=1, use_sampling=False, **kw)
        checked.append(_graph_vs_eager(torch, greedy_second))
    emit("style", model="musicgen-style (medium LM: d 1536, 24 heads, 48 "
         "layers, 4 x 2048 codes; style tokens (MERT of HuBERT-base width, "
         "f32; transformer 8 x 512; RVQ 6 x 1024, eval_q 3; every 15th "
         "step) and T5-base prepended; EnCodec 32 kHz; seeded random "
         "weights, bf16)", card=card, setup_s=setup_s, texts=len(TEXTS),
         audio_s_per_text=STYLE_SECONDS,
         style_audio=f"{STYLE_SECONDS} s of seeded harmonic audio per text, "
                     "32 kHz mono, 3 s excerpt",
         runs=runs, breakdown=breakdown, max_memory_allocated=peak,
         graph_vs_eager=dict(seconds=1, greedy=True,
                             modes=["batched", "double"], shapes=checked,
                             tokens_equal=True))
    del mg, lm, codec, style
    torch.cuda.empty_cache()
    return launches_total, k1_worst, timings


MAGNET_SECONDS = 10


def _profile_kernels(torch, fn, reps: int = 5, top: int = 8):
    """(device ms per call, the `top` kernels by device time per call) of
    `fn` over `reps` calls under `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    ranked = sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:top]
    return device_ms, [{"name": e.key[:80],
                        "ms_per_forward": e.self_device_time_total / 1e3 / reps,
                        "calls_per_forward": e.count / reps} for e in ranked]


def phase_magnet(torch, card):
    """Full-width MAGNeT-small (24 layers of 1024, T5-base by
    cross-attention, EnCodec 32 kHz; seeded random weights, bf16): 2 texts
    x 10 s with the default generation parameters (top-p 0.9 at
    temperature 3, CFG 10 -> 1, [20, 10, 10, 10] steps, non-overlapping
    spans of 3)."""
    from audiocraft_tpu_torch.models import MAGNeT, builders
    from audiocraft_tpu_torch.models import lm as lm_module
    from audiocraft_tpu_torch.modules.conditioners import ConditioningAttributes
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    lm = builders.get_magnet_small_lm(device="cuda", dtype=torch.bfloat16,
                                      seed=0)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    m = MAGNeT("magnet-small (random weights)", codec, lm, max_duration=10,
               device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    events, graphs = [], []

    def stage_done(done, total):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        graphs.append((stats.last_capture_s, stats.last_replays))

    m.set_custom_progress_callback(stage_done)
    m.set_generation_params(duration=MAGNET_SECONDS)   # the defaults else
    frames = lm.span_len * (int(MAGNET_SECONDS * m.frame_rate) // lm.span_len)
    hop = int(m.sample_rate // m.frame_rate)
    stats = lm_module.decode_graph_stats
    generation = dict(m.generation_params)
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):      # the first builds cuBLAS handles and plans
        m.set_seed(0)
        events.clear()
        graphs.clear()
        captures = stats.captures
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        decode_attention.launches = 0
        (wav, tokens), request_s = _timed(torch, lambda: m.generate(
            TEXTS, return_tokens=True))
        marks = [start] + events
        runs.append(dict(request_s=request_s,
                         stage_ms=[a.elapsed_time(b)
                                   for a, b in zip(marks, marks[1:])],
                         capture_s=[c for c, _ in graphs],
                         replay_ms_per_step=[b.elapsed_time(e) / n
                                             for _, (b, e, n) in graphs],
                         graphs_captured=stats.captures - captures))
        if stats.captures - captures != len(events):
            raise AssertionError(f"magnet: {stats.captures - captures} "
                                 f"graphs for {len(events)} stages")
    peak = torch.cuda.max_memory_allocated()
    if tuple(tokens.shape) != (2, 4, frames):
        raise AssertionError(f"magnet: codes shape {tuple(tokens.shape)}, "
                             f"expected (2, 4, {frames})")
    if not (int(tokens.min()) >= 0 and int(tokens.max()) < lm.card):
        raise AssertionError("magnet: codes outside [0, card): a mask token "
                             "is left")
    if tuple(wav.shape) != (2, 1, frames * hop) or not bool(
            torch.isfinite(wav).all()):
        raise AssertionError(f"magnet: waveform {tuple(wav.shape)} or "
                             f"non-finite")
    if decode_attention.launches:
        raise AssertionError("magnet: the decode-attention kernel ran")
    # greedy: the stages' graphs give the eager steps' tokens; both timed
    m.set_generation_params(duration=MAGNET_SECONDS, use_sampling=False)
    greedy, replay = {}, lm_module._replay_decode_steps
    for mode in ("graph", "eager"):
        if mode == "eager":
            lm_module._replay_decode_steps = _eager_decode_steps
        try:
            greedy[mode] = _timed(torch, lambda: m.generate(
                TEXTS, return_tokens=True)[1])
        finally:
            lm_module._replay_decode_steps = replay
    if not torch.equal(greedy["graph"][0], greedy["eager"][0]):
        raise AssertionError("magnet: greedy tokens of the stage graphs and "
                             "of the eager steps differ")

    # one CFG forward (B 4 x 498 steps) of a stage past the first, timed
    # and profiled by kernel
    attrs = [ConditioningAttributes(text={"description": t}) for t in TEXTS]
    conditions = lm.prepare_cfg_conditions(attrs)
    seq = torch.full((4, 4, frames), lm.special_token_id, device="cuda")
    bias = lm.stage_attn_bias(1, frames, "cuda")
    with torch.no_grad():
        forward_ms = {
            "stage_0": time_ms(lambda: lm(seq, conditions), n=20),
            "stage_1_to_3": time_ms(lambda: lm(seq, conditions,
                                               attn_bias=bias), n=20)}
        device_ms, top_kernels = _profile_kernels(
            torch, lambda: lm(seq, conditions, attn_bias=bias))
    n_params = sum(p.numel() for n, p in lm.named_parameters()
                   if not n.startswith("condition_provider"))
    emit("magnet", model="magnet-small (d 1024, 16 heads, 24 layers, 4 x "
         "2048 codes, parallel pattern, non-causal, T5-base by "
         "cross-attention, spans of 3, context +-5 after stage 0; EnCodec "
         "32 kHz; seeded random weights, bf16)", card=card, setup_s=setup_s,
         texts=len(TEXTS), audio_s_per_text=MAGNET_SECONDS,
         generation=generation, codes_shape=list(tokens.shape),
         runs=runs, forwards=sum(m.generation_params["decoding_steps"]),
         forward_ms=forward_ms, forward_rows=4, forward_steps=frames,
         forward_tflop=2 * n_params * 4 * frames / 1e12,
         profiled_device_ms_per_forward=device_ms, top_kernels=top_kernels,
         max_memory_allocated=peak, decode_attention_launches=0,
         graph_vs_eager=dict(greedy=True,
                             shape=list(greedy["graph"][0].shape),
                             tokens_equal=True, graph_s=greedy["graph"][1],
                             eager_s=greedy["eager"][1]))
    del m, lm, codec
    torch.cuda.empty_cache()


MBD_SECONDS = 10           # of MusicGen codes per row (50 Hz, 4 codebooks)
MBD_REGENERATE_SECONDS = 2  # of 44.1 kHz mono audio per row to regenerate
AUDIOSEAL_RATE = 16000
JASCO_SECONDS = 10
JASCO_CHORDS = [("C", 0.0), ("Am", 2.5), ("F", 5.0), ("G", 7.5)]


def _sync_timed(torch, fn, times: list):
    """`fn` wrapped to append the host seconds to the end of its device
    work to `times`."""
    def wrapped(*args, **kwargs):
        out, seconds = _timed(torch, lambda: fn(*args, **kwargs))
        times.append(seconds)
        return out
    return wrapped


def _release(torch) -> int:
    """Collect the cycles earlier phases left (timing wrappers close over
    their modules), empty the allocator's cache, and return the bytes still
    allocated: the base a phase's peak memory sits on."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _card_vs_cpu(name, got, want, rel):
    """max |card - CPU| <= rel * max(1, max |CPU|), else raise."""
    want = want.float().cpu()
    err = float((got.float().cpu() - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not err <= rel * scale:
        raise AssertionError(f"{name}: card vs CPU max |err| {err} > "
                             f"{rel} x {scale}")
    return err


def phase_mbd(torch, card):
    """Multi-Band Diffusion at full width (`solver/diffusion/default` over
    `model/score/basic`, 4 bands at 32 kHz: per band a DiffusionUnet of
    48-192-768-3072 channels with a 3072 BiLSTM, an 8-band processor, 20
    reverse steps; EnCodec 32 kHz; seeded random weights, f32) decodes 2 x
    10 s of seeded MusicGen codes through `tokens_to_wav`, then regenerates
    2 x 2 s of 44.1 kHz audio."""
    import copy

    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.ops.filters import SplitBands
    from audiocraft_tpu_torch.utils.timing import time_ms
    resident = _release(torch)
    t0 = time.perf_counter()
    mbd = builders.get_mbd_32khz(device="cuda", seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    codec = mbd.codec_model
    frames = int(MBD_SECONDS * codec.frame_rate)
    hop = int(codec.sample_rate // codec.frame_rate)
    g = torch.Generator("cuda").manual_seed(4)
    tokens = torch.randint(0, codec.cardinality, (2, codec.num_codebooks,
                                                  frames),
                           device="cuda", generator=g)
    pieces = {"codec_decode": [], "condition": [], "re_eq": []}
    bands = [[] for _ in mbd.DPs]
    codec.decode = _sync_timed(torch, codec.decode, pieces["codec_decode"])
    mbd.get_emb = _sync_timed(torch, mbd.get_emb, pieces["condition"])
    mbd.re_eq = _sync_timed(torch, mbd.re_eq, pieces["re_eq"])
    for DP, times in zip(mbd.DPs, bands):
        DP.generate = _sync_timed(torch, DP.generate, times)
    torch.cuda.reset_peak_memory_stats()
    wav, request_s = _timed(torch, lambda: mbd.tokens_to_wav(tokens))
    peak = torch.cuda.max_memory_allocated()
    if tuple(wav.shape) != (2, 1, frames * hop) or not bool(
            torch.isfinite(wav).all()):
        raise AssertionError(f"mbd: waveform {tuple(wav.shape)} or non-finite")
    # `regenerate` on 2 x 2 s of 44.1 kHz mono music: resampled, encoded,
    # diffused at 32 kHz
    music = _seeded_music(torch, 2, MBD_REGENERATE_SECONDS, 44100)
    regenerated, regenerate_s = _timed(torch, lambda: mbd.regenerate(
        music, 44100))
    expected = int(music.shape[-1] * codec.sample_rate / 44100)
    if tuple(regenerated.shape) != (2, 1, expected) or not bool(
            torch.isfinite(regenerated).all()):
        raise AssertionError(f"mbd: regenerated {tuple(regenerated.shape)} "
                             f"or non-finite")

    # one band's U-Net forward at the request's shape, its BiLSTM alone
    model = mbd.DPs[0].model
    x = torch.randn(2, 1, frames * hop, device="cuda", generator=g)
    emb = mbd.get_emb(tokens)
    downsampling = math.prod(e.stride for e in model.encoders)
    z = torch.randn(2, model.bilstm.linear.out_features,
                    frames * hop // downsampling, device="cuda", generator=g)
    with torch.no_grad():
        forward_ms = time_ms(lambda: model(x, 999, emb), n=3)
        device_ms, top_kernels = _profile_kernels(
            torch, lambda: model(x, 999, emb), reps=2)
        bilstm_ms = time_ms(lambda: model.bilstm(z), n=3)
        re_eq_ms = time_ms(lambda: mbd.re_eq(x, x), n=3)

    # card vs CPU on a 1 s slice: one band's U-Net and the 32-band split
    x1 = x[:1, :, :codec.sample_rate]
    emb1 = emb[:1, :, :int(codec.frame_rate)]
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        unet_err = _card_vs_cpu("mbd U-Net", model(x1, 949, emb1),
                                cpu_model(x1.cpu(), 949, emb1.cpu()), 1e-3)
    split = SplitBands(codec.sample_rate, 32)
    split_err = _card_vs_cpu("mbd SplitBands", split(x1),
                             split(x1.cpu()), 1e-4)
    del cpu_model
    emit("mbd", model="multi-band diffusion (4 bands; DiffusionUnet hidden "
         "48, depth 4, growth 4, kernel 8, stride 4, BiLSTM 3072, codec_dim "
         "128; 8-band processor; 20 of 1000 power-schedule steps; EnCodec 32 "
         "kHz; seeded random weights, f32)", card=card, setup_s=setup_s,
         rows=2, audio_s_per_row=MBD_SECONDS, codes_shape=list(tokens.shape),
         request_s=request_s, audio_s_per_s=2 * MBD_SECONDS / request_s,
         breakdown_s=dict(codec_decode=pieces["codec_decode"][0],
                          condition=pieces["condition"][0],
                          reverse_per_band=[b[0] for b in bands],
                          re_eq=pieces["re_eq"][0]),
         regenerate=dict(rows=2, input_s=MBD_REGENERATE_SECONDS,
                         input_rate=44100, seconds=regenerate_s),
         unet_forwards=20 * len(mbd.DPs), unet_forward_ms=forward_ms,
         bilstm_ms=bilstm_ms, bilstm_share=bilstm_ms / forward_ms,
         profiled_device_ms_per_forward=device_ms, top_kernels=top_kernels,
         re_eq_ms=re_eq_ms,
         unet_params=sum(p.numel() for p in model.parameters()),
         max_memory_allocated=peak, resident_bytes_before_phase=resident,
         card_vs_cpu=dict(unet_max_abs_err=unet_err, unet_rel_tol=1e-3,
                          split_bands_max_abs_err=split_err,
                          split_bands_rel_tol=1e-4, seconds=1))
    del mbd, model, codec
    _release(torch)


def phase_audioseal(torch, card, music):
    """AudioSeal at its base widths (16 bits, SEANet 128 / 32 filters,
    ratios 8-5-4-2, 2 LSTM layers, detector output 32; seeded random
    weights, f32) watermarks 2 x 10 s of the slice phase's MusicGen audio,
    taken to 16 kHz, with a seeded message, then detects it."""
    from audiocraft_tpu_torch.data.audio_utils import convert_audio
    from audiocraft_tpu_torch.models import builders
    from audiocraft_tpu_torch.utils.timing import time_ms
    _release(torch)
    model = builders.get_audioseal_base(device="cuda", seed=0)
    x = convert_audio(music.float(), 32000, AUDIOSEAL_RATE, 1)
    g = torch.Generator("cuda").manual_seed(5)
    message = torch.randint(0, 2, (x.shape[0], model.nbits), device="cuda",
                            generator=g)
    marked, watermark_s = _timed(torch, lambda: model.forward(x, message))
    detected, detect_s = _timed(torch, lambda: model.detect_watermark(marked))
    if tuple(detected.shape) != (x.shape[0], 2 + model.nbits, x.shape[-1]):
        raise AssertionError(f"audioseal: detector output "
                             f"{tuple(detected.shape)}")
    sums = detected[:, :2].sum(dim=1)
    prob_err = float((sums - 1).abs().max())
    if not prob_err < 1e-5:
        raise AssertionError(f"audioseal: probabilities sum off 1 by "
                             f"{prob_err}")
    watermark_ms = time_ms(lambda: model.forward(x, message), n=5)
    detect_ms = time_ms(lambda: model.detect_watermark(marked), n=5)
    cpu = builders.get_audioseal_base(device="cpu", seed=0)
    cpu.generator.load_state_dict(model.generator.state_dict())
    cpu.detector.load_state_dict(model.detector.state_dict())
    gen_err = _card_vs_cpu("audioseal generator", marked,
                           cpu.forward(x.cpu(), message.cpu()), 1e-4)
    det_err = _card_vs_cpu("audioseal detector", detected,
                           cpu.detect_watermark(marked.cpu()), 1e-4)
    emit("audioseal", model="audioseal base widths (seeded random weights, "
         "f32)", card=card, rows=x.shape[0],
         audio_s_per_row=x.shape[-1] / AUDIOSEAL_RATE,
         sample_rate=AUDIOSEAL_RATE, first_call_s=dict(
             watermark=watermark_s, detect=detect_s),
         watermark_ms=watermark_ms, detect_ms=detect_ms,
         detection_prob_sum_err=prob_err,
         card_vs_cpu=dict(generator_max_abs_err=gen_err,
                          detector_max_abs_err=det_err, rel_tol=1e-4))
    del model, cpu
    _release(torch)


def phase_jasco(torch, card):
    """JASCO chords + drums at full width (`solver/jasco/chords_drums` at
    `model_scale/small`: dim 1024, 16 heads, 24 layers, T5-base by
    cross-attention, chords 194 -> 16, drum latents of EnCodec 32 kHz 128
    -> 16; seeded random weights, f32) with a full-width HTDemucs (seeded,
    f32) separating the drums: 2 texts x 10 s with chords and 10 s of drums,
    by Dormand-Prince at cfg_coef_all 5 (the defaults), then 50 Euler
    steps."""
    import copy

    from audiocraft_tpu_torch.models import JASCO, builders
    from audiocraft_tpu_torch.models.jasco import CHORD_MAPPING_PATH
    from audiocraft_tpu_torch.modules.demucs import HTDemucs
    from audiocraft_tpu_torch.utils.timing import time_ms
    resident = _release(torch)
    t0 = time.perf_counter()
    model = builders.get_jasco_chords_drums_model(device="cuda", seed=0)
    codec = builders.get_encodec_32khz(device="cuda", seed=1)
    torch.manual_seed(2)
    separator = HTDemucs().to("cuda").eval()
    model.conditioners["self_wav"].set_separator(separator)
    jasco = JASCO("jasco-chords-drums small (random weights)", codec, model,
                  chords_mapping_path=CHORD_MAPPING_PATH, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    drums = _seeded_music(torch, 1, JASCO_SECONDS, jasco.sample_rate)[0]
    pieces = {"tokenize": [], "conditions": [], "decode": []}
    jasco._tokenize = _sync_timed(torch, jasco._tokenize, pieces["tokenize"])
    compute, last = model.compute_conditions, {}

    def compute_conditions(tokenized):
        out, seconds = _timed(torch, lambda: compute(tokenized))
        pieces["conditions"].append(seconds)
        last["conditions"] = out
        return out

    model.compute_conditions = compute_conditions
    decoder = codec.decoder
    decoder.forward = _sync_timed(torch, decoder.forward, pieces["decode"])
    evaluations = [0]
    model.register_forward_pre_hook(
        lambda *_: evaluations.__setitem__(0, evaluations[0] + 1))
    runs = {}
    for solver, kw in (("dopri5", {}), ("euler", {"euler": True})):
        jasco.set_generation_params(duration=JASCO_SECONDS, **kw)
        for times in pieces.values():
            times.clear()
        evaluations[0] = 0
        torch.cuda.reset_peak_memory_stats()
        (wav, latents), request_s = _timed(torch, lambda: jasco.generate(
            TEXTS, chords=JASCO_CHORDS, drums_wav=drums, return_tokens=True))
        if tuple(wav.shape) != (2, 1, JASCO_SECONDS * jasco.sample_rate) \
                or not bool(
                torch.isfinite(wav).all()):
            raise AssertionError(f"jasco {solver}: waveform "
                                 f"{tuple(wav.shape)} or non-finite")
        split = {k: v[0] for k, v in pieces.items()}
        runs[solver] = dict(
            request_s=request_s, function_evaluations=evaluations[0],
            breakdown_s=dict(split, solve=request_s - sum(split.values())),
            latents_shape=list(latents.shape),
            max_memory_allocated=torch.cuda.max_memory_allocated())
    if runs["euler"]["function_evaluations"] != 50:
        raise AssertionError("jasco: the Euler path did not take 50 steps")

    # one vector-field evaluation at B 4 x 500 (2 texts x 2 CFG terms), on
    # the conditions of the last request
    conditions = last["conditions"]
    rows = int(conditions["description"][0].shape[0])
    frames = int(JASCO_SECONDS * jasco.frame_rate)
    z = torch.randn(rows, frames, model.flow_dim, device="cuda")
    t = torch.full((rows,), 0.5, device="cuda")
    with torch.no_grad():
        forward_ms = time_ms(lambda: model(z, t, conditions), n=10)
        device_ms, top_kernels = _profile_kernels(
            torch, lambda: model(z, t, conditions), reps=3)
        # card vs CPU, f32, on a short sequence of the same conditions
        cpu_model = copy.deepcopy(model).cpu()
        cpu_conditions = {k: (c.cpu(), m.cpu()) for k, (c, m)
                          in conditions.items()}
        short = z[:, :50]
        err = _card_vs_cpu("jasco FlowMatchingModel",
                           model(short, t, conditions),
                           cpu_model(short.cpu(), t.cpu(), cpu_conditions),
                           1e-4)
    del cpu_model
    n_params = sum(p.numel() for n, p in model.named_parameters()
                   if not n.startswith("condition_provider"))
    emit("jasco", model="jasco chords+drums (solver/jasco/chords_drums at "
         "model_scale/small: dim 1024, 16 heads, 24 layers, FFN 4096, skips, "
         "pre-norm, flow 128 + chords 16 + drums 16; T5-base by "
         "cross-attention; EnCodec 32 kHz; HTDemucs drum separation; seeded "
         "random weights, f32)", card=card, setup_s=setup_s, texts=len(TEXTS),
         audio_s_per_text=JASCO_SECONDS, chords=JASCO_CHORDS,
         cfg_coef_all=5.0, cfg_terms=rows // len(TEXTS), runs=runs,
         forward_ms=forward_ms, forward_rows=rows,
         profiled_device_ms_per_forward=device_ms, top_kernels=top_kernels,
         forward_frames=frames, forward_tflop=2 * n_params * z.shape[0]
         * frames / 1e12, flow_params=n_params,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(forward_max_abs_err=err, rel_tol=1e-4, frames=50))
    del jasco, model, codec, decoder, separator, compute
    _release(torch)


LOADERS_SECONDS = 1          # of greedy tokens per text from the loaded LM
LOADERS_WAV_TOL = 1e-4       # relative to max(1, max |in-memory decode|)
MBD_TRAIN_BATCHES = (128, 64, 32, 16)   # solver/diffusion's; the largest
MBD_TRAIN_SECONDS = 1        # fitting one card is taken
MBD_TRAIN_STEPS = 5
MBD_CHECK_ROWS = 2
MBD_LOSS_RTOL = 1e-4         # card vs CPU, f32, no TF32
# The U-Net's gradients are held card against CPU in f64, on the same
# noisy input, step, condition and target. In f32 the two devices' sums
# round apart by about 6e-8 and the deepest layers' gradients (the codec
# condition's 1x1 conv, the last encoder) amplify that to 4e-4 - 1.1e-3 of
# their norm from run to run on an H100; in f64 the same amplification
# leaves about 1e-12, so a disagreement of the ops themselves stands out
# far above it. The f32 drift is reported beside it.
MBD_F64_LOSS_RTOL = 1e-10    # card vs CPU, f64
MBD_GRAD_TOL = 1e-8          # |card - CPU| / |CPU| per parameter (L2), f64
JASCO_TRAIN_BATCH = 16       # cut from solver/jasco's 128 to fit one card
JASCO_TRAIN_SECONDS = 10
JASCO_TRAIN_STEPS = 5
JASCO_CHECK_SECONDS = 2      # of the 2 rows held card against CPU
JASCO_LOSS_RTOL = 1e-4


def _packages_dir() -> Path:
    """Where the loaders phase writes its packages: under the checkout's
    `build/`, which git ignores."""
    path = Path(__file__).resolve().parent / "build" / "smoke_packages"
    path.mkdir(parents=True, exist_ok=True)
    return path


def phase_loaders(torch, card):
    """Checkpoint loading at full width: MusicGen-small saved as upstream
    does (its state dict without the T5 encoder's keys, f32, seeded port
    weights) loads through `loaders.load_lm_model` and, with the in-memory
    model's T5 weights, greedy-generates its tokens through K1; the seeded
    EnCodec 32 kHz saved as `compression_state_dict.bin` and as a Hugging
    Face snapshot (HF names, weight-normed, `model.safetensors` written by
    the port's numpy writer) decodes those tokens to the in-memory codec's
    waveform. Returns (K1 launches, the codec package's directory)."""
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.models import MusicGen, builders, loaders
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.utils import safetensors
    root = _packages_dir()
    cfg = load_config("solver/musicgen/default")
    lm = builders.get_lm_model(cfg, device="cuda", seed=7)
    lm.reset_parameters(7)
    t5_prefix = "condition_provider.conditioners.description.t5."
    state = {k: v for k, v in lm.state_dict().items()
             if not k.startswith(t5_prefix)}
    (root / "lm").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    torch.save({"best_state": state, "xp.cfg": cfg},
               root / "lm" / "state_dict.bin")
    save_s = time.perf_counter() - t0
    del state
    (loaded, _), lm_load_s = _timed(torch, lambda: loaders.load_lm_model(
        str(root / "lm"), device="cuda"))
    t5 = loaded.condition_provider.conditioners["description"].t5
    t5.load_state_dict(lm.condition_provider.conditioners["description"]
                       .t5.state_dict())

    codec = builders.get_encodec_32khz(device="cuda", seed=3)
    codec_cfg = {"compression_model": "encodec", "sample_rate": 32000,
                 "channels": 1, "seanet": {
                     "dimension": 128, "n_filters": 64, "n_residual_layers": 1,
                     "ratios": [8, 5, 4, 4], "lstm": 2, "norm": "none"},
                 "rvq": {"n_q": 4, "bins": 2048}}
    (root / "codec").mkdir(exist_ok=True)
    torch.save({"best_state": codec.state_dict(), "xp.cfg": codec_cfg},
               root / "codec" / "compression_state_dict.bin")
    (root / "hf").mkdir(exist_ok=True)
    (root / "hf" / "config.json").write_text(json.dumps({
        "model_type": "encodec", "sampling_rate": 32000, "audio_channels": 1,
        "hidden_size": 128, "num_filters": 64, "num_residual_layers": 1,
        "upsampling_ratios": [8, 5, 4, 4], "codebook_size": 2048,
        "num_lstm_layers": 2, "use_conv_shortcut": False,
        "use_causal_conv": False, "norm_type": "weight_norm",
        "normalize": False, "kernel_size": 7, "last_kernel_size": 7,
        "residual_kernel_size": 3, "dilation_growth_rate": 2}))
    safetensors.save_file(loaders.hf_encodec_state_dict(codec),
                          root / "hf" / "model.safetensors")
    package_codec, codec_load_s = _timed(torch, lambda: loaders
                                         .load_compression_model(
                                             str(root / "codec"), device="cuda"))
    hf_codec, hf_load_s = _timed(torch, lambda: loaders.load_compression_model(
        str(root / "hf"), device="cuda"))

    tokens = {}
    decode_attention.launches = 0
    for name, model in (("in_memory", lm), ("loaded", loaded)):
        mg = MusicGen(f"musicgen-small {name} (random weights)", codec, model,
                      device="cuda")
        mg.set_generation_params(duration=LOADERS_SECONDS, use_sampling=False)
        (_, tokens[name]), _ = _timed(torch, lambda: mg.generate(
            TEXTS, return_tokens=True))
    launches = decode_attention.launches
    frames = LOADERS_SECONDS * TOKENS_PER_SECOND
    expected = 2 * _k1_launches(lm, frames)
    if launches != expected:
        raise AssertionError(f"loaders: decode_attention launched {launches} "
                             f"times, expected {expected}")
    if tuple(tokens["loaded"].shape) != (2, 4, frames) or not torch.equal(
            tokens["loaded"], tokens["in_memory"]):
        raise AssertionError("loaders: the loaded package's greedy tokens "
                             "differ from the in-memory model's")
    want = codec.decode(tokens["in_memory"], device="cuda")
    errors = {name: _card_vs_cpu(f"loaders {name} decode",
                                 model.decode(tokens["in_memory"],
                                              device="cuda"), want,
                                 LOADERS_WAV_TOL)
              for name, model in (("compression_state_dict", package_codec),
                                  ("hugging_face", hf_codec))}
    emit("loaders", card=card, lm="solver/musicgen/default (MusicGen-small: "
         "T5-base, 24 layers, d 1024; seeded random weights, f32), saved "
         "without its T5 keys", lm_package_bytes=(root / "lm" /
                                                  "state_dict.bin").stat().st_size,
         lm_save_s=save_s, lm_load_s=lm_load_s,
         codec_package_load_s=codec_load_s, hf_snapshot_load_s=hf_load_s,
         texts=len(TEXTS), audio_s_per_text=LOADERS_SECONDS,
         tokens_equal=True, k1_launches=launches,
         decode_max_abs_err=errors,
         decode_tolerance=f"{LOADERS_WAV_TOL} x max(1, max |in-memory|)")
    (root / "lm" / "state_dict.bin").unlink()
    del lm, loaded, codec, package_codec, hf_codec, t5
    _release(torch)
    return launches, root / "codec"


def _on(tree, device):
    """Tensors of a tokenized batch (dicts, tuples, named tuples) moved."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_on(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.to(device) if hasattr(tree, "to") and hasattr(
        tree, "device") else tree


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def phase_mbd_train(torch, card, codec_dir):
    """Multi-Band Diffusion training at the widths of
    `solver/diffusion/default` (a DiffusionUnet of 48-192-768-3072 channels
    with a 3072 BiLSTM and a 128-dim codec condition; 1000 schedule steps;
    the 8-band processor) at 32 kHz, its frozen codec the loaders phase's
    `compression_state_dict.bin`: 1 s segments at the largest batch of
    128 / 64 / 32 / 16 that fits, 5 `run_step`s, then card against CPU on
    2 rows with injected draws."""
    import copy
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.solvers import diffusion as tdiff
    from audiocraft_tpu_torch.solvers import get_solver
    resident = _release(torch)
    cfg = load_config("solver/diffusion/default")
    cfg.update(sample_rate=32000, compression_model_checkpoint=str(codec_dir))
    solver, setup_s = _timed(torch, lambda: get_solver(cfg, device="cuda"))
    segment = MBD_TRAIN_SECONDS * solver.sample_rate
    audio = _seeded_music(torch, MBD_TRAIN_BATCHES[0], MBD_TRAIN_SECONDS)
    # the largest batch whose step fits: a step that runs out of memory
    # leaves the weights as they were (Adam steps after the backward)
    batch, refused = None, []
    for rows in MBD_TRAIN_BATCHES:
        try:
            solver.run_step(0, audio[:rows], {})
            torch.cuda.synchronize()
            batch = rows
            break
        except RuntimeError as e:  # torch's or cuDNN's allocation failure
            if "out of memory" not in str(e) and "ALLOC" not in str(e):
                raise
            refused.append(rows)
            solver.optimizer.zero_grad(set_to_none=True)
            _release(torch)
    if batch is None:
        raise AssertionError("mbd_train: no batch of 16 or more fits")
    x = audio[:batch]
    condition_s = []
    solver.get_condition = _sync_timed(torch, solver.get_condition, condition_s)
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for idx in range(MBD_TRAIN_STEPS):
        metrics, seconds = _timed(torch, lambda: solver.run_step(idx, x, {}))
        step_s.append(seconds)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mbd_train: loss {losses}")
    # the U-Net's forward and backward at the step's shapes, and its BiLSTM's
    model = solver.model
    condition = solver.get_condition(x)
    item = solver.schedule.get_training_item(x, solver._rng)
    seen = {}
    hook = model.bilstm.register_forward_hook(
        lambda m, args, out: seen.setdefault("z", args[0].detach()))

    def unet_pass():
        model(item.noisy, item.step, condition).square().mean().backward()

    def bilstm_pass():
        z = seen["z"].requires_grad_(True)
        model.bilstm(z).square().mean().backward()

    _, unet_s = _timed(torch, unet_pass)
    hook.remove()
    _, unet_s = _timed(torch, unet_pass)
    _, bilstm_s = _timed(torch, bilstm_pass)
    solver.optimizer.zero_grad(set_to_none=True)

    # card vs CPU on 2 rows: the same weights, statistics and draws; the
    # f32 loss through the processor and schedule, then the U-Net's loss
    # and gradients in f64 on the f32 pass's card inputs
    rows = x[:MBD_CHECK_ROWS]
    g = torch.Generator().manual_seed(6)
    draws = dict(ref_noise=torch.randn(rows.shape, generator=g),
                 step=torch.randint(0, solver.num_steps, (MBD_CHECK_ROWS,),
                                    generator=g),
                 noise=torch.randn(rows.shape, generator=g))
    cond_rows = solver.get_condition(rows)
    item = solver.schedule.get_training_item(
        rows, step=draws["step"].to(rows.device),
        noise=draws["noise"].to(rows.device))
    solver.optimizer.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    results = {}
    for device in ("cuda", "cpu"):
        net = model if device == "cuda" else copy.deepcopy(model).cpu()
        schedule = copy.deepcopy(solver.schedule)
        schedule.sample_processor = schedule.sample_processor.to(device)
        net.zero_grad(set_to_none=True)
        loss, _, _ = tdiff.diffusion_loss(
            net, schedule, rows.to(device), cond_rows.to(device),
            update_processor=False,
            **{k: v.to(device) for k, v in draws.items()})
        loss.backward()
        f32 = (loss.item(), _grads(net))
        net.zero_grad(set_to_none=True)
        if device == "cuda":
            net = copy.deepcopy(model)
        net = net.double().train()
        f64 = [t.to(device, torch.float64)
               for t in (item.noisy, item.noise, cond_rows)]
        loss = (f64[1] - net(f64[0], item.step.to(device), f64[2])
                ).square().mean()
        loss.backward()
        results[device] = (f32, (loss.item(), _grads(net)))
        del net
    check_s = time.perf_counter() - t0
    solver.optimizer.zero_grad(set_to_none=True)
    (f32_cuda, f64_cuda), (f32_cpu, f64_cpu) = results["cuda"], results["cpu"]
    loss_err = abs(f32_cuda[0] - f32_cpu[0])
    if not loss_err <= MBD_LOSS_RTOL * abs(f32_cpu[0]):
        raise AssertionError(f"mbd_train: card loss {f32_cuda[0]} vs "
                             f"CPU {f32_cpu[0]}")
    f64_loss_err = abs(f64_cuda[0] - f64_cpu[0])
    if not f64_loss_err <= MBD_F64_LOSS_RTOL * abs(f64_cpu[0]):
        raise AssertionError(f"mbd_train: card f64 loss {f64_cuda[0]} vs "
                             f"CPU {f64_cpu[0]}")

    def rel_l2(got, want):
        return float((got.cpu() - want).norm() / want.norm().clamp_min(1e-30))

    f32_err, f32_worst = max((rel_l2(f32_cuda[1][n], want), n)
                             for n, want in f32_cpu[1].items())
    grad_err, worst = 0.0, ""
    for name, want in f64_cpu[1].items():
        err = rel_l2(f64_cuda[1][name], want)
        if not err <= MBD_GRAD_TOL:
            raise AssertionError(f"mbd_train: f64 gradient of {name} differs "
                                 f"by {err} of its norm card vs CPU")
        grad_err, worst = max((grad_err, worst), (err, name))
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    emit("mbd_train", card=card, config="solver/diffusion/default + "
         "sample_rate=32000 (DiffusionUnet hidden 48, depth 4, growth 4, "
         "BiLSTM 3072, codec_dim 128; 1000 steps; 8-band processor; f32, "
         "Adam 2e-4; seeded random weights)", codec_package=str(codec_dir),
         batch=batch, batches_refused_out_of_memory=refused,
         batch_cut_from=MBD_TRAIN_BATCHES[0],
         seconds_per_item=MBD_TRAIN_SECONDS, samples_per_item=segment,
         setup_s=setup_s, step_s=step_s, steady_step_s=steady,
         audio_s_per_s=batch * MBD_TRAIN_SECONDS / steady,
         condition_codec_s=condition_s[:MBD_TRAIN_STEPS],
         unet_forward_backward_s=unet_s, bilstm_forward_backward_s=bilstm_s,
         bilstm_share=bilstm_s / unet_s, loss=losses,
         processor_counts=float(solver.sample_processor.counts),
         unet_params=sum(p.numel() for p in model.parameters()),
         max_memory_allocated=peak, peak_gb=peak / 1e9,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(rows=MBD_CHECK_ROWS, seconds=check_s,
                          loss_cuda=f32_cuda[0], loss_cpu=f32_cpu[0],
                          loss_abs_err=loss_err, loss_rtol=MBD_LOSS_RTOL,
                          f32_max_grad_rel_l2_err=f32_err,
                          f32_worst_parameter=f32_worst,
                          f64_loss_abs_err=f64_loss_err,
                          f64_loss_rtol=MBD_F64_LOSS_RTOL,
                          max_grad_rel_l2_err=grad_err,
                          worst_parameter=worst,
                          grad_tol=f"|card - CPU| <= {MBD_GRAD_TOL} x |CPU| "
                                   f"(L2) per parameter, f64"))
    del solver, model, results, item, condition, audio, x
    _release(torch)


def phase_jasco_train(torch, card, codec_dir):
    """JASCO training at smoke-jasco's model (`solver/jasco/chords_drums` at
    `model_scale/small`, as `get_jasco_chords_drums_model` builds it; T5-base;
    f32, AdamW) over the loaders phase's EnCodec 32 kHz package, with a
    full-width HTDemucs separating each row's drums from its `self_wav`:
    16 rows of 10 s with seeded frame chords, 5 `run_step`s, then card
    against CPU on 2 rows of 2 s with injected t and z0."""
    import copy
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.data import AudioMeta, JascoInfo
    from audiocraft_tpu_torch.modules.conditioners import (SymbolicCondition,
                                                           WavCondition)
    from audiocraft_tpu_torch.modules.demucs import HTDemucs
    from audiocraft_tpu_torch.solvers import get_solver
    from audiocraft_tpu_torch.solvers import jasco as tjasco
    resident = _release(torch)
    cfg = load_config("solver/jasco/chords_drums")
    cfg["transformer_lm"].update(
        load_config("model/lm/model_scale/small")["transformer_lm"])
    cfg["compression_model_checkpoint"] = str(codec_dir)
    t0 = time.perf_counter()
    solver = get_solver(cfg, device="cuda")
    torch.manual_seed(2)
    drums = solver.model.conditioners["self_wav"]
    drums.set_separator(HTDemucs().to("cuda").eval())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    B, sr = JASCO_TRAIN_BATCH, solver.compression_model.sample_rate
    wav = _seeded_music(torch, B, JASCO_TRAIN_SECONDS, sr)
    frames = int(JASCO_TRAIN_SECONDS * solver.compression_model.frame_rate)
    g = torch.Generator().manual_seed(7)
    meta = AudioMeta(path="seeded.wav", duration=JASCO_TRAIN_SECONDS,
                     sample_rate=sr)

    def infos(rows, seconds):
        n = seconds * sr
        return [JascoInfo(
            meta=meta, seek_time=0.0, n_frames=n, total_frames=n,
            sample_rate=sr, channels=1, description=f"{TEXTS[i % 2]}, take {i}",
            self_wav=WavCondition(rows[i:i + 1, :, :n], torch.tensor([n]),
                                  [sr], [None]),
            chords=SymbolicCondition(frame_chords=torch.randint(
                0, 194, (int(seconds * solver.compression_model.frame_rate),),
                generator=g).numpy()))
            for i in range(rows.shape[0])]

    batch = (wav, infos(wav, JASCO_TRAIN_SECONDS))
    pieces = {"drums": [], "latents": [], "tokenize": []}
    drums.tokenize = _sync_timed(torch, drums.tokenize, pieces["drums"])
    solver.get_latents = _sync_timed(torch, solver.get_latents,
                                     pieces["latents"])
    solver._tokenize_batch = _sync_timed(torch, solver._tokenize_batch,
                                         pieces["tokenize"])
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for idx in range(JASCO_TRAIN_STEPS):
        metrics, seconds = _timed(torch, lambda: solver.run_step(idx, batch,
                                                                 {}))
        step_s.append(seconds)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"jasco_train: loss {losses}")
    splits = [dict(separation_and_drum_latents=d, latents=lt,
                   tokenize_rest=tk - d - lt, train_step=s - tk)
              for d, lt, tk, s in zip(pieces["drums"], pieces["latents"],
                                      pieces["tokenize"], step_s)]

    # card vs CPU on 2 rows of 2 s: the same conditions, t and z0
    short = wav[:2, :, :JASCO_CHECK_SECONDS * sr]
    latents, tokenized = solver._tokenize_batch(short, infos(
        short, JASCO_CHECK_SECONDS))
    draws = dict(t=torch.rand((2,), generator=g),
                 z0=torch.randn(latents.shape, generator=g))
    losses_check = {}
    for device in ("cuda", "cpu"):
        model = solver.model if device == "cuda" else copy.deepcopy(
            solver.model).cpu()
        with torch.no_grad():
            losses_check[device] = float(tjasco.flow_matching_loss(
                model, latents.to(device), _on(tokenized, device),
                **{k: v.to(device) for k, v in draws.items()}))
        del model
    loss_err = abs(losses_check["cuda"] - losses_check["cpu"])
    if not loss_err <= JASCO_LOSS_RTOL * abs(losses_check["cpu"]):
        raise AssertionError(f"jasco_train: card loss {losses_check['cuda']} "
                             f"vs CPU {losses_check['cpu']}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    emit("jasco_train", card=card, config="solver/jasco/chords_drums at "
         "model/lm/model_scale/small (dim 1024, 16 heads, 24 layers; T5-base; "
         "chords 194 -> 16, drum latents 128 -> 16; f32, AdamW 1e-4; seeded "
         "random weights) + HTDemucs drums", codec_package=str(codec_dir),
         batch=B, batch_cut_from=128, seconds_per_item=JASCO_TRAIN_SECONDS,
         frames=frames, setup_s=setup_s, step_s=step_s, steady_step_s=steady,
         split_s=splits, audio_s_per_s=B * JASCO_TRAIN_SECONDS / steady,
         loss=losses, max_memory_allocated=peak, peak_gb=peak / 1e9,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(rows=2, seconds=JASCO_CHECK_SECONDS,
                          loss_cuda=losses_check["cuda"],
                          loss_cpu=losses_check["cpu"], loss_abs_err=loss_err,
                          loss_rtol=JASCO_LOSS_RTOL))
    del solver, drums, batch, wav, tokenized, latents
    _release(torch)


CODEC_TRAIN_BATCHES = (64, 32, 16)  # the config's 64, else the largest
CODEC_TRAIN_SECONDS = 1            # of 32 and 16 that fits
CODEC_TRAIN_STEPS = 5
CODEC_CHECK_ROWS = 2
CODEC_LOSS_RTOL = 1e-4             # card vs CPU, f32, no TF32
CODEC_GRAD_TOL = 1e-3              # |card - CPU| / |CPU| per parameter (L2)


def _mark_end(torch, obj, name: str, marks: dict, key: str) -> None:
    """Wrap `obj.name` to record a CUDA event in `marks[key]` when it
    returns (no synchronisation)."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks[key] = event
        return out
    setattr(obj, name, wrapped)


def phase_codec_train(torch, card):
    """EnCodec GAN training at the width of the codec MusicGen-small decodes
    with: `solver/compression/encodec_musicgen_32khz` with
    `encodec.seanet.ratios=[8,5,4,4]` (32 kHz, 64 filters, dimension 128,
    2 LSTM layers, 4 x 2048 k-means codebooks, 50 Hz), the config's losses
    (adv 4, feat 4, l1 0.1, msspec 2; mel and SI-SNR as information), the
    balancer, the MS-STFT discriminator (5 scales, 32 filters), f32, seeded
    weights: 1 s clips at the config's batch of 64 (else 32, else 16), 5
    `run_step`s, k-means on the first and dead-code expiry on every step;
    the device ms of each step split into the generator's forward, the
    discriminator update, the balanced losses with their gradients, and
    the generator's backward with Adam (and the information losses); then
    two steps on 2 rows card against CPU from the same state (with the
    discriminator's update, and without), and the saved checkpoint read
    back as a `compression_model_checkpoint`."""
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.solvers import builders as solver_builders
    from audiocraft_tpu_torch.solvers import get_solver
    phase_t0 = time.perf_counter()
    resident = _release(torch)
    cfg = load_config("solver/compression/encodec_musicgen_32khz")
    cfg["encodec"]["seanet"]["ratios"] = [8, 5, 4, 4]
    folder = _packages_dir() / "codec_train"
    cfg["folder"] = str(folder)
    audio = _seeded_music(torch, CODEC_TRAIN_BATCHES[0], CODEC_TRAIN_SECONDS)
    # the largest batch whose first step fits; a step that runs out of
    # memory may have moved the codebooks, so each try starts a new solver
    batch, refused, solver = None, [], None
    for rows in CODEC_TRAIN_BATCHES:
        solver, setup_s = _timed(torch, lambda: get_solver(cfg, device="cuda"))
        x = audio[:rows]
        try:
            first, first_s = _timed(torch, lambda: solver.run_step(0, x, {}))
            batch = rows
            break
        except RuntimeError as e:  # torch's or cuDNN's allocation failure
            if "out of memory" not in str(e) and "ALLOC" not in str(e):
                raise
            refused.append(rows)
            solver = None
            _release(torch)
    if batch is None:
        raise AssertionError("codec_train: no batch of 16 or more fits")
    codebooks = [layer._codebook for layer in solver.model.quantizer.vq.layers]
    expired = [[int(c.last_expired) for c in codebooks]]
    marks: dict = {}
    _mark_end(torch, solver.model, "forward", marks, "forward")
    for adversary in solver.adv_losses.values():
        _mark_end(torch, adversary, "train_adv", marks, "disc")
    _mark_end(torch, solver.balancer, "backward", marks, "balanced")
    torch.cuda.reset_peak_memory_stats()
    step_s, split_ms, history = [first_s], [], [first]
    for idx in range(1, CODEC_TRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics, seconds = _timed(torch, lambda: solver.run_step(idx, x, {}))
        end.record()
        end.synchronize()
        step_s.append(seconds)
        history.append(metrics)
        expired.append([int(c.last_expired) for c in codebooks])
        split_ms.append(dict(
            generator_forward=start.elapsed_time(marks["forward"]),
            discriminator_update=marks["forward"].elapsed_time(marks["disc"]),
            balanced_losses_and_grads=marks["disc"].elapsed_time(
                marks["balanced"]),
            generator_backward_adam_info=marks["balanced"].elapsed_time(end)))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: [float(m[k]) for m in history] for k in history[0]}
    if not all(math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"codec_train: losses {losses}")
    inited = sum(int(c.inited.item()) for c in codebooks)
    if inited != len(codebooks):
        raise AssertionError(f"codec_train: {inited} of {len(codebooks)} "
                             f"codebooks inited after k-means")

    # card vs CPU on 2 rows, each side from the same state and draws: a
    # step with the discriminator's update (the losses before it, and the
    # discriminator's weights after it within 2 x lr: Adam's normalised
    # step amplifies f32 rounding of its gradient), then a step without it
    # (every loss and every gradient)
    import copy
    rows = x[:CODEC_CHECK_ROWS]
    snapshot = copy.deepcopy(solver.state_dict())
    cpu = get_solver({k: v for k, v in cfg.items() if k != "folder"},
                     device="cpu")
    lr = float(cfg["optim"]["lr"])
    results, disc_err = {}, 0.0
    for mode, every in (("with_update", 1), ("without_update", math.inf)):
        for name, s in (("cuda", solver), ("cpu", cpu)):
            s.load_state_dict(copy.deepcopy(snapshot))
            s.disc_every = every
            m = s.run_step(CODEC_TRAIN_STEPS, rows.to(s.device), {})
            results[mode, name] = (
                {k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu()
                 for n, p in s.model.named_parameters()},
                {k: v.detach().cpu() for k, v in
                 s.adv_losses["msstftd"].adversary.state_dict().items()})
            s.disc_every = 1
    updated = ("bandwidth", "penalty", "d_msstftd", "d_loss", "l1", "msspec",
               "mel", "sisnr")
    loss_err, worst_loss = 0.0, ""
    for mode, keys in (("with_update", updated),
                       ("without_update", results["without_update", "cpu"][0])):
        for key in keys:
            want = results[mode, "cpu"][0][key]
            err = abs(results[mode, "cuda"][0][key] - want)
            if not err <= CODEC_LOSS_RTOL * abs(want) + 1e-6:
                raise AssertionError(
                    f"codec_train: {mode} card {key} "
                    f"{results[mode, 'cuda'][0][key]} vs CPU {want}")
            rel = err / max(abs(want), 1e-30)
            loss_err, worst_loss = max((loss_err, worst_loss),
                                       (rel, f"{mode} {key}"))
    for name, want in results["with_update", "cpu"][2].items():
        err = float((results["with_update", "cuda"][2][name] - want).abs().max())
        if not err <= 2 * lr:
            raise AssertionError(f"codec_train: discriminator {name} moved "
                                 f"{err} apart card vs CPU (> 2 x lr)")
        disc_err = max(disc_err, err)
    after_update = {k: abs(results["with_update", "cuda"][0][k] - v)
                    / max(abs(v), 1e-30)
                    for k, v in results["with_update", "cpu"][0].items()
                    if k not in updated}
    grad_err, worst = 0.0, ""
    for name, want in results["without_update", "cpu"][1].items():
        err = float((results["without_update", "cuda"][1][name] - want).norm()
                    / want.norm().clamp_min(1e-30))
        if not err <= CODEC_GRAD_TOL:
            raise AssertionError(f"codec_train: gradient of {name} differs "
                                 f"by {err} of its norm card vs CPU")
        grad_err, worst = max((grad_err, worst), (err, name))
    del cpu, snapshot

    # the checkpoint, read back as a solver's frozen codec
    save_s = _timed(torch, solver.save_checkpoints)[1]
    ckpt_bytes = solver.checkpoint_path().stat().st_size
    codec, load_s = _timed(torch, lambda: solver_builders
                           .compression_model_from_checkpoint(str(folder),
                                                              "cuda"))
    solver.model.eval()
    codes, scale = solver.model.encode(rows, device="cuda")
    got_codes, got_scale = codec.encode(rows, device="cuda")
    if not torch.equal(codes, got_codes) or (scale, got_scale) != (None, None):
        raise AssertionError("codec_train: the loaded codec's codes differ")
    wav_err = float((codec.decode(codes, device="cuda")
                     - solver.model.decode(codes, device="cuda")).abs().max())
    if wav_err != 0.0:
        raise AssertionError(f"codec_train: the loaded codec decodes "
                             f"{wav_err} away from the trained one")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    emit("codec_train", card=card, config="solver/compression/"
         "encodec_musicgen_32khz + encodec.seanet.ratios=[8,5,4,4] (32 kHz, "
         "64 filters, dimension 128, LSTM 2, 4 x 2048 k-means codebooks, "
         "50 Hz; adv 4, feat 4, l1 0.1, msspec 2, mel and sisnr as "
         "information; balancer on; MS-STFT 5 scales x 32 filters; f32, "
         "Adam(0.5, 0.9) 3e-4; seeded random weights)",
         batch=batch, batches_refused_out_of_memory=refused,
         seconds_per_item=CODEC_TRAIN_SECONDS, setup_s=setup_s,
         step_s=step_s, steady_step_s=steady,
         audio_s_per_s=batch * CODEC_TRAIN_SECONDS / steady,
         split_ms_steps_2_to_5=split_ms,
         split_ms_median={k: sorted(d[k] for d in split_ms)[len(split_ms) // 2]
                          for k in split_ms[0]},
         losses_first_to_last={k: [v[0], v[-1]] for k, v in losses.items()},
         codebooks_inited=f"{inited} of {len(codebooks)}",
         codes_expired_per_step=expired,
         generator_params=sum(p.numel() for p in solver.model.parameters()),
         discriminator_params=sum(
             p.numel() for a in solver.adv_losses.values()
             for p in a.adversary.parameters()),
         max_memory_allocated=peak, peak_gb=peak / 1e9,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(rows=CODEC_CHECK_ROWS,
                          max_loss_rel_err=loss_err, worst_loss=worst_loss,
                          loss_rtol=CODEC_LOSS_RTOL,
                          discriminator_max_abs_err_after_update=disc_err,
                          discriminator_tol="2 x lr",
                          rel_err_of_losses_after_the_update=after_update,
                          max_grad_rel_l2_err=grad_err,
                          worst_parameter=worst,
                          grad_tol=f"|card - CPU| <= {CODEC_GRAD_TOL} x |CPU| "
                                   f"(L2) per parameter"),
         checkpoint_bytes=ckpt_bytes, checkpoint_save_s=save_s,
         checkpoint_load_s=load_s, loaded_codes_equal=True,
         loaded_decode_max_abs_err=wav_err,
         phase_s=time.perf_counter() - phase_t0)
    del solver, codec, audio, x, rows, results
    _release(torch)


WATERMARK_TRAIN_BATCHES = (128, 64, 32)  # the config's 128, else 64 / 32
WATERMARK_TRAIN_SECONDS = 1              # dataset.segment_duration=1.0
WATERMARK_CHECK_ROWS = 2
WATERMARK_LOSS_RTOL = 1e-4               # card vs CPU, f32, no TF32
WATERMARK_GRAD_TOL = 1e-3                # |card - CPU| / |CPU| (L2)
# the 5 steps' draws: pad, mix and no mask, and the four default effects
WATERMARK_DRAWS = (("pad", "identity"), ("mix", "random_noise"),
                   ("none", "boost_audio"), ("pad", "duck_audio"),
                   ("none", "random_noise"))
# the effects' own draws in the card-vs-CPU check: speed 0.8 (a resample
# to 20 kHz: at a rate drawn at random its kernel bank has rate / gcd
# phases, as in the JAX package), echo 0.3 s at 0.4, smooth over 6
EFFECT_DRAWS = {"speed": [0.8], "echo": [0.3, 0.4], "smooth": [6.5]}


def _watermark_draws(torch, solver, x_cpu, mode, effect):
    """(message, mask) of a step: the message from the solver's generator,
    the mask of `mode` from `modules.watermark` on the same generator."""
    from audiocraft_tpu_torch.modules.watermark import mix, pad
    from audiocraft_tpu_torch.solvers.watermark import random_message
    g = solver._rng
    message = random_message(g, solver.nbits, x_cpu.shape[0])
    if mode == "pad":
        mask = pad(x_cpu, central=False, generator=g)[1][:, 1:2]
    elif mode == "mix":
        mask = mix(x_cpu, x_cpu, 0.5, generator=g)[1][:, 1:2]
    else:
        mask = torch.ones_like(x_cpu[:, :1])
    return message, mask


def _sequential_biquad(torch, x, b0, b1, b2, a0, a1, a2):
    """The direct-form-I recurrence, one step per sample."""
    y = torch.zeros_like(x)
    for t in range(x.shape[-1]):
        v = b0 * x[..., t]
        if t > 0:
            v = v + b1 * x[..., t - 1] - a1 * y[..., t - 1]
        if t > 1:
            v = v + b2 * x[..., t - 2] - a2 * y[..., t - 2]
        y[..., t] = v / a0
    return y


def phase_watermark_train(torch, card):
    """AudioSeal training at `solver/watermark/default`'s widths (16 bits,
    SEANet 128 / 32 filters, ratios 8-5-4-2, 2 LSTM layers, detector output
    32; l1 0.1, msspec 2, TF loudness ratio 10 over 4 bands, detection 1,
    decoding 1; balancer; Adam 5e-5; f32) with `dataset.segment_duration=
    1.0` (the composed config's null raises in both packages): 1 s rows at
    the config's batch of 128 (else 64, 32), 5 steps whose draws cover the
    pad, mix and none masks and the four default effects; the device ms of
    each step split into the generator's forward, the balanced perceptual
    losses with their gradient, the detection and decoding losses' forward
    and backward, and Adam; then card against CPU on 2 rows from the same
    state and draws, each of the 12 non-codec effects of
    `watermark/robustness.yaml` card against CPU, the loudness biquad on
    the TF-loudness shapes against its sequential version in f64, and one
    `evaluate` pass."""
    import copy
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.losses import loudnessloss
    from audiocraft_tpu_torch.solvers import get_solver
    from audiocraft_tpu_torch.utils import audio_effects
    from audiocraft_tpu_torch.utils.timing import time_ms
    phase_t0 = time.perf_counter()
    resident = _release(torch)
    cfg = load_config("solver/watermark/default")
    cfg["dataset"]["segment_duration"] = float(WATERMARK_TRAIN_SECONDS)
    audio = _seeded_music(torch, WATERMARK_TRAIN_BATCHES[0],
                          WATERMARK_TRAIN_SECONDS, AUDIOSEAL_RATE)
    batch, refused, solver = None, [], None
    for rows in WATERMARK_TRAIN_BATCHES:
        solver, setup_s = _timed(torch, lambda: get_solver(cfg, device="cuda"))
        x = audio[:rows]
        x_cpu = x.cpu()
        message, mask = _watermark_draws(torch, solver, x_cpu,
                                         *WATERMARK_DRAWS[0])
        try:
            first, first_s = _timed(torch, lambda: solver.train_step(
                x, message, mask, WATERMARK_DRAWS[0][1]))
            batch = rows
            break
        except RuntimeError as e:  # torch's or cuDNN's allocation failure
            if "out of memory" not in str(e) and "ALLOC" not in str(e):
                raise
            refused.append(rows)
            solver = None
            _release(torch)
    if batch is None:
        raise AssertionError("watermark_train: no batch of 32 or more fits")
    marks: dict = {}
    _mark_end(torch, solver.generator, "get_watermark", marks, "forward")
    _mark_end(torch, solver.balancer, "backward", marks, "balanced")
    _mark_end(torch, solver, "_watermark_backward", marks, "wm")
    torch.cuda.reset_peak_memory_stats()
    step_s, split_ms, history = [first_s], [], [first]
    for idx, (mode, effect) in enumerate(WATERMARK_DRAWS[1:], start=1):
        message, mask = _watermark_draws(torch, solver, x_cpu, mode, effect)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        metrics, seconds = _timed(torch, lambda: solver.train_step(
            x, message, mask, effect))
        end.record()
        end.synchronize()
        step_s.append(seconds)
        history.append(metrics)
        split_ms.append(dict(
            generator_forward=start.elapsed_time(marks["forward"]),
            balanced_losses_and_grads=marks["forward"].elapsed_time(
                marks["balanced"]),
            detection_decoding_fwd_bwd=marks["balanced"].elapsed_time(
                marks["wm"]),
            adam=marks["wm"].elapsed_time(end)))
    peak = torch.cuda.max_memory_allocated()
    losses = {k: [float(m[k]) for m in history] for k in history[0]}
    if not all(math.isfinite(v) for vs in losses.values() for v in vs):
        raise AssertionError(f"watermark_train: losses {losses}")

    # card vs CPU on 2 rows from the same state and draws (random noise:
    # the effect draws from the solver's CPU generator on both)
    rows = x[:WATERMARK_CHECK_ROWS]
    snapshot = copy.deepcopy(solver.state_dict())
    cpu = get_solver(cfg, device="cpu")
    results = {}
    for name, s in (("cuda", solver), ("cpu", cpu)):
        s.load_state_dict(copy.deepcopy(snapshot))
        message, mask = _watermark_draws(torch, s, rows.cpu(), "pad",
                                         "random_noise")
        m = s.train_step(rows.to(s.device), message, mask, "random_noise")
        results[name] = ({k: float(v) for k, v in m.items()}, {
            f"{prefix}.{n}": p.grad.detach().cpu()
            for prefix, model in (("generator", s.generator),
                                  ("detector", s.detector))
            for n, p in model.named_parameters()})
    loss_err, worst_loss = 0.0, ""
    for key, want in results["cpu"][0].items():
        err = abs(results["cuda"][0][key] - want)
        if not err <= WATERMARK_LOSS_RTOL * abs(want) + 1e-6:
            raise AssertionError(f"watermark_train: card {key} "
                                 f"{results['cuda'][0][key]} vs CPU {want}")
        loss_err, worst_loss = max((loss_err, worst_loss),
                                   (err / max(abs(want), 1e-30), key))
    grad_err, worst = 0.0, ""
    floor = 1e-6 * max(float(g.norm()) for g in results["cpu"][1].values())
    for name, want in results["cpu"][1].items():
        err = float((results["cuda"][1][name] - want).norm())
        if not err <= WATERMARK_GRAD_TOL * float(want.norm()) + floor:
            raise AssertionError(f"watermark_train: gradient of {name} "
                                 f"differs by {err} card vs CPU")
        grad_err, worst = max((grad_err, worst),
                              (err / max(float(want.norm()), 1e-30), name))
    del cpu, snapshot

    # each non-codec attack of watermark/robustness.yaml, card vs CPU
    robust = load_config("solver/watermark/robustness")
    effects = {k: v for k, v in audio_effects.get_audio_effects(robust).items()
               if k not in audio_effects.CODEC_EFFECTS}
    uniform = audio_effects.uniform
    effect_err = {}
    try:
        for name, effect in effects.items():
            outs = {}
            for device in ("cuda", "cpu"):
                draws = list(EFFECT_DRAWS.get(name, []))
                audio_effects.uniform = \
                    lambda a, b, generator=None: draws.pop(0)
                g = torch.Generator().manual_seed(9)
                outs[device] = effect(rows.to(device), generator=g)
            effect_err[name] = _card_vs_cpu(f"watermark_train effect {name}",
                                            outs["cuda"], outs["cpu"], 1e-5)
    finally:
        audio_effects.uniform = uniform

    # the loudness biquads on the TF-loudness rows (B x 4 bands x 4 frames
    # of 0.5 s), chunked in f32 and f64 against the recurrence in f64
    n_rows = batch * 4 * 4
    frames = 0.3 * torch.randn(n_rows, 1, AUDIOSEAL_RATE // 2, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(8))
    hp = loudnessloss.highpass_biquad
    seq_s = time.perf_counter()
    w0 = 2 * math.pi * 38.0 / AUDIOSEAL_RATE
    alpha = math.sin(w0) / 2 / 0.5
    coeffs = ((1 + math.cos(w0)) / 2, -1 - math.cos(w0),
              (1 + math.cos(w0)) / 2, 1 + alpha, -2 * math.cos(w0), 1 - alpha)
    want = _sequential_biquad(torch, frames.double(), *coeffs)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - seq_s
    scale = float(want.abs().max())
    biquad_f64_err = float((hp(frames.double(), AUDIOSEAL_RATE, 38.0, 0.5)
                            - want).abs().max()) / scale
    biquad_f32_err = float((hp(frames, AUDIOSEAL_RATE, 38.0, 0.5).double()
                            - want).abs().max()) / scale
    if not (biquad_f64_err <= 1e-10 and biquad_f32_err <= 1e-5):
        raise AssertionError(f"watermark_train: the chunked biquad is "
                             f"{biquad_f64_err} (f64) / {biquad_f32_err} (f32) "
                             f"off the recurrence")
    biquad_ms = time_ms(lambda: hp(frames, AUDIOSEAL_RATE, 38.0, 0.5), n=10)

    solver.dataloaders["evaluate"] = [x]
    evaluate = solver.evaluate()
    if not all(math.isfinite(v) for v in evaluate.values()):
        raise AssertionError(f"watermark_train: evaluate {evaluate}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    emit("watermark_train", card=card, config="solver/watermark/default + "
         "dataset.segment_duration=1.0 (16 bits, SEANet 128 / 32 filters, "
         "ratios 8-5-4-2, LSTM 2, detector output 32; l1 0.1, msspec 2, TF "
         "loudness ratio 10 over 4 bands, detection 1, decoding 1; balancer; "
         "Adam 5e-5; f32; seeded random weights)",
         batch=batch, batches_refused_out_of_memory=refused,
         seconds_per_item=WATERMARK_TRAIN_SECONDS, setup_s=setup_s,
         draws=[f"{m}+{e}" for m, e in WATERMARK_DRAWS],
         step_s=step_s, steady_step_s=steady,
         audio_s_per_s=batch * WATERMARK_TRAIN_SECONDS / steady,
         split_ms_steps_2_to_5=split_ms,
         split_ms_median={k: sorted(d[k] for d in split_ms)[len(split_ms) // 2]
                          for k in split_ms[0]},
         losses_first_to_last={k: [v[0], v[-1]] for k, v in losses.items()},
         generator_params=sum(p.numel() for p in solver.generator.parameters()),
         detector_params=sum(p.numel() for p in solver.detector.parameters()),
         max_memory_allocated=peak, peak_gb=peak / 1e9,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(rows=WATERMARK_CHECK_ROWS, draws="pad+random_noise",
                          max_loss_rel_err=loss_err, worst_loss=worst_loss,
                          loss_rtol=WATERMARK_LOSS_RTOL,
                          max_grad_rel_l2_err=grad_err, worst_parameter=worst,
                          grad_tol=f"|card - CPU| <= {WATERMARK_GRAD_TOL} x "
                                   f"|CPU| (L2) + 1e-6 x the largest"),
         effects_card_vs_cpu_max_abs_err=effect_err,
         effects_rel_tol="1e-5 x max(1, max |CPU|)",
         effect_draws=EFFECT_DRAWS,
         biquad=dict(rows=n_rows, samples=AUDIOSEAL_RATE // 2,
                     f64_rel_err=biquad_f64_err, f32_rel_err=biquad_f32_err,
                     f32_ms=biquad_ms, sequential_f64_s=seq_s),
         evaluate=evaluate, phase_s=time.perf_counter() - phase_t0)
    del solver, audio, x, rows, results, frames, want
    _release(torch)


CLAP_SECONDS = 10           # of music per text
CLAP_AUDIO_SECONDS = 30     # the clip whose 10 s windows the audio tower sees
CLAP_GREEDY_SECONDS = 1
CLAP_EMBED_RTOL = 1e-4      # card vs CPU, relative to max |CPU|


def _synthetic_roberta_files(root: Path) -> None:
    """A byte-level BPE vocabulary of RoBERTa-base's size (50265 entries:
    the specials, the 256 byte characters, then merges of two byte
    characters in a fixed order) with its merges."""
    from audiocraft_tpu_torch.modules.clap import _bytes_to_unicode
    chars = sorted(set(_bytes_to_unicode().values()))
    specials = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]
    merges = [(a, b) for a in chars for b in chars][:50265 - len(specials)
                                                   - len(chars)]
    vocab = specials + chars + [a + b for a, b in merges]
    (root / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def _write_clap_checkpoint(torch) -> Path:
    """The seeded HTSAT-base + RoBERTa-base towers (512-wide projections)
    as `clap.safetensors` in the Hugging Face layout, with the synthetic
    tokenizer files beside it, under `_packages_dir()/clap`; the folder."""
    from audiocraft_tpu_torch.modules import clap
    from audiocraft_tpu_torch.utils import safetensors
    root = _packages_dir() / "clap"
    root.mkdir(exist_ok=True)
    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        torch.manual_seed(11)
        tower = clap.ClapModel(clap.CLAPConfig(), device="cuda")
    safetensors.save_file(tower.state_dict(), root / "clap.safetensors")
    del tower
    _synthetic_roberta_files(root)
    return root


def phase_clap(torch, card):
    """MusicGen-small conditioned by CLAP (`solver/musicgen/default` with
    `conditioner=clapemb2music`: the HTSAT-base audio and RoBERTa-base text
    towers with 512-wide projections, read from a seeded checkpoint the
    phase writes in the Hugging Face layout through the port's safetensors
    writer, with a synthetic byte-level vocabulary of 50265 entries; RVQ of
    12 x 1024; the LM at full width, bf16): 2 texts x 10 s through the
    decode graph with the texts as joint conditions, and through
    `MusicGen.generate` (every row the null condition, as in the JAX
    package); the request split into the text tower, the conditioner and
    the generate; the audio tower's ms per 10 s window of a 30 s clip (21
    windows at a 1 s stride); the text and audio embeddings on the card
    against the CPU; greedy tokens over 1 s on the card against the CPU in
    f32. Returns K1's launches."""
    from audiocraft_tpu_torch.config import load_config
    from audiocraft_tpu_torch.models import MusicGen, builders
    from audiocraft_tpu_torch.models.lm import GenParams
    from audiocraft_tpu_torch.modules import clap, conditioners
    from audiocraft_tpu_torch.modules.conditioners import (
        ConditioningAttributes, JointEmbedCondition, set_joint_embed_train)
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.utils.timing import time_ms
    phase_t0 = time.perf_counter()
    _release(torch)
    root = _write_clap_checkpoint(torch)
    cfg = load_config("solver/musicgen/default")
    clap_cfg = load_config("conditioner/clapemb2music")
    for key in ("conditioners", "fuser", "classifier_free_guidance",
                "attribute_dropout"):
        cfg[key] = clap_cfg[key]
    cfg["conditioners"]["description"]["clap"]["checkpoint"] = str(
        root / "clap.safetensors")
    lm = builders.get_lm_model(cfg, device="cuda", seed=7,
                               dtype=torch.bfloat16)
    lm.reset_parameters(7)
    codec = builders.get_encodec_32khz(device="cuda", dtype=torch.bfloat16,
                                       seed=1)
    cond = lm.condition_provider.conditioners["description"]
    embedder, load_s = _timed(torch, cond._embedder)
    frames = CLAP_SECONDS * TOKENS_PER_SECOND

    def joint_attrs(texts, device="cuda"):
        attrs = [ConditioningAttributes(text={"description": t})
                 for t in texts]
        for a, t in zip(attrs, texts):
            a.joint_embed["description"] = JointEmbedCondition(
                torch.zeros(1, 1, 1), [t], torch.tensor([1]), [48000],
                [None], [None])
        return attrs

    times = {"text_tower": [], "tokenize": [], "conditions": []}
    embed_text = embedder.embed_text
    embedder.embed_text = _sync_timed(torch, embed_text, times["text_tower"])
    tokenize = lm.condition_provider.tokenize
    lm.condition_provider.tokenize = _sync_timed(torch, tokenize,
                                                 times["tokenize"])
    compute = lm.compute_conditions
    lm.compute_conditions = _sync_timed(torch, compute, times["conditions"])
    decode_attention.launches = 0
    try:
        request = []
        for _ in range(2):
            for v in times.values():
                v.clear()
            t = time.perf_counter()
            tokens = lm.generate(conditions=joint_attrs(TEXTS),
                                 max_gen_len=frames, gen=GenParams(
                                     top_k=250, cfg_coef=3.0),
                                 generator=torch.Generator("cuda").manual_seed(2),
                                 device="cuda")
            wav, decode_s = _timed(torch, lambda: codec.decode(tokens,
                                                               device="cuda"))
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            request.append(dict(
                request_s=total, text_tower_s=sum(times["text_tower"]),
                conditioner_s=sum(times["tokenize"]) + sum(times["conditions"])
                - sum(times["text_tower"]),
                generate_s=total - decode_s - sum(times["tokenize"])
                - sum(times["conditions"]),
                codec_decode_s=decode_s))
        null_valid = lm.condition_provider.tokenize(
            [ConditioningAttributes(text={"description": t})
             for t in TEXTS])["description"]["valid"]
        mg = MusicGen("musicgen-small clapemb (random weights)", codec, lm,
                      device="cuda")
        mg.set_generation_params(duration=CLAP_SECONDS)
        (mg_wav, mg_tokens), mg_s = _timed(torch, lambda: mg.generate(
            TEXTS, return_tokens=True))
    finally:
        embedder.embed_text = embed_text
        lm.condition_provider.tokenize = tokenize
        lm.compute_conditions = compute
    launches = decode_attention.launches
    expected = 3 * _k1_launches(lm, frames)
    _check_generation(torch, "clap", wav, tokens, (2, 1, frames * 640), 4,
                      frames, launches, expected)
    _check_generation(torch, "clap MusicGen.generate", mg_wav, mg_tokens,
                      (2, 1, frames * 640), 4, frames, launches, expected)
    if float(null_valid.abs().max()) != 0.0:
        raise AssertionError("clap: MusicGen.generate's rows are not null")
    del mg, codec, lm

    # the audio tower on a 30 s clip in 10 s windows every second
    clip = _seeded_music(torch, 1, CLAP_AUDIO_SECONDS, 48000)[0].cpu()
    windows = torch.stack([clip[:, s:s + 10 * 48000] for s in range(
        0, (CLAP_AUDIO_SECONDS - 10) * 48000 + 1, 48000)])
    mel_s = time.perf_counter()
    mel = torch.from_numpy(embedder.mels(windows, 48000)).cuda()
    mel_s = time.perf_counter() - mel_s
    tower_ms = time_ms(lambda: embedder.model.get_audio_features(mel), n=5)
    set_joint_embed_train(cond, True, seed=0)
    audio_embed, audio_s = _timed(torch, lambda: cond._get_embed(
        JointEmbedCondition(clip[None], [None], torch.tensor([clip.shape[-1]]),
                            [48000], [None], [None])))
    cpu_embedder = clap.CLAPEmbedder.from_checkpoint(root / "clap.safetensors",
                                                     "cpu")
    text_err = _card_vs_cpu("clap text embedding",
                            embedder.embed_text(TEXTS),
                            cpu_embedder.embed_text(TEXTS), CLAP_EMBED_RTOL)
    audio_err = _card_vs_cpu("clap audio embedding",
                             embedder.embed_audio(windows[:2], 48000),
                             cpu_embedder.embed_audio(windows[:2], 48000),
                             CLAP_EMBED_RTOL)

    # greedy tokens over 1 s in f32, card against CPU from the same weights
    greedy = {}
    for device in ("cpu", "cuda"):
        lm32 = builders.get_lm_model(cfg, device=device, seed=7)
        if device == "cpu":
            lm32.reset_parameters(7)
            weights = lm32.state_dict()
        else:
            lm32.load_state_dict(weights)
        greedy[device] = lm32.generate(
            conditions=joint_attrs(TEXTS), max_gen_len=CLAP_GREEDY_SECONDS
            * TOKENS_PER_SECOND, gen=GenParams(use_sampling=False,
                                               cfg_coef=3.0),
            device=device).cpu()
        del lm32
    if not torch.equal(greedy["cuda"], greedy["cpu"]):
        raise AssertionError("clap: greedy tokens of the card and the CPU "
                             "differ")
    emit("clap", card=card, lm="solver/musicgen/default + conditioner="
         "clapemb2music (MusicGen-small LM: d 1024, 24 layers, 4 x 2048 "
         "codes; CLAP HTSAT-base + RoBERTa-base, projections 512, RVQ 12 x "
         "1024; seeded random weights, bf16; the towers f32)",
         checkpoint_bytes=(root / "clap.safetensors").stat().st_size,
         vocab_entries=50265, embedder_load_s=load_s, texts=len(TEXTS),
         audio_s_per_text=CLAP_SECONDS, requests=request,
         musicgen_generate_s=mg_s,
         musicgen_generate_condition="null (valid 0 on every row)",
         k1_launches=launches, k1_launches_expected=expected,
         audio_tower=dict(clip_s=CLAP_AUDIO_SECONDS, windows=len(windows),
                          host_mel_s=mel_s, device_ms=tower_ms,
                          ms_per_window=tower_ms / len(windows),
                          conditioner_audio_embed_s=audio_s),
         card_vs_cpu=dict(text_embedding_max_abs_err=text_err,
                          audio_embedding_max_abs_err=audio_err,
                          rel_tol=CLAP_EMBED_RTOL,
                          greedy_tokens_equal=True,
                          greedy_seconds=CLAP_GREEDY_SECONDS),
         phase_s=time.perf_counter() - phase_t0)
    del embedder, cpu_embedder, cond, audio_embed
    conditioners._CLAP_EMBEDDERS.clear()
    _release(torch)
    return launches


DAC_SECONDS = 10
DAC_CHECK_SECONDS = 1       # of the 2 rows held card against CPU
DAC_WAV_RTOL = 1e-4         # relative to max(1, max |CPU|)
DAC_TIE = 1e-5              # a cosine margin below this is a near-tie


def _dac_codes_and_margins(torch, model, x):
    """The codes of `model.encode(x)` and, per code, the margin of its
    cosine over the runner-up's."""
    import torch.nn.functional as F
    z = model.encoder(F.pad(x, (0, (-x.shape[-1]) % model.hop_length)))
    codes, margins = [], []
    for q in model.quantizer.quantizers:
        e = F.normalize(q.in_proj(z).transpose(1, 2), dim=-1, eps=1e-12)
        c = F.normalize(q.codebook.weight, dim=-1, eps=1e-12)
        top = (e @ c.T).topk(2, dim=-1)
        idx = top.indices[..., 0]
        z = z - q.decode(idx)
        codes.append(idx)
        margins.append(top.values[..., 0] - top.values[..., 1])
    return torch.stack(codes, 1), torch.stack(margins, 1)


def phase_dac(torch, card):
    """DAC 44.1 kHz at the dac package's default geometry (encoder 64,
    strides 2-4-8-8, latent 1024, decoder 1536 with rates 8-8-4-2, 9 x 1024
    codebooks of dim 8; seeded random weights, f32) saved as a dac
    `weights.pth` and read back through `DAC.get_pretrained`: encode and
    decode 2 x 10 s (ms, peak memory), then card against CPU on 2 x 1 s:
    codes equal but for near-ties of the cosine lookup (recorded), and the
    decode of the same codes."""
    from audiocraft_tpu_torch.models import dac
    from audiocraft_tpu_torch.utils.timing import time_ms
    phase_t0 = time.perf_counter()
    resident = _release(torch)
    root = _packages_dir() / "dac"
    root.mkdir(exist_ok=True)
    kwargs = dict(encoder_dim=64, encoder_rates=[2, 4, 8, 8],
                  decoder_dim=1536, decoder_rates=[8, 8, 4, 2], n_codebooks=9,
                  codebook_size=1024, codebook_dim=8, sample_rate=44100)
    with torch.random.fork_rng(devices=[torch.device("cuda")]):
        torch.manual_seed(12)
        model = dac.DACModel(device="cuda", **kwargs)
    torch.save({"state_dict": model.state_dict(),
                "metadata": {"kwargs": kwargs}}, root / "weights.pth")
    del model
    codec, load_s = _timed(torch, lambda: dac.DAC.get_pretrained(
        root / "weights.pth", device="cuda"))
    x = _seeded_music(torch, 2, DAC_SECONDS, 44100)
    torch.cuda.reset_peak_memory_stats()
    (codes, _), encode_s = _timed(torch, lambda: codec.encode(x))
    wav, decode_s = _timed(torch, lambda: codec.decode(codes))
    peak = torch.cuda.max_memory_allocated()
    if tuple(codes.shape) != (2, 9, math.ceil(x.shape[-1] / 512)) or \
            tuple(wav.shape) != (2, 1, codes.shape[-1] * 512):
        raise AssertionError(f"dac: codes {tuple(codes.shape)}, audio "
                             f"{tuple(wav.shape)}")
    if not bool(torch.isfinite(wav).all()):
        raise AssertionError("dac: non-finite audio")
    encode_ms = time_ms(lambda: codec.encode(x), n=5)
    decode_ms = time_ms(lambda: codec.decode(codes), n=5)
    cpu = dac.DAC.get_pretrained(root / "weights.pth", device="cpu")
    rows = x[:, :, :DAC_CHECK_SECONDS * 44100]
    with torch.no_grad():
        got, _ = _dac_codes_and_margins(torch, codec.model, rows)
        want, margins = _dac_codes_and_margins(torch, cpu.model, rows.cpu())
    if not torch.equal(got, codec.encode(rows)[0]):
        raise AssertionError("dac: the margins' codes differ from encode's")
    differ = (got.cpu() != want)
    # a difference at one level changes every later level of that frame:
    # only the first differing level of a frame must be a near-tie
    first = differ & (differ.cumsum(dim=1) == 1)
    ties = margins[first]
    if ties.numel() and float(ties.max()) >= DAC_TIE:
        raise AssertionError(f"dac: codes differ card vs CPU at a cosine "
                             f"margin of {float(ties.max())}")
    wav_err = _card_vs_cpu("dac decode", codec.decode(want),
                           cpu.decode(want), DAC_WAV_RTOL)
    emit("dac", card=card, model="DAC 44.1 kHz, the dac package's default "
         "geometry (encoder 64, strides 2-4-8-8, latent 1024, decoder 1536, "
         "rates 8-8-4-2, 9 x 1024 codebooks of dim 8; seeded random "
         "weights, f32)", params=sum(p.numel() for p in codec.parameters()),
         weights_bytes=(root / "weights.pth").stat().st_size,
         load_s=load_s, rows=2, audio_s_per_row=DAC_SECONDS,
         first_call_s=dict(encode=encode_s, decode=decode_s),
         encode_ms=encode_ms, decode_ms=decode_ms,
         max_memory_allocated=peak, peak_gb=peak / 1e9,
         resident_bytes_before_phase=resident,
         card_vs_cpu=dict(seconds=DAC_CHECK_SECONDS,
                          codes_differing=int(differ.sum()),
                          frames_with_a_near_tie=int(first.sum()),
                          near_tie_margins=ties.tolist(),
                          near_tie_below=DAC_TIE,
                          decode_max_abs_err=wav_err,
                          decode_rel_tol=DAC_WAV_RTOL),
         phase_s=time.perf_counter() - phase_t0)
    (root / "weights.pth").unlink()
    del codec, cpu, x, wav, codes
    _release(torch)


DATA_FILES = 64             # stereo 16-bit WAVs at 44.1 kHz, 60 s each
DATA_FILE_SECONDS = 60
DATA_RATE = 44100
DATA_TRAIN_BATCH = 16       # cut from musicgen_base_32khz's 192, as train
DATA_TRAIN_STEPS = 6
DATA_WORKERS = 8
DATA_LOADER_BATCHES = (1, 16)   # batches timed after the first, at 0 and
                                # at DATA_WORKERS workers
DATA_DEVICE_STEPS = 3       # steps on one batch held on the card
DATA_GEN_SECONDS = 10       # of greedy audio per generated sample
DATA_EXPORT_SECONDS = 2     # of greedy tokens from the exported package
DATA_GENRES = ("rock", "jazz", "electronic", "ambient")


def _write_dataset(torch, root: Path) -> float:
    """DATA_FILES stereo 16-bit WAVs at 44.1 kHz, synthesised on the card
    from seed 11 (harmonics of a seeded pitch per channel, a slow tremolo
    and a little noise), each with the JSON sidecar of a music track.
    Returns the bytes written."""
    from audiocraft_tpu_torch.data.audio import _write_wav
    g = torch.Generator("cuda").manual_seed(11)
    t = torch.arange(DATA_FILE_SECONDS * DATA_RATE, device="cuda") / DATA_RATE
    written = 0
    for i in range(DATA_FILES):
        f0 = 110.0 * 2 ** (torch.randint(0, 36, (2, 1), device="cuda",
                                         generator=g) / 12)
        wav = torch.zeros(2, t.numel(), device="cuda")
        for h in range(1, 5):
            amp = torch.rand(2, 1, device="cuda", generator=g) / h
            wav += amp * torch.sin(2 * torch.pi * h * f0 * t)
        wav *= 0.75 + 0.25 * torch.sin(2 * torch.pi * 0.5 * t)
        wav += 0.01 * torch.randn(wav.shape, device="cuda", generator=g)
        wav = 0.5 * wav / wav.abs().amax()
        path = root / f"track_{i:03d}.wav"
        _write_wav(path, wav.cpu().numpy(), DATA_RATE)
        written += path.stat().st_size
        genre = DATA_GENRES[i % len(DATA_GENRES)]
        (root / f"track_{i:03d}.json").write_text(json.dumps({
            "title": f"Track {i}", "artist": "Seeded Synth", "key": "C major",
            "bpm": 90 + i, "genre": genre, "moods": ["calm"],
            "keywords": f"{genre}, synth", "name": f"track_{i:03d}",
            "instrument": "Mix",
            "description": f"{TEXTS[i % 2]}, {genre} take {i}"}))
    return written


def _time_loader(torch, dataset, workers: int, batches: int):
    """(first batch, seconds to it, seconds for the next `batches`) of a
    DataLoader over `dataset`: the first includes starting the workers."""
    from audiocraft_tpu_torch.data.loader import DataLoader
    loader = DataLoader(dataset, batch_size=DATA_TRAIN_BATCH,
                        num_workers=workers, pin_memory=True, timeout=120)
    loader.set_epoch(1)
    t0 = time.perf_counter()
    it = iter(loader)
    first = next(it)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    seconds = time.perf_counter() - t0
    del it
    return first, first_s, seconds


def phase_data_train(torch, card, codec_dir):
    """The data plane and the training entry point at MusicGen-small's
    width: a seeded dataset of 44.1 kHz stereo WAVs with JSON sidecars
    under a temporary directory and its manifest from the port's manifest
    CLI; the loader alone at 0 and DATA_WORKERS workers (its first batch
    bitwise equal at both); then `train.main` with
    `solver=musicgen/musicgen_base_32khz` over that datasource (16 x 30 s
    resampled to 32 kHz mono by the loader's workers, the full-width codec
    package of the loaders phase, bf16 autocast, 6 updates, a checkpoint),
    whose generate stage stores 2 greedy samples of 10 s through the
    sample manager; then the checkpoint exported as a package and loaded
    back through `loaders.load_lm_model` (its greedy tokens equal the
    in-memory model's), and the same train step on one batch held on the
    card. Returns K1's launches (the generate stage and the export check),
    the dataset's folder and the checkpoint, which the evaluate phase reads;
    the caller removes the folder's parent."""
    import tempfile
    from audiocraft_tpu_torch import train
    from audiocraft_tpu_torch.data.loader import DataLoader
    from audiocraft_tpu_torch.data.loader import shutdown as shutdown_loader
    from audiocraft_tpu_torch.data.music_dataset import MusicDataset
    from audiocraft_tpu_torch.models import MusicGen, loaders
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers.musicgen import MusicGenSolver
    from audiocraft_tpu_torch.utils.export import export_lm
    phase_t0 = time.perf_counter()
    resident = _release(torch)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_data_train_"))
    try:
        data = tmp / "data"
        data.mkdir()
        t0 = time.perf_counter()
        data_bytes = _write_dataset(torch, data)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m",
                        "audiocraft_tpu_torch.data.audio_dataset", str(data),
                        str(data / "data.jsonl")], check=True,
                       cwd=Path(__file__).resolve().parent, timeout=300)
        manifest_s = time.perf_counter() - t0
        n_lines = len((data / "data.jsonl").read_text().splitlines())
        if n_lines != DATA_FILES:
            raise AssertionError(f"data_train: manifest of {n_lines} files")

        # the loader alone, as the solver builds it
        dataset = MusicDataset.from_meta(
            data, segment_duration=TRAIN_SECONDS, num_samples=10000,
            sample_rate=32000, channels=1, shuffle=True, return_info=True,
            min_segment_ratio=0.8)
        rates = {}
        firsts = {}
        for workers, batches in zip((0, DATA_WORKERS), DATA_LOADER_BATCHES):
            firsts[workers], first_s, seconds = _time_loader(
                torch, dataset, workers, batches)
            segments = batches * DATA_TRAIN_BATCH
            rates[workers] = {"first_batch_s": first_s, "batches": batches,
                              "seconds": seconds,
                              "segments_per_s": segments / seconds,
                              "audio_s_per_s":
                                  segments * TRAIN_SECONDS / seconds}
        wav0, infos0 = firsts[0]
        wav8, infos8 = firsts[DATA_WORKERS]
        if tuple(wav0.shape) != (DATA_TRAIN_BATCH, 1, TRAIN_SECONDS * 32000):
            raise AssertionError(f"data_train: batch {tuple(wav0.shape)}")
        equal = bool(torch.equal(wav0, wav8)) and all(
            (a.meta.path, a.seek_time, a.description)
            == (b.meta.path, b.seek_time, b.description)
            for a, b in zip(infos0, infos8))
        if not equal:
            raise AssertionError("data_train: the first batch differs "
                                 "between 0 and 8 workers")
        if not bool(torch.isfinite(wav0).all()) or float(wav0.abs().max()) == 0:
            raise AssertionError("data_train: the batch is not audio")

        # train.main, instrumented from outside: the solver it builds, each
        # run_step's host interval, and the wait in next(loader)
        marks = {"enter": [], "exit": [], "wait": []}
        held = {}
        original_iter = DataLoader.__iter__
        original_step = MusicGenSolver.run_step
        original_get_solver = train.get_solver

        def timed_iter(self):
            it = original_iter(self)
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                if self.batch_size == DATA_TRAIN_BATCH:
                    marks["wait"].append(time.perf_counter() - t)
                    held.setdefault("batch", batch)
                yield batch

        def timed_step(self, idx, batch, metrics):
            marks["enter"].append(time.perf_counter())
            out = original_step(self, idx, batch, metrics)
            marks["exit"].append(time.perf_counter())
            return out

        def keep_solver(cfg):
            solver = original_get_solver(cfg)
            held["solver"] = solver
            generate = solver.generate

            def counted_generate():
                held["k2_train"] = (fca.launches, fca.backward_launches)
                decode_attention.launches = 0
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = generate()
                torch.cuda.synchronize()
                held["generate_s"] = time.perf_counter() - t
                held["k1_generate"] = decode_attention.launches
                return out

            solver.generate = counted_generate
            return solver

        dora = tmp / "dora"
        os.environ["AUDIOCRAFT_DORA_DIR"] = str(dora)
        argv = ["solver=musicgen/musicgen_base_32khz", "device=cuda",
                f"datasource.train={data}", f"datasource.generate={data}",
                f"compression_model_checkpoint={codec_dir}",
                f"dataset.batch_size={DATA_TRAIN_BATCH}",
                f"dataset.segment_duration={TRAIN_SECONDS}",
                f"dataset.num_workers={DATA_WORKERS}",
                "dataset.generate.batch_size=2",
                "dataset.generate.num_samples=2",
                "transformer_lm.dtype=bfloat16", "optim.epochs=1",
                f"optim.updates_per_epoch={DATA_TRAIN_STEPS}",
                "generate.lm.use_sampling=false",
                f"generate.lm.gen_duration={DATA_GEN_SECONDS}",
                "generate.lm.num_samples=2", "logging.level=WARNING"]
        torch.cuda.reset_peak_memory_stats()
        fca.launches = fca.backward_launches = 0
        DataLoader.__iter__ = timed_iter
        MusicGenSolver.run_step = timed_step
        train.get_solver = keep_solver
        threads = torch.get_num_threads()
        try:
            t0 = time.perf_counter()
            history = train.main(argv)
            main_s = time.perf_counter() - t0
        finally:
            DataLoader.__iter__ = original_iter
            MusicGenSolver.run_step = original_step
            train.get_solver = original_get_solver
            torch.set_num_threads(threads)
        peak = torch.cuda.max_memory_allocated()
        solver = held["solver"]
        lm = solver.model
        ces = [history[0]["train"]["ce"]]
        if len(marks["enter"]) != DATA_TRAIN_STEPS or not all(
                math.isfinite(v) for v in history[0]["train"].values()):
            raise AssertionError(f"data_train: {len(marks['enter'])} steps, "
                                 f"metrics {history[0]['train']}")
        expected_k2 = lm.num_layers * DATA_TRAIN_STEPS
        if held["k2_train"] != (expected_k2, expected_k2):
            raise AssertionError(f"data_train: K2 launched {held['k2_train']}"
                                 f", expected {expected_k2} each")
        gen_frames = DATA_GEN_SECONDS * TOKENS_PER_SECOND
        if held["k1_generate"] != _k1_launches(lm, gen_frames):
            raise AssertionError(f"data_train: K1 launched "
                                 f"{held['k1_generate']} times in the "
                                 f"generate stage, expected "
                                 f"{_k1_launches(lm, gen_frames)}")
        folder = Path(solver.cfg["folder"])
        samples = sorted((folder / "samples" / "1").glob("*.wav"))
        if len(samples) != 2:
            raise AssertionError(f"data_train: {len(samples)} samples stored")
        from audiocraft_tpu_torch.data.audio import audio_read
        sample, sample_sr = audio_read(samples[0])
        if sample.shape != (1, DATA_GEN_SECONDS * 32000) or sample_sr != 32000:
            raise AssertionError(f"data_train: sample {sample.shape} at "
                                 f"{sample_sr} Hz")
        if not (folder / "checkpoint.th").exists():
            raise AssertionError("data_train: no checkpoint")
        intervals = [b - a for a, b in zip(marks["enter"], marks["enter"][1:])]
        waits = marks["wait"][1:len(intervals) + 1]
        steady = sorted(intervals[1:])[len(intervals[1:]) // 2]
        wait_share = sum(waits[1:]) / sum(intervals[1:])

        # export, load back, greedy tokens against the in-memory model
        t0 = time.perf_counter()
        package = export_lm(folder / "checkpoint.th",
                            tmp / "export" / "state_dict.bin")
        export_s = time.perf_counter() - t0
        (loaded, _), load_s = _timed(torch, lambda: loaders.load_lm_model(
            str(package.parent), device="cuda"))
        decode_attention.launches = 0
        tokens = {}
        for name, model in (("in_memory", lm), ("exported", loaded)):
            mg = MusicGen(f"data_train {name}", solver.compression_model,
                          model, device="cuda")
            mg.set_generation_params(duration=DATA_EXPORT_SECONDS,
                                     use_sampling=False)
            _, tokens[name] = mg.generate(TEXTS[:1], return_tokens=True)
        k1_export = decode_attention.launches
        if k1_export != 2 * _k1_launches(lm, DATA_EXPORT_SECONDS
                                         * TOKENS_PER_SECOND):
            raise AssertionError(f"data_train: K1 launched {k1_export} times "
                                 f"in the export check")
        if not torch.equal(tokens["in_memory"], tokens["exported"]):
            raise AssertionError("data_train: the exported package's greedy "
                                 "tokens differ from the in-memory model's")
        del loaded

        # the same step on one batch held on the card
        wav, infos = held["batch"]
        on_card = (wav.to("cuda"), infos)
        device_s = []
        for idx in range(DATA_DEVICE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            solver.run_step(idx, on_card, {})
            torch.cuda.synchronize()
            device_s.append(time.perf_counter() - t)
        held_steady = sorted(device_s[1:])[len(device_s[1:]) // 2]
        emit("data_train", card=card, cpu_count=os.cpu_count(),
             data={"files": DATA_FILES, "seconds_each": DATA_FILE_SECONDS,
                   "rate": DATA_RATE, "channels": 2, "bits": 16,
                   "bytes": data_bytes, "write_s": write_s,
                   "manifest_cli_s": manifest_s},
             config="solver/musicgen/musicgen_base_32khz (MusicGen-small LM: "
                    "T5-base, 24 layers, d 1024; seeded random weights, f32 "
                    "params, bf16 autocast; the 32 kHz EnCodec package of "
                    "the loaders phase)",
             argv=argv, loader=rates, first_batch_equal_0_vs_8=equal,
             train_steps=DATA_TRAIN_STEPS, train_ce=ces,
             step_intervals_s=intervals, loader_wait_s=marks["wait"],
             steady_step_s_with_loader=steady, loader_wait_share=wait_share,
             steady_step_s_batch_on_card=held_steady,
             batch_on_card_step_s=device_s,
             main_s=main_s, generate_stage_s=held["generate_s"],
             k2_forward_launches=held["k2_train"][0],
             k2_backward_launches=held["k2_train"][1],
             k1_generate_launches=held["k1_generate"],
             k1_export_check_launches=k1_export, samples=len(samples),
             export_s=export_s, exported_load_s=load_s,
             exported_tokens_equal=True,
             max_memory_allocated=peak, resident_before=resident,
             seconds=time.perf_counter() - phase_t0)
        return (held["k1_generate"] + k1_export, data,
                folder / "checkpoint.th")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    finally:
        shutdown_loader()
        os.environ.pop("AUDIOCRAFT_DORA_DIR", None)


EVAL_SEGMENTS = 16          # 10 s segments of the data_train WAVs
EVAL_BATCH = 8
EVAL_SECONDS = 10
EVAL_CHECK_CLIPS = 2        # generated clips whose towers run card vs CPU
EVAL_TOWER_RTOL = 1e-4      # |card - CPU| / |CPU| (L2), f32 without TF32
EVAL_KEYS = ("fad", "kld", "kld_pq", "kld_qp", "kld_both",
             "text_consistency", "chroma_cosine")


def _rel_l2(got, want) -> float:
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_evaluate(torch, card, codec_dir, data, checkpoint):
    """The evaluate stage through the grid CLI: `python -m
    audiocraft_tpu_torch.grids musicgen.musicgen_pretrained_32khz_eval --run
    --max-jobs 1` with `-o` overrides that point its first job at the
    data_train phase's checkpoint (MusicGen-small, warm start), codec
    package and WAVs (an evaluate split of EVAL_SEGMENTS segments of 10 s
    in batches of EVAL_BATCH, read in the main process), and at seeded
    checkpoints at the published widths: VGGish (`metrics.fad.vggish.
    model_path`, torchvggish layout), PaSST-S (`$PASST_CHECKPOINT`,
    hear21passt layout with the `net.` prefix) and the clap phase's
    HTSAT-base + RoBERTa-base towers with their tokenizer files
    (`metrics.text_consistency.clap.model_path`, `$CLAP_TOKENIZER`). Each
    batch generates its 8 descriptions at 10 s (top-k 250, CFG 3.0, as the
    config says) through K1's decode graph, then updates FAD, KLD, text
    consistency and chroma cosine. Per batch the generate time and each
    update's time split into host preprocessing (VGGish examples, PaSST
    mels, CLAP mels) and the rest (device work and copies); the towers'
    outputs on EVAL_CHECK_CLIPS generated clips on the card against the
    CPU. Returns K1's launches."""
    import collections
    import tempfile
    import numpy as np
    from audiocraft_tpu_torch import train
    from audiocraft_tpu_torch.grids.__main__ import main as grid_main
    from audiocraft_tpu_torch.metrics import passt, vggish
    from audiocraft_tpu_torch.modules import clap
    from audiocraft_tpu_torch.ops.decode_attention import decode_attention
    from audiocraft_tpu_torch.ops.flash_causal_attention import \
        flash_causal_attention as fca
    from audiocraft_tpu_torch.solvers import builders
    from audiocraft_tpu_torch.utils.utils import check_module_device
    phase_t0 = time.perf_counter()
    resident = _release(torch)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_evaluate_"))
    clap_root = _packages_dir() / "clap"
    env = {"AUDIOCRAFT_DORA_DIR": str(tmp / "dora"),
           "PASST_CHECKPOINT": str(tmp / "passt.pt"),
           "CLAP_TOKENIZER": str(clap_root)}
    saved_env = {k: os.environ.get(k) for k in env}
    held = {"generate_s": [], "metrics": {}}
    host = collections.defaultdict(list)
    updates = collections.defaultdict(list)
    computes = {}
    patched = []

    def patch(obj, name, value):
        patched.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def host_timed(name, fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            host[name].append(time.perf_counter() - t)
            return out
        return wrapped

    def timed_metric(name, getter):
        def get(*args, **kwargs):
            metric = getter(*args, **kwargs)
            if metric is None:
                return None
            held["metrics"][name] = metric
            update, compute = metric.update, metric.compute

            def timed_update(*a, **k):
                n = len(host[name])
                out, seconds = _timed(torch, lambda: update(*a, **k))
                h = sum(host[name][n:])
                updates[name].append({"update_s": seconds, "host_s": h,
                                      "rest_s": seconds - h})
                return out

            def timed_compute():
                out, computes[name] = _timed(torch, compute)
                return out

            metric.update, metric.compute = timed_update, timed_compute
            return metric
        return get

    def keep_solver(cfg):
        solver = original_get_solver(cfg)
        held["solver"] = solver
        gen_model, evaluate = solver._gen_model, solver.evaluate

        def timed_gen_model():
            model = gen_model()
            generate = model.generate

            def timed_generate(descriptions):
                out, seconds = _timed(torch, lambda: generate(descriptions))
                held["generate_s"].append(seconds)
                if "clips" not in held:
                    held["clips"] = out[:EVAL_CHECK_CLIPS].float().cpu()
                    held["texts"] = list(descriptions[:EVAL_CHECK_CLIPS])
                return out

            model.generate = timed_generate
            return model

        def kept_evaluate():
            out, held["evaluate_s"] = _timed(torch, evaluate)
            held["result"] = out
            return out

        solver._gen_model, solver.evaluate = timed_gen_model, kept_evaluate
        return solver

    original_get_solver = train.get_solver
    try:
        t0 = time.perf_counter()
        with torch.random.fork_rng(devices=[torch.device("cuda")]):
            torch.manual_seed(21)
            torch.save(vggish.VGGish().state_dict(), tmp / "vggish.pth")
            torch.manual_seed(22)
            net = passt.PaSST()
            with torch.no_grad():
                for p in (net.cls_token, net.dist_token,
                          net.new_pos_embed, net.freq_new_pos_embed,
                          net.time_new_pos_embed):
                    p.normal_(0, 0.02)
            torch.save({"net." + k: v
                        for k, v in net.state_dict().items()},
                       tmp / "passt.pt")
            del net
        if not (clap_root / "clap.safetensors").exists():
            _write_clap_checkpoint(torch)
        write_s = time.perf_counter() - t0
        try:
            os.environ.update(env)
            overrides = [
                f"continue_from={checkpoint}", "device=cuda",
                f"datasource.evaluate={data}",
                f"compression_model_checkpoint={codec_dir}",
                "transformer_lm.dtype=bfloat16",
                f"dataset.segment_duration={EVAL_SECONDS}",
                f"dataset.evaluate.num_samples={EVAL_SEGMENTS}",
                f"dataset.evaluate.batch_size={EVAL_BATCH}",
                "dataset.evaluate.num_workers=0",
                f"metrics.fad.vggish.model_path={tmp / 'vggish.pth'}",
                "metrics.text_consistency.clap.model_path="
                f"{clap_root / 'clap.safetensors'}", "logging.level=WARNING"]
            argv = ["musicgen.musicgen_pretrained_32khz_eval", "--run",
                    "--max-jobs", "1"]
            for override in overrides:
                argv += ["-o", override]
            patch(train, "get_solver", keep_solver)
            for name, getter in (("fad", "get_fad"), ("kld", "get_kldiv"),
                                 ("text_consistency", "get_text_consistency"),
                                 ("chroma_cosine",
                                  "get_chroma_cosine_similarity")):
                patch(builders, getter,
                      timed_metric(name, getattr(builders, getter)))
            patch(vggish, "waveform_to_examples",
                  host_timed("fad", vggish.waveform_to_examples))
            patch(passt, "passt_mel", host_timed("kld", passt.passt_mel))
            patch(clap.CLAPEmbedder, "mels",
                  host_timed("text_consistency", clap.CLAPEmbedder.mels))
            torch.cuda.reset_peak_memory_stats()
            decode_attention.launches = 0
            k2_before = (fca.launches, fca.backward_launches)
            t0 = time.perf_counter()
            jobs = grid_main(argv)
            main_s = time.perf_counter() - t0
            k1 = decode_attention.launches
            k2 = (fca.launches - k2_before[0],
                  fca.backward_launches - k2_before[1])
            peak = torch.cuda.max_memory_allocated()
        finally:
            for obj, name, value in reversed(patched):
                setattr(obj, name, value)
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        solver, result, metrics = held["solver"], held["result"], \
            held["metrics"]
        if len(jobs) != 1 or solver.cfg.get("execute_only") != "evaluate" \
                or solver.cfg.get("continue_from") != str(checkpoint):
            raise AssertionError(f"evaluate: the grid ran {len(jobs)} jobs "
                                 f"with {solver.cfg.get('continue_from')}")
        missing = [k for k in EVAL_KEYS if k not in result]
        if missing or "fad_logmel" in result or not all(
                math.isfinite(v) for v in result.values()):
            raise AssertionError(f"evaluate: result {result}, missing "
                                 f"{missing}")
        batches = len(held["generate_s"])
        if batches != EVAL_SEGMENTS // EVAL_BATCH:
            raise AssertionError(f"evaluate: {batches} batches generated")
        frames = EVAL_SECONDS * TOKENS_PER_SECOND
        expected = batches * _k1_launches(solver.model, frames)
        if k1 != expected:
            raise AssertionError(f"evaluate: K1 launched {k1} times, "
                                 f"expected {expected}")
        device = torch.device("cuda", torch.cuda.current_device())
        towers = {"lm": solver.model, "codec": solver.compression_model,
                  "vggish": metrics["fad"].embed_fn.model,
                  "passt": metrics["kld"].classifier_fn.model,
                  "clap": metrics["text_consistency"].embedder.model,
                  "chroma": metrics["chroma_cosine"].extractor}
        for module in towers.values():
            check_module_device(module, device)
        widths = {f"{name}_params": sum(p.numel() for p in m.parameters())
                  for name, m in towers.items() if name != "chroma"}
        widths["passt_blocks"] = len(towers["passt"].blocks)

        # the towers on generated clips, card against the CPU
        clips, texts = held["clips"], held["texts"]
        cpu = {"fad": vggish.VGGishEmbedder(vggish.load_vggish_params(
                   tmp / "vggish.pth"), device="cpu"),
               "kld": passt.PasstClassifier(passt.load_passt_params(
                   tmp / "passt.pt"), max_duration=20.0, device="cpu"),
               "clap": clap.CLAPEmbedder.from_checkpoint(
                   clap_root / "clap.safetensors", "cpu")}
        tc = metrics["text_consistency"]
        pairs = {
            "vggish_embeddings": (metrics["fad"].embed_fn(clips, 32000),
                                  cpu["fad"](clips, 32000)),
            "passt_probabilities": (metrics["kld"].classifier_fn(clips,
                                                                 32000),
                                    cpu["kld"](clips, 32000)),
            "clap_audio_embeddings": (tc.embed_audio_fn(clips, 32000).cpu(),
                                      cpu["clap"].embed_audio(clips, 32000)),
            "clap_text_embeddings": (tc.embed_text_fn(texts).cpu(),
                                     cpu["clap"].embed_text(texts))}
        drifts = {name: _rel_l2(got, want)
                  for name, (got, want) in pairs.items()}
        bad = {k: v for k, v in drifts.items() if not v <= EVAL_TOWER_RTOL}
        if bad:
            raise AssertionError(f"evaluate: card vs CPU drifts {bad} > "
                                 f"{EVAL_TOWER_RTOL}")
        left = _children()
        if left:
            raise AssertionError(f"evaluate: processes left running: {left}")
        per_batch = [{"generate_s": held["generate_s"][i],
                      **{name: updates[name][i] for name in updates}}
                     for i in range(batches)]
        emit("evaluate", card=card,
             config="grid musicgen.musicgen_pretrained_32khz_eval, first job"
                    " (solver=musicgen: MusicGen-small LM, T5-base, d 1024,"
                    " 24 layers, 4 x 2048 codes; the data_train checkpoint, "
                    "bf16 autocast; the 32 kHz EnCodec package); towers f32 "
                    "without TF32: VGGish (6 convolutions 64-512, 12288 -> "
                    "4096 -> 4096 -> 128), PaSST-S (12 blocks, d 768, 12 "
                    "heads, 99 time positions, 527 classes), CLAP HTSAT-base "
                    "+ RoBERTa-base; seeded random weights",
             argv=argv, towers=widths, checkpoints_write_s=write_s,
             segments=EVAL_SEGMENTS, batch=EVAL_BATCH,
             seconds_per_clip=EVAL_SECONDS, result=result,
             per_batch=per_batch, compute_s=computes,
             evaluate_s=held["evaluate_s"], grid_main_s=main_s,
             evaluate_s_per_clip=held["evaluate_s"] / EVAL_SEGMENTS,
             k1_launches=k1, k1_launches_expected=expected,
             k2_forward_launches=k2[0], k2_backward_launches=k2[1],
             card_vs_cpu=dict(clips=EVAL_CHECK_CLIPS, rel_l2=drifts,
                              rel_l2_tol=EVAL_TOWER_RTOL),
             max_memory_allocated=peak, resident_before=resident,
             processes_left=len(left),
             phase_s=time.perf_counter() - phase_t0)
        return k1
    finally:
        held.clear()
        shutil.rmtree(tmp, ignore_errors=True)
        _release(torch)


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
    for kind, err in phase_graph_kernel(torch, S).items():
        worst[kind] = max(worst[kind], err)
    flash_worst, flash_timing = phase_flash_kernels(torch)
    k4_worst, k4_timings = phase_cross_attention_kernels(torch)
    phase_reference(torch)
    phase_reference_train(torch)
    launches, k4_launches, music = phase_slice(torch, card)
    train_launches, solver, batch = phase_train(torch, card)
    remat = phase_train_remat(torch, card, solver, batch)
    phase_resume(torch, card, solver, batch)
    phase_parallel(torch, card, solver, batch)
    del solver, batch
    _release(torch)
    phase_magnet_train(torch, card)
    phase_style_train(torch, card)
    int4_worst, int4_timings = phase_int4_kernels(torch)
    int4_launches = phase_int4_path(torch, card)
    variants_worst = phase_variants(torch, card)
    melody_launches, melody_worst, melody_timings = phase_melody(torch, card)
    audiogen_launches, audiogen_worst, audiogen_timings = phase_audiogen(
        torch, card)
    style_launches, style_worst, style_timings = phase_style(torch, card)
    phase_magnet(torch, card)
    phase_mbd(torch, card)
    phase_audioseal(torch, card, music)
    phase_jasco(torch, card)
    loaders_launches, codec_dir = phase_loaders(torch, card)
    phase_mbd_train(torch, card, codec_dir)
    phase_jasco_train(torch, card, codec_dir)
    phase_codec_train(torch, card)
    phase_watermark_train(torch, card)
    clap_launches = phase_clap(torch, card)
    phase_dac(torch, card)
    data_launches, data, checkpoint = phase_data_train(torch, card, codec_dir)
    try:
        eval_launches = phase_evaluate(torch, card, codec_dir, data,
                                       checkpoint)
    finally:
        shutil.rmtree(data.parent)
    shutil.rmtree(codec_dir.parent)
    left = _children()
    if left:
        raise AssertionError(f"processes left running: {left}")
    launches += (melody_launches + audiogen_launches + style_launches
                 + loaders_launches + clap_launches + data_launches
                 + eval_launches)
    timings += melody_timings + audiogen_timings + style_timings

    main_t = timings[0]
    k1_err = max(list(worst.values()) + list(variants_worst.values())
                 + list(melody_worst.values()) + list(audiogen_worst.values())
                 + list(style_worst.values()))
    fwd, bwd = flash_timing[1500]["forward"], flash_timing[1500]["backward"]
    fwd1501, bwd1501 = flash_timing[1501]["forward"], flash_timing[1501]["backward"]
    int4_t = int4_timings[0]  # the JAX script's length, S - S // 4
    print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "audiocraft_tpu_torch/csrc/decode_attention.cu",
        "replaces": "audiocraft_tpu/ops/flash_attention.py:95",
        "launches": launches, "max_abs_err": k1_err,
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
        "shape": {k: main_t[k] for k in ("B", "S", "H", "D", "length",
                                          "cache")},
        "design": "cluster split-S + cp.async ring + scale folding",
        "timings": [{k: t[k] for k in ("B", "S", "H", "length", "cache",
                                       "n_split", "ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "roofline_share")}
                    for t in timings],
        "replaced_design": "block per (head, row), register loads"}, {
        "name": "flash_causal_attention", "route": "cuda",
        "source": "audiocraft_tpu_torch/csrc/flash_causal_attention.cu",
        "replaces": "audiocraft_tpu/ops/attention.py:65",
        "launches": train_launches[0], "max_abs_err": max(flash_worst.values()),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "backward_launches": train_launches[1],
        "launches_per_train_step_by_checkpointing": remat,
        "backward_ms": bwd["ms"],
        "backward_plain_ms": bwd["plain_ms"],
        "backward_bound_ms": bwd["bound_ms"],
        "backward_bound_by": bwd["bound_by"],
        "backward_library_ms": bwd["library_ms"],
        "shape": {"B": 16, "T": 1500, "H": 16, "D": 64,
                  "dtype": "bfloat16"},
        "design": "wgmma+tma",
        "t1501": {"ms": fwd1501["ms"], "library_ms": fwd1501["library_ms"],
                  "bound_ms": fwd1501["bound_ms"],
                  "backward_ms": bwd1501["ms"],
                  "backward_library_ms": bwd1501["library_ms"],
                  "backward_bound_ms": bwd1501["bound_ms"]},
        "replaced_design": "mma.sync+cp.async"}, {
        "name": "int4_decode_attention", "route": "cuda",
        "source": "audiocraft_tpu_torch/csrc/int4_decode_attention.cu",
        "replaces": "scripts/pallas_int4_decode.py:190",
        "launches": int4_launches, "max_abs_err": int4_worst,
        "ms": int4_t["ms"], "plain_ms": int4_t["plain_ms"],
        "bound_ms": int4_t["bound_ms"], "bound_by": int4_t["bound_by"],
        "library_ms": None, "k1_int8_ms": int4_t["k1_int8_ms"],
        "k1_bf16_ms": int4_t["k1_bf16_ms"],
        "shape": {k: int4_t[k] for k in ("B", "S", "H", "D", "length")},
        "design": "cluster split-S + cp.async ring, running max per tile",
        "replaced_design": "block per (head, row), three phases over the "
                           "window in shared memory"}, {
        "name": "cross_attention_step", "route": "cuda",
        "source": "audiocraft_tpu_torch/csrc/cross_attention_step.cu",
        "replaces": None, "launches": k4_launches,
        "max_abs_err": max(k4_worst.values()),
        "ms": k4_timings[0]["ms"], "plain_ms": k4_timings[0]["plain_ms"],
        "bound_ms": k4_timings[0]["bound_ms"],
        "bound_by": k4_timings[0]["bound_by"],
        "library_ms": k4_timings[0]["library_ms"],
        "einsum_ms": k4_timings[0]["einsum_ms"],
        "shape": {k: k4_timings[0][k] for k in ("B", "H", "Tc", "D", "dtype")},
        "timings": k4_timings,
        "design": "warp per (row, head) or 2-4 warps combined in shared "
                  "memory, every load of a tile in flight at once",
        "replaced_design": "the plain attention's upcast, head-order copies, "
                           "f32 GEMV, softmax and P.V"}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

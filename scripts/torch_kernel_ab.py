#!/usr/bin/env python3
"""Time variants of one kernel source against each other on one card, in one
process.

    python3 scripts/torch_kernel_ab.py A.cu B.cu [...] [--shape 16,1500,16,64]
    python3 scripts/torch_kernel_ab.py --kernel decode_attention A.cu B.cu
    python3 scripts/torch_kernel_ab.py --kernel int4_decode_attention A.cu B.cu

Each source must export the C interface of the same file under
`audiocraft_tpu_torch/csrc/` (`--kernel`, default flash_causal_attention).
Every variant is compiled with the port's nvcc flags (and `-I csrc`, for the
shared headers) into its own library under `build/kernels/ab/`, then run on
the same inputs. The variants run in turns, first to last and then last to
first, so that a drift of the card shows as a difference between a variant's
two rows. Prints one JSON line per run and case with the largest difference
of its outputs from the first variant's, and the card's name and power limit.
Needs one CUDA card.

  flash_causal_attention  bf16 q, k, v as chunks of one fused [B, T, 3HD]
      tensor (--shape B,T,H,D): forward, then backward, each the mean of 30
      back-to-back launches between CUDA events after a warm-up.
  decode_attention  K1 at MusicGen-small's decode shape (H 16, D 64, cache
      S 504, bf16 q): B 4 over a bf16 cache, B 32 and B 512 over an int8
      cache, B 512 over a bf16 cache, all at length 504 (or --cases
      B:cache:length,...). A source whose `decode_attention_launch` reads
      the length from the device (`const int* length`) gets it as an int32
      tensor and the cluster size `split_count(B, H, S)` of the cache's
      capacity; one that takes the window [lo, hi) on the host gets
      `split_count(B, H, length)` where it takes `n_split`, and an older one
      none (--split forces a cluster size on both).
  int4_decode_attention  K3 at scripts/pallas_int4_decode.py's shape
      (B 512, H 16, S 512, D 64, bf16 q) at lengths 384 and 512; `n_split`
      as for decode_attention.
For the decode kernels each time is `utils.timing.time_ms` (median of 50
calls, each with its own CUDA events, L2 flushed), as in `chip_smoke.py`.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECODE_CASES = "4:bfloat16:504,32:int8:504,512:int8:504,512:bfloat16:504"


def _compile(sources):
    """A ctypes library for each source, compiled in parallel."""
    from audiocraft_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        lib = out_dir / f"variant{i}.so"
        procs.append((subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(lib), src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib))
    libs = []
    for proc, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def _takes_split(src: str, symbol: str) -> bool:
    """Whether the source's C function `symbol` takes an `n_split` argument."""
    match = re.search(r'extern "C" int ' + symbol + r"\s*\(([^)]*)\)",
                      Path(src).read_text())
    return bool(match and "n_split" in match.group(1))


def _in_turns(n):
    order = list(range(n))
    return order + order[::-1]


def ab_flash(torch, args, card):
    fns = []
    for cdll in _compile(args.sources):
        fwd, bwd = cdll.flash_causal_fwd_launch, cdll.flash_causal_bwd_launch
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        fns.append((fwd, bwd))

    B, T, H, D = (int(x) for x in args.shape.split(","))
    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(B, T, 3 * H * D, device="cuda", generator=g).bfloat16()
    q, k, v = (t.reshape(B, T, H, D) for t in x.chunk(3, dim=-1))
    dout = torch.randn(B, T, H, D, device="cuda", generator=g).bfloat16()
    out, dq, dk, dv = (torch.empty_like(dout) for _ in range(4))
    lse, delta = (torch.empty(B, H, T, device="cuda") for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream

    def strides(*ts):
        values = [s for t in ts for s in t.stride()[:3]]
        return (ctypes.c_longlong * len(values))(*values)

    def run_fwd(fwd):
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, T, H, D, 1, strides(q, k, v, out), stream)
        assert err == 0, f"forward launch failed: CUDA error {err}"

    def run_bwd(bwd):
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, D, 1,
                  strides(q, k, v, dout), stream)
        assert err == 0, f"backward launch failed: CUDA error {err}"

    def mean_ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.calls

    first = None
    for i in _in_turns(len(fns)):
        fwd, bwd = fns[i]
        run_fwd(fwd)
        run_bwd(bwd)
        torch.cuda.synchronize()
        result = torch.cat([t.flatten().float() for t in (out, dq, dk, dv)])
        first = result.clone() if first is None else first
        print(json.dumps({
            "source": args.sources[i], "shape": dict(B=B, T=T, H=H, D=D),
            "card": card, "forward_ms": mean_ms(lambda: run_fwd(fwd)),
            "backward_ms": mean_ms(lambda: run_bwd(bwd)),
            "max_diff_from_first": (result - first).abs().max().item()}),
            flush=True)


def _takes_device_length(src: str, symbol: str) -> bool:
    """Whether the source's C function `symbol` reads its length from the
    device (a `const int* length` argument)."""
    match = re.search(r'extern "C" int ' + symbol + r"\s*\(([^)]*)\)",
                      Path(src).read_text())
    return bool(match and re.search(r"const int\s*\*\s*length",
                                    match.group(1)))


def _decode_fns(args, symbol, n_ints):
    """(launch function, takes n_split, reads a device length) per source;
    the pointer arguments (one more for a device length), n_ints ints (one
    fewer) and the stream, then n_split where the source takes it."""
    fns = []
    for src, cdll in zip(args.sources, _compile(args.sources)):
        fn = getattr(cdll, symbol)
        split = _takes_split(src, symbol)
        device = _takes_device_length(src, symbol)
        fn.argtypes = ([ctypes.c_void_p] * (6 + device)
                       + [ctypes.c_int] * (n_ints - device)
                       + [ctypes.c_void_p] + ([ctypes.c_int] if split else []))
        fn.restype = ctypes.c_int
        fns.append((fn, split, device))
    return fns


def _run_cases(torch, args, card, fns, cases):
    """cases: [(name, fields, launch(fn, split, out) -> err, out)]; each
    variant on each case in turns, timed by `time_ms`."""
    from audiocraft_tpu_torch.utils.timing import time_ms
    first = {}
    for i in _in_turns(len(fns)):
        fn, split, device = fns[i]
        for name, fields, launch, out in cases:
            def call():
                err = launch(fn, split, device, out)
                assert err == 0, f"{name}: launch failed: CUDA error {err}"
            call()
            torch.cuda.synchronize()
            result = out.float().clone()
            first.setdefault(name, result)
            ms = time_ms(call, flush_bytes=128 << 20)
            n_split = (fields["n_split_device"] if device
                       else fields["n_split"] if split else None)
            print(json.dumps({
                "kernel": args.kernel, "source": args.sources[i],
                "case": name, **{k: v for k, v in fields.items()
                                 if not k.startswith("n_split")},
                "device_length": device, "n_split": n_split, "card": card,
                "ms": ms,
                "max_diff_from_first": (result - first[name]).abs().max()
                .item()}), flush=True)


def ab_decode(torch, args, card):
    from audiocraft_tpu_torch.modules.transformer import KVCache
    from audiocraft_tpu_torch.ops.decode_attention import (
        _DTYPE_CODES, _sm_count, split_count)
    fns = _decode_fns(args, "decode_attention_launch", 8)
    H, D, S = 16, 64, 504
    g = torch.Generator("cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for case in args.cases.split(","):
        B, kind, length = case.split(":")
        B, length = int(B), int(length)
        q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
        k, v = (torch.randn(B, S, H, D, device="cuda", generator=g)
                for _ in range(2))
        ks = vs = None
        if kind == "int8":
            (k, ks), (v, vs) = KVCache._quantize(k), KVCache._quantize(v)
        else:
            k, v = k.to(getattr(torch, kind)), v.to(getattr(torch, kind))
        sms = _sm_count(q.device.index)
        n = args.split or split_count(B, H, length, sms)
        n_device = args.split or split_count(B, H, S, sms)
        device_length = torch.tensor([length], dtype=torch.int32,
                                     device="cuda")
        out = torch.empty_like(q)

        def launch(fn, split, device, out, q=q, k=k, v=v, ks=ks, vs=vs, B=B,
                   length=length, n=n, n_device=n_device,
                   device_length=device_length):
            pointers = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        ks.data_ptr() if ks is not None else None,
                        vs.data_ptr() if vs is not None else None,
                        out.data_ptr()]
            if device:  # the length on the device, no window
                return fn(*pointers, device_length.data_ptr(), B, S, H, D,
                          -1, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
                          stream, n_device)
            return fn(*pointers, B, S, H, D, 0, length,
                      _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], stream,
                      *([n] if split else []))
        cases.append((case, dict(B=B, S=S, H=H, D=D, length=length,
                                 cache=kind, n_split=n,
                                 n_split_device=n_device), launch, out))
    _run_cases(torch, args, card, fns, cases)


def ab_int4(torch, args, card):
    from audiocraft_tpu_torch.ops.decode_attention import _sm_count, split_count
    from audiocraft_tpu_torch.ops.int4_decode_attention import (
        _DTYPE_CODES, quant_pack_kv)
    fns = _decode_fns(args, "int4_decode_attention_launch", 7)
    B, H, S, D = 512, 16, 512, 64
    g = torch.Generator("cuda").manual_seed(0)
    q = torch.randn(B, H, D, device="cuda", generator=g).bfloat16()
    k, v = (torch.randn(B, S, H, D, device="cuda", generator=g).bfloat16()
            for _ in range(2))
    packed = quant_pack_kv(k, v)
    del k, v
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for length in (384, 512):
        n = args.split or split_count(B, H, length, _sm_count(q.device.index))
        out = torch.empty_like(q)

        def launch(fn, split, device, out, length=length, n=n):
            return fn(q.data_ptr(), *(t.data_ptr() for t in packed),
                      out.data_ptr(), B, S, H, D, 0, length,
                      _DTYPE_CODES[q.dtype], stream, *([n] if split else []))
        cases.append((f"length_{length}", dict(B=B, S=S, H=H, D=D,
                                               length=length, n_split=n),
                      launch, out))
    _run_cases(torch, args, card, fns, cases)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--kernel", default="flash_causal_attention",
                        choices=["flash_causal_attention", "decode_attention",
                                 "int4_decode_attention"])
    parser.add_argument("--shape", default="16,1500,16,64",
                        help="B,T,H,D of flash_causal_attention's inputs")
    parser.add_argument("--cases", default=DECODE_CASES,
                        help="decode_attention's B:cache:length,...")
    parser.add_argument("--calls", type=int, default=30)
    parser.add_argument("--split", type=int, default=0,
                        help="cluster size for sources that take n_split "
                             "(default: the wrapper's split_count)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    {"flash_causal_attention": ab_flash, "decode_attention": ab_decode,
     "int4_decode_attention": ab_int4}[args.kernel](torch, args, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

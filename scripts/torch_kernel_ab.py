#!/usr/bin/env python3
"""Time variants of the causal flash-attention kernel source against each
other on one card, in one process.

    python3 scripts/torch_kernel_ab.py A.cu B.cu [...] [--shape 16,1500,16,64]

Each source must export the C interface of
`audiocraft_tpu_torch/csrc/flash_causal_attention.cu`. Every variant is
compiled with the port's nvcc flags into its own library under
`build/kernels/ab/`, then run on the same bf16 inputs (q, k, v as chunks of
one fused [B, T, 3HD] tensor): forward, then backward, each the mean of 30
back-to-back launches between CUDA events after a warm-up. The variants run
in turns, first to last and then last to first, so that a drift of the card
shows as a difference between a variant's two rows. Prints one JSON line per
run with the largest difference of its outputs and gradients from the first
variant's, and the card's name and power limit. Needs one CUDA card.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--shape", default="16,1500,16,64",
                        help="B,T,H,D of the bf16 inputs")
    parser.add_argument("--calls", type=int, default=30)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from audiocraft_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(args.sources):
        lib = out_dir / f"variant{i}.so"
        procs.append((subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib))
    fns = []
    for proc, lib in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
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
    order = list(range(len(fns)))
    for i in order + order[::-1]:
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

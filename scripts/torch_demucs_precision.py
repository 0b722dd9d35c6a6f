#!/usr/bin/env python3
"""How far the port's HTDemucs is from its own float64 result, on the CPU
and on the CUDA card.

    python3 scripts/torch_demucs_precision.py [--seed 0]

Builds the published htdemucs configuration with seeded random weights and
separates one 7.8 s segment of 44.1 kHz stereo harmonic audio four ways:
f32 and f64 on the CPU, f32 and f64 on the card (TF32 off). Prints one JSON
line: the largest absolute difference of each from the CPU's f64 output,
the output's scale, and the card f32 error once more with an inverse STFT
that passes the spectrum's DC and Nyquist imaginary parts to cuFFT as they
are (`ops.stft.istft` clears them). Needs one CUDA card.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path


def raw_istft(torch):
    """`ops.stft.istft` without clearing the DC and Nyquist imaginary
    parts: torch.istft on the spectrum as it is."""
    from audiocraft_tpu_torch.ops.stft import _full_window, _norm_factor

    def istft(z, n_fft, hop_length, win_length=None, window=None,
              center=True, normalized=False, length=None):
        window = _full_window(n_fft, win_length, window, z.device,
                              z.real.dtype)
        *batch, bins, frames = z.shape
        z = z.reshape(-1, bins, frames)
        factor = _norm_factor(normalized, n_fft, window)
        if factor is not None:
            z = z * factor
        x = torch.istft(z, n_fft, hop_length, win_length=n_fft, window=window,
                        center=center, normalized=False, onesided=True,
                        length=length)
        return x.reshape(*batch, x.shape[-1])
    return istft


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from audiocraft_tpu_torch.modules import demucs
    if not torch.cuda.is_available():
        print("torch_demucs_precision: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    torch.manual_seed(args.seed)
    state = demucs.HTDemucs().state_dict()
    t = torch.arange(int(7.8 * 44100)) / 44100
    mix = sum(0.3 / h * torch.sin(2 * torch.pi * h * 261.6 * t)
              for h in (1, 2, 3))[None, None].repeat(1, 2, 1)

    def run(device, dtype):
        model = demucs.HTDemucs().to(device=device, dtype=dtype).eval()
        model.load_state_dict(state)
        with torch.no_grad():
            return model(mix.to(device=device, dtype=dtype)).cpu().double()

    reference = run("cpu", torch.float64)
    errors = {f"{device}_{str(dtype)[6:]}": (run(device, dtype) - reference)
              .abs().max().item()
              for device in ("cpu", "cuda")
              for dtype in (torch.float32, torch.float64)}
    cleared = demucs.istft
    demucs.istft = raw_istft(torch)
    try:
        errors["cuda_float32_dc_imaginary_kept"] = (
            run("cuda", torch.float32) - reference).abs().max().item()
    finally:
        demucs.istft = cleared
    print(json.dumps({"card": card, "model": "htdemucs (published "
                      "configuration, seeded random weights)",
                      "input": "7.8 s of 44.1 kHz stereo harmonic audio",
                      "output_max_abs": reference.abs().max().item(),
                      "max_abs_err_vs_cpu_float64": errors}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

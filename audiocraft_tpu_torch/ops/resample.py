"""Polyphase windowed-sinc resampling (counterpart of
`audiocraft_tpu/ops/resample.py`, itself a julius-equivalent
`resample_frac`).

The filter bank is built in numpy float64 exactly as the JAX package builds
it, then applied as one strided `conv1d` whose output channels are the
phases.
"""
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _resample_kernel(p: int, q: int, zeros: int = 24, rolloff: float = 0.945
                     ) -> np.ndarray:
    """Kernel bank [p, W] for upsampling by p and downsampling by q: output
    sample n * p + phase sits at input time n * q + phase * q / p, and
    kernel[phase, j] = h(j - half - phase * q / p) for the Hann-windowed
    low-pass sinc h."""
    cutoff = rolloff * min(1.0, p / q)          # relative to input Nyquist
    half = int(math.ceil(zeros / cutoff))       # half support in input samples
    width = 2 * half + 1 + (q - 1)              # extra taps for phase shifts < q
    j = np.arange(width, dtype=np.float64)
    kernels = []
    for phase in range(p):
        t = j - half - (phase * q) / p
        sinc = cutoff * np.sinc(cutoff * t)
        warg = t / half
        window = np.where(np.abs(warg) <= 1.0,
                          0.5 * (1.0 + np.cos(np.pi * warg)), 0.0)
        kernels.append(sinc * window)
    return np.stack(kernels).astype(np.float32)


def resample_frac(x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24,
                  rolloff: float = 0.945) -> torch.Tensor:
    """Resample the last axis of x [..., T] from old_sr to new_sr:
    [..., ceil(T * new_sr / old_sr)], in x's dtype (computed in f32)."""
    if old_sr == new_sr:
        return x
    g = math.gcd(int(old_sr), int(new_sr))
    p, q = new_sr // g, old_sr // g
    kernels = torch.from_numpy(_resample_kernel(p, q, zeros, rolloff)).to(
        x.device)                                   # [p, W]
    W = kernels.shape[1]
    half = (W - (q - 1) - 1) // 2
    shape = x.shape
    T = shape[-1]
    flat = x.float().reshape(-1, 1, T)
    # frames anchored at n * q, taps [n * q - half, n * q - half + W)
    n_frames = (T + q - 1) // q
    pad_right = (n_frames - 1) * q + W - half - T
    flat = F.pad(flat, (half, max(pad_right, 0)))
    y = F.conv1d(flat, kernels[:, None, :], stride=q)   # [N, p, n_frames]
    y = y.transpose(1, 2).reshape(flat.shape[0], -1)    # frame-major, phase-minor
    new_len = int(math.ceil(T * new_sr / old_sr))
    return y[:, :new_len].reshape(*shape[:-1], new_len).to(x.dtype)

"""FIR lowpass filters and mel-spaced band splitting (counterpart of
`audiocraft_tpu/ops/filters.py`, itself a julius-equivalent `SplitBands`).

The Hann-windowed sinc bank is built in numpy float64 as the JAX package
builds it, cast to f32, and applied as one direct `conv1d` whose output
channels are the cutoffs. The half-width follows the lowest cutoff: 3,511
taps for `SplitBands(32000, 32)`, 753 for `SplitBands(32000, 8)`.
"""
import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _lowpass_kernels(cutoffs: tp.Tuple[float, ...], zeros: int = 8
                     ) -> np.ndarray:
    """Kernel bank [F, W] of Hann-windowed sinc lowpass filters; cutoffs are
    fractions of the sample rate in (0, 0.5]."""
    positive = [c for c in cutoffs if c > 0]
    half = int(math.ceil(zeros / (2 * min(positive)))) if positive else 1
    t = np.arange(-half, half + 1, dtype=np.float64)
    window = np.where(np.abs(t / half) <= 1,
                      0.5 * (1 + np.cos(np.pi * t / half)), 0)
    kernels = []
    for c in cutoffs:
        k = np.zeros_like(t)
        if c >= 0.5:
            k[half] = 1.0
        elif c > 0:
            k = 2 * c * np.sinc(2 * c * t) * window
        kernels.append(k)
    return np.stack(kernels).astype(np.float32)


def lowpass_filters(x: torch.Tensor, cutoffs: tp.Sequence[float],
                    zeros: int = 8) -> torch.Tensor:
    """Apply F lowpass filters to x [..., T] (zero-padded by the half-width
    on both sides) -> [F, ..., T], in f32."""
    kernels = torch.from_numpy(_lowpass_kernels(
        tuple(float(c) for c in cutoffs), zeros)).to(x.device)
    n_filters, width = kernels.shape
    half = (width - 1) // 2
    shape = x.shape
    flat = F.pad(x.float().reshape(-1, 1, shape[-1]), (half, half))
    y = F.conv1d(flat, kernels[:, None, :])          # [N, F, T]
    return y.transpose(0, 1).reshape(n_filters, *shape)


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


def mel_frequencies(n_freqs: int, fmin: float, fmax: float) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(np.array(fmin)),
                                 hz_to_mel(np.array(fmax)), n_freqs))


class SplitBands:
    """Split a signal into `n_bands` mel-spaced frequency bands that sum
    back to it."""

    def __init__(self, sample_rate: float, n_bands: int, zeros: int = 8):
        assert n_bands >= 1
        self.sample_rate = sample_rate
        self.n_bands = n_bands
        cutoffs = mel_frequencies(n_bands + 1, 0.0, sample_rate / 2)[1:-1]
        self.cutoffs = tuple(float(c) / sample_rate for c in cutoffs)
        self.zeros = zeros

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., T] -> bands [n_bands, ..., T] with sum(bands) == x."""
        if self.n_bands == 1:
            return x[None]
        lows = lowpass_filters(x, self.cutoffs, self.zeros)  # [F, ..., T]
        return torch.cat([lows[:1], lows[1:] - lows[:-1],
                          (x.float() - lows[-1])[None]])

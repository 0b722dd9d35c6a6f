"""Mel-spectrogram losses (counterpart of `audiocraft_tpu/losses/specloss.py`):
`MelSpectrogramWrapper` pads like a convolution so that frames =
ceil(T / hop), `MelSpectrogramL1Loss`, and `MultiScaleMelSpectrogramLoss`
(linear L1 plus alpha x log L2 at FFT sizes 2^range_start..2^(range_end-1))."""
import typing as tp

import numpy as np
import torch

from ..modules.conv import get_extra_padding_for_conv1d, pad1d
from ..ops.stft import mel_spectrogram


class MelSpectrogramWrapper:
    """[B, C, T] or [B, T] -> [B, C * n_mels, frames]: reflect-padded by
    (n_fft - hop) // 2 on each side, then zero-padded on the right so that
    the last window is full; power 2, not centred; log10(floor + mel) with
    `log`."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 256,
                 win_length: tp.Optional[int] = None, n_mels: int = 80,
                 sample_rate: float = 22050, f_min: float = 0.0,
                 f_max: tp.Optional[float] = None, log: bool = True,
                 normalized: bool = False, floor_level: float = 1e-5):
        self.n_fft = n_fft
        self.hop_length = int(hop_length)
        self.win_length = win_length or n_fft
        self.n_mels = n_mels
        self.sample_rate = int(sample_rate)
        self.f_min = f_min
        self.f_max = f_max
        self.log = log
        self.normalized = normalized
        self.floor_level = floor_level

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None]
        B, C, T = x.shape
        p = int((self.n_fft - self.hop_length) // 2)
        x = pad1d(x.reshape(B * C, T), (p, p), mode="reflect")
        x = pad1d(x, (0, get_extra_padding_for_conv1d(
            x.shape[-1], self.n_fft, self.hop_length)))
        mel = mel_spectrogram(x, self.sample_rate, self.n_fft,
                              self.hop_length, self.win_length, self.n_mels,
                              self.f_min, self.f_max, power=2.0, center=False,
                              normalized=self.normalized)
        if self.log:
            mel = torch.log10(self.floor_level + mel)
        return mel.reshape(B, C * self.n_mels, mel.shape[-1])


class MelSpectrogramL1Loss:
    """Mean |mel(x) - mel(y)| (log mel by default)."""

    def __init__(self, sample_rate: int, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024,
                 n_mels: int = 80, f_min: float = 0.0,
                 f_max: tp.Optional[float] = None, log: bool = True,
                 normalized: bool = False, floor_level: float = 1e-5):
        self.melspec = MelSpectrogramWrapper(
            n_fft=n_fft, hop_length=hop_length, win_length=win_length,
            n_mels=n_mels, sample_rate=sample_rate, f_min=f_min, f_max=f_max,
            log=log, normalized=normalized, floor_level=floor_level)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (self.melspec(x) - self.melspec(y)).abs().mean()


class MultiScaleMelSpectrogramLoss:
    """Sum over scales of the linear mels' L1 and alpha x the log mels'
    squared error (alpha = sqrt(n_fft - 1), or 1 without `alphas`);
    divided by the sum of (alpha + 1) when `normalized`."""

    def __init__(self, sample_rate: int, range_start: int = 6,
                 range_end: int = 11, n_mels: int = 64, f_min: float = 0.0,
                 f_max: tp.Optional[float] = None, normalized: bool = False,
                 alphas: bool = True, floor_level: float = 1e-5):
        self.l1s: tp.List[MelSpectrogramWrapper] = []
        self.l2s: tp.List[MelSpectrogramWrapper] = []
        self.alphas: tp.List[float] = []
        self.total = 0.0
        self.normalized = normalized
        for i in range(range_start, range_end):
            common = dict(n_fft=2 ** i, hop_length=(2 ** i) // 4,
                          win_length=2 ** i, n_mels=n_mels,
                          sample_rate=sample_rate, f_min=f_min, f_max=f_max,
                          normalized=normalized, floor_level=floor_level)
            self.l1s.append(MelSpectrogramWrapper(log=False, **common))
            self.l2s.append(MelSpectrogramWrapper(log=True, **common))
            self.alphas.append(float(np.sqrt(2 ** i - 1)) if alphas else 1.0)
            self.total += self.alphas[-1] + 1

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = 0.0
        for l1, l2, alpha in zip(self.l1s, self.l2s, self.alphas):
            loss = (loss + (l1(x) - l1(y)).abs().mean()
                    + alpha * (l2(x) - l2(y)).square().mean())
        if self.normalized:
            loss = loss / self.total
        return loss

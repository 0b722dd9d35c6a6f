"""Chromagram extraction: a power spectrogram through librosa's chroma
filter bank (counterpart of `audiocraft_tpu/modules/chroma.py`)."""
import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stft import spectrogram


@lru_cache(maxsize=16)
def chroma_filters(sample_rate: int, n_fft: int, n_chroma: int = 12,
                   tuning: float = 0.0, ctroct: float = 5.0,
                   octwidth: tp.Optional[float] = 2.0,
                   base_c: bool = True) -> np.ndarray:
    """Chroma filter bank [n_chroma, 1 + n_fft // 2], librosa's formula:
    each FFT bin maps to a Gaussian over pitch classes around its own
    (width one bin in pitch), columns L2-normalised, weighted by a Gaussian
    over octaves centred on octave `ctroct`, rows starting at C."""
    frequencies = np.linspace(0, sample_rate, n_fft, endpoint=False)[1:]
    pitch = n_chroma * np.log2(frequencies / (440.0 * 2.0 ** (-57 / 12))) - tuning
    pitch = np.concatenate(([pitch[0] - 1.5 * n_chroma], pitch))
    widths = np.concatenate((np.maximum(pitch[1:] - pitch[:-1], 1.0), [1]))
    dist = np.subtract.outer(pitch, np.arange(0, n_chroma, dtype="d")).T
    half = np.round(float(n_chroma) / 2)
    dist = np.remainder(dist + half + 10 * n_chroma, n_chroma) - half
    wts = np.exp(-0.5 * (2 * dist / np.tile(widths, (n_chroma, 1))) ** 2)
    wts /= np.maximum(np.sqrt(np.sum(wts ** 2, axis=0, keepdims=True)), 1e-12)
    if octwidth is not None:
        wts *= np.tile(
            np.exp(-0.5 * (((pitch / n_chroma - ctroct) / octwidth) ** 2)),
            (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, :int(1 + n_fft / 2)], dtype=np.float32)


class ChromaExtractor(nn.Module):
    """wav [B, C, T] or [B, T] -> chroma [B, frames, n_chroma]: mixed down to
    mono, centre-padded to n_fft when shorter, power spectrogram
    (window-normalised, hop winlen // 4), filter bank, inf-norm per frame,
    then with `argmax` the one-hot of each frame's strongest class."""

    def __init__(self, sample_rate: int, n_chroma: int = 12,
                 radix2_exp: int = 12, nfft: tp.Optional[int] = None,
                 winlen: tp.Optional[int] = None,
                 winhop: tp.Optional[int] = None, argmax: bool = False,
                 norm: float = float("inf"), device=None):
        super().__init__()
        self.winlen = winlen or 2 ** radix2_exp
        self.nfft = nfft or self.winlen
        self.winhop = winhop or (self.winlen // 4)
        self.sample_rate = sample_rate
        self.n_chroma = n_chroma
        self.argmax = argmax
        self.norm = norm
        self.register_buffer("fbanks", torch.from_numpy(chroma_filters(
            sample_rate, self.nfft, n_chroma)).to(device), persistent=False)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        wav = wav.float()
        if wav.dim() == 3:
            wav = wav.mean(dim=1)
        T = wav.shape[-1]
        if T < self.nfft:
            pad = self.nfft - T
            wav = F.pad(wav, (math.ceil(pad / 2), pad // 2))
        spec = spectrogram(wav, self.nfft, self.winhop, self.winlen,
                           power=2.0, center=True, normalized=True)
        chroma = torch.einsum("cf,bft->bct", self.fbanks, spec)
        denom = chroma.abs().amax(dim=1, keepdim=True)
        chroma = (chroma / denom.clamp_min(1e-6)).transpose(1, 2)
        if self.argmax:
            idx = chroma.argmax(dim=-1)
            chroma = F.one_hot(idx, self.n_chroma).to(chroma.dtype)
        return chroma

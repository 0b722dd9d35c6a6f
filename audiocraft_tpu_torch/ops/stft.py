"""Short-time Fourier transforms and spectrograms (counterpart of
`audiocraft_tpu/ops/stft.py`), over `torch.stft` / `torch.istft`.

Two normalisations share the `normalized` flag, as in PyTorch and
torchaudio: `stft(normalized=True)` divides by sqrt(n_fft) (torch.stft's
"frame_length"), `spectrogram(normalized=True)` by the window's L2 norm
(torchaudio's Spectrogram, "window"). Either function takes the mode by
name too. `mel_spectrogram` applies the HTK-scale triangular filterbank of
`mel_filters` (torchaudio's `melscale_fbanks`, as the JAX package builds
it in numpy).
"""
import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch

Normalized = tp.Union[bool, str]


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window, as torch.hann_window(periodic=True)."""
    return torch.hann_window(win_length, periodic=True, dtype=dtype,
                             device=device)


def _full_window(n_fft: int, win_length: tp.Optional[int],
                 window: tp.Optional[torch.Tensor], device,
                 dtype) -> torch.Tensor:
    """The window zero-padded on both sides to n_fft (centred)."""
    win_length = win_length or n_fft
    if window is None:
        window = hann_window(win_length, device=device)
    window = window.to(device=device, dtype=dtype)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = torch.nn.functional.pad(window,
                                         (left, n_fft - win_length - left))
    return window


def _norm_factor(normalized: Normalized, n_fft: int,
                 window: torch.Tensor) -> tp.Optional[torch.Tensor]:
    """The divisor of a normalised transform: sqrt(n_fft) for True or
    "frame_length", the window's L2 norm for "window", None for False."""
    if normalized is False or normalized is None:
        return None
    if normalized is True or normalized == "frame_length":
        return torch.tensor(math.sqrt(n_fft), dtype=window.dtype,
                            device=window.device)
    if normalized == "window":
        return window.square().sum().sqrt()
    raise ValueError(f"unknown normalized mode: {normalized!r}")


def stft(x: torch.Tensor, n_fft: int, hop_length: int,
         win_length: tp.Optional[int] = None,
         window: tp.Optional[torch.Tensor] = None, center: bool = True,
         pad_mode: str = "reflect",
         normalized: Normalized = False) -> torch.Tensor:
    """x [..., T] (f32 or f64) -> complex [..., n_fft // 2 + 1, frames]."""
    window = _full_window(n_fft, win_length, window, x.device, x.dtype)
    *batch, T = x.shape
    spec = torch.stft(x.reshape(-1, T), n_fft, hop_length,
                      win_length=n_fft, window=window, center=center,
                      pad_mode=pad_mode, normalized=False, onesided=True,
                      return_complex=True)
    factor = _norm_factor(normalized, n_fft, window)
    if factor is not None:
        spec = spec / factor
    return spec.reshape(*batch, *spec.shape[-2:])


def istft(z: torch.Tensor, n_fft: int, hop_length: int,
          win_length: tp.Optional[int] = None,
          window: tp.Optional[torch.Tensor] = None, center: bool = True,
          normalized: Normalized = False,
          length: tp.Optional[int] = None) -> torch.Tensor:
    """Inverse of `stft`: complex [..., n_fft // 2 + 1, frames] -> [..., T]
    by windowed overlap-add over the squared window; with `length`, cut or
    zero-padded to it."""
    window = _full_window(n_fft, win_length, window, z.device, z.real.dtype)
    *batch, bins, frames = z.shape
    # the imaginary parts of the DC bin and (even n_fft) of the Nyquist bin
    # do not enter a real inverse (the JAX package's inverse DFT drops
    # them); they are cleared, because cuFFT's f32 inverse reads them
    parts = torch.view_as_real(z.reshape(-1, bins, frames)).clone()
    parts[:, 0, :, 1] = 0
    if n_fft % 2 == 0:
        parts[:, -1, :, 1] = 0
    z = torch.view_as_complex(parts)
    factor = _norm_factor(normalized, n_fft, window)
    if factor is not None:
        z = z * factor
    x = torch.istft(z, n_fft, hop_length, win_length=n_fft, window=window,
                    center=center, normalized=False, onesided=True,
                    length=length)
    return x.reshape(*batch, x.shape[-1])


def spectrogram(x: torch.Tensor, n_fft: int, hop_length: int,
                win_length: tp.Optional[int] = None, power: float = 2.0,
                center: bool = True, normalized: Normalized = False,
                pad_mode: str = "reflect") -> torch.Tensor:
    """|stft|^power [..., n_fft // 2 + 1, frames], as torchaudio's
    Spectrogram: `normalized=True` divides by the window's L2 norm."""
    if normalized is True:
        normalized = "window"
    s = stft(x, n_fft, hop_length, win_length, center=center,
             normalized=normalized, pad_mode=pad_mode)
    mag2 = s.real.square() + s.imag.square()
    if power == 2.0:
        return mag2
    return mag2 ** (power / 2.0)


def _hz_to_mel(f, htk: bool = True):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f = np.asarray(f, dtype=np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step,
                    f / (200.0 / 3))


def _mel_to_hz(m, htk: bool = True):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)),
                    m * (200.0 / 3))


@lru_cache(maxsize=32)
def mel_filters(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
                f_max: tp.Optional[float] = None, htk: bool = True,
                norm: tp.Optional[str] = None) -> np.ndarray:
    """Triangular mel filterbank [n_fft // 2 + 1, n_mels] (f32, from f64
    numpy): HTK scale by default, Slaney's with `htk=False`; `norm="slaney"`
    scales each filter to unit area."""
    f_max = f_max or sample_rate / 2
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    m_pts = np.linspace(_hz_to_mel(f_min, htk), _hz_to_mel(f_max, htk),
                        n_mels + 2)
    f_pts = _mel_to_hz(m_pts, htk)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int, n_fft: int,
                    hop_length: int, win_length: tp.Optional[int] = None,
                    n_mels: int = 80, f_min: float = 0.0,
                    f_max: tp.Optional[float] = None, power: float = 2.0,
                    center: bool = True, normalized: Normalized = False
                    ) -> torch.Tensor:
    """[..., T] -> [..., n_mels, frames], as torchaudio's MelSpectrogram."""
    spec = spectrogram(x, n_fft, hop_length, win_length, power=power,
                       center=center, normalized=normalized)
    fb = torch.from_numpy(mel_filters(sample_rate, n_fft, n_mels, f_min,
                                      f_max)).to(spec.device, spec.dtype)
    return torch.einsum("...bf,bm->...mf", spec, fb)

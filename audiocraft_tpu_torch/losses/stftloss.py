"""STFT losses: spectral convergence and log magnitude over one or several
resolutions (counterpart of `audiocraft_tpu/losses/stftloss.py`)."""
import typing as tp

import numpy as np
import torch

from ..ops.stft import stft

_EPS = float(np.finfo(np.float32).eps)


def _stft_mag(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
              normalized: bool, eps: float = _EPS) -> torch.Tensor:
    """Magnitude STFT [B * C, frames, bins] of x [B, C, T] (Hann window,
    centred), floored at eps."""
    B, C, T = x.shape
    s = stft(x.reshape(B * C, T), n_fft, hop_length, win_length,
             normalized=normalized)
    mag2 = s.real.square() + s.imag.square()
    return mag2.clamp_min(eps ** 2).sqrt().transpose(-1, -2)


def spectral_convergence(x_mag: torch.Tensor, y_mag: torch.Tensor,
                         epsilon: float = _EPS) -> torch.Tensor:
    """||Y - X||_F / ||Y||_F."""
    return (torch.linalg.norm((y_mag - x_mag).flatten())
            / (torch.linalg.norm(y_mag.flatten()) + epsilon))


def log_stft_magnitude(x_mag: torch.Tensor, y_mag: torch.Tensor,
                       epsilon: float = _EPS) -> torch.Tensor:
    """L1 between log magnitudes."""
    return (torch.log(y_mag + epsilon) - torch.log(x_mag + epsilon)).abs().mean()


class STFTLosses:
    """(spectral convergence, log magnitude) at one resolution."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 120,
                 win_length: int = 600, normalized: bool = False,
                 epsilon: float = _EPS):
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.normalized = normalized
        self.epsilon = epsilon

    def __call__(self, x: torch.Tensor, y: torch.Tensor):
        x_mag = _stft_mag(x, self.n_fft, self.hop_length, self.win_length,
                          self.normalized)
        y_mag = _stft_mag(y, self.n_fft, self.hop_length, self.win_length,
                          self.normalized)
        return (spectral_convergence(x_mag, y_mag, self.epsilon),
                log_stft_magnitude(x_mag, y_mag, self.epsilon))


class STFTLoss:
    """factor_sc x spectral convergence + factor_mag x log magnitude."""

    def __init__(self, n_fft: int = 1024, hop_length: int = 120,
                 win_length: int = 600, normalized: bool = False,
                 factor_sc: float = 0.1, factor_mag: float = 0.1):
        self.loss = STFTLosses(n_fft, hop_length, win_length, normalized)
        self.factor_sc = factor_sc
        self.factor_mag = factor_mag

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc_loss, mag_loss = self.loss(x, y)
        return self.factor_sc * sc_loss + self.factor_mag * mag_loss


class MRSTFTLoss:
    """`STFTLoss` with each term averaged over several resolutions."""

    def __init__(self, n_ffts: tp.Sequence[int] = (1024, 2048, 512),
                 hop_lengths: tp.Sequence[int] = (120, 240, 50),
                 win_lengths: tp.Sequence[int] = (600, 1200, 240),
                 factor_sc: float = 0.1, factor_mag: float = 0.1,
                 normalized: bool = False):
        assert len(n_ffts) == len(hop_lengths) == len(win_lengths)
        self.losses = [STFTLosses(fs, ss, wl, normalized)
                       for fs, ss, wl in zip(n_ffts, hop_lengths, win_lengths)]
        self.factor_sc = factor_sc
        self.factor_mag = factor_mag

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sc_loss = mag_loss = 0.0
        for f in self.losses:
            sc_l, mag_l = f(x, y)
            sc_loss = sc_loss + sc_l
            mag_loss = mag_loss + mag_l
        sc_loss = sc_loss / len(self.losses)
        mag_loss = mag_loss / len(self.losses)
        return self.factor_sc * sc_loss + self.factor_mag * mag_loss

"""Loudness losses for the inaudibility of a watermark (counterpart of
`audiocraft_tpu/losses/loudnessloss.py`): a simplified BS.1770 loudness
(K-weighting biquads, then gated blocks) and the time, frequency and
time-frequency loudness ratios of the noise to the reference, weighted by
a softmax over the frames.

The biquad is exact and runs without a loop over samples. It is written
in its transposed direct form II state space, state s (2 numbers), output
y[n] = b0 x[n] + C s[n-1], s[n] = A s[n-1] + Bx x[n], and taken in chunks
of L samples: inside a chunk, the response from zero state is one product
with the L x L lower-triangular Toeplitz matrix of the filter's impulse
response, and the state carried into the chunk adds C A^i s. Across
chunks s_{k+1} = M s_k + e_k with M = A^L and e_k = W x_k; unrolled,
s_k = sum_{m<k} M^(k-1-m) e_m is one product with a block lower-triangular
matrix of the powers of M. In this form a chunk's zero-state response is
the filter's own truncated response, so no two large terms cancel (in the
direct form I state of past outputs, the 38 Hz highpass's zero-state chunk
response and its carried outputs cancel to within a part in 1e3 in f32).
Every operator is built in float64 numpy from the coefficients and applied
in the signal's dtype, but for the carries' product, which is taken in
float64 (N x 2K x 2K operations, a small share: in f32 its rounding put the
highpass 1.3e-5 off the exact filter, 8e-7 in f64). The filter is
differentiable with plain autograd. For the stable filters here the powers of M decay (the highpass's
poles sit at about 0.985, so M = A^64 has a spectral radius near 0.38).
"""
import math
import typing as tp
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filters import SplitBands

_EPS = float(np.finfo(np.float32).eps)
MAX_CHUNKS = 256   # the carries' matrix is (2 x chunks) squared


def _chunk_length(T: int) -> int:
    """64 samples, or more where T would need over MAX_CHUNKS chunks."""
    return max(64, math.ceil(T / MAX_CHUNKS))


@lru_cache(maxsize=32)
def _operators(b0: float, b1: float, b2: float, a1: float, a2: float,
               L: int, K: int) -> tp.Tuple[np.ndarray, ...]:
    """(impulse [L, L], basis [2, L], inject [2, L], carries [2K, 2K]) in
    float64 for the normalised biquad in transposed direct form II: a
    chunk's output is impulse @ x_k + basis^T @ s_k, its state update
    s_{k+1} = A^L s_k + inject @ x_k, and the flattened states of all
    chunks carries @ (inject @ x_m for every chunk m)."""
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    bx = np.array([b1 - a1 * b0, b2 - a2 * b0])
    powers = np.zeros((max(L, K) + 1, 2, 2))
    powers[0] = np.eye(2)
    for j in range(1, len(powers)):
        powers[j] = A @ powers[j - 1]
    h = np.concatenate([[b0], powers[:L - 1, 0] @ bx])         # C A^(n-1) Bx
    i = np.arange(L)
    impulse = np.where(i[:, None] >= i[None, :],
                       h[np.clip(i[:, None] - i[None, :], 0, L - 1)], 0.0)
    basis = powers[:L, 0].T                                      # C A^i
    inject = (powers[L - 1 - i] @ bx).T                          # A^(L-1-j) Bx
    m = powers[L]
    m_powers = np.zeros((K, 2, 2))
    m_powers[0] = np.eye(2)
    for j in range(1, K):
        m_powers[j] = m @ m_powers[j - 1]
    k = np.arange(K)
    lag = k[:, None] - 1 - k[None, :]                            # [K, K]
    carries = np.where((lag >= 0)[..., None, None],
                       m_powers[np.clip(lag, 0, K - 1)], 0.0)    # [K, K, 2, 2]
    carries = carries.transpose(0, 2, 1, 3).reshape(2 * K, 2 * K)
    return impulse, basis, inject, carries


def biquad(x: torch.Tensor, b0, b1, b2, a0, a1, a2) -> torch.Tensor:
    """Direct-form-I biquad over the last axis from zero state
    (torchaudio.functional.biquad without its clamp), computed as above."""
    shape = x.shape
    T = shape[-1]
    L = _chunk_length(T)
    K = math.ceil(T / L)
    impulse, basis, inject, carries = (
        torch.from_numpy(a).to(x.device, dtype) for a, dtype in zip(
            _operators(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0, L, K),
            (x.dtype, x.dtype, x.dtype, torch.float64)))
    chunks = F.pad(x.reshape(-1, T), (0, K * L - T)).reshape(-1, K, L)
    e = (chunks @ inject.T).double()                             # [N, K, 2]
    s = (e.reshape(-1, 2 * K) @ carries.T).reshape(-1, K, 2).to(x.dtype)
    y = chunks @ impulse.T + s @ basis
    return y.reshape(-1, K * L)[:, :T].reshape(shape)


def treble_biquad(x: torch.Tensor, sample_rate: int, gain: float,
                  central_freq: float = 3000.0, Q: float = 0.707
                  ) -> torch.Tensor:
    """torchaudio.functional.treble_biquad."""
    w0 = 2 * math.pi * central_freq / sample_rate
    alpha = math.sin(w0) / 2 / Q
    A = math.exp(gain / 40 * math.log(10))
    temp1 = 2 * math.sqrt(A) * alpha
    temp2 = (A - 1) * math.cos(w0)
    temp3 = (A + 1) * math.cos(w0)
    b0 = A * ((A + 1) + temp2 + temp1)
    b1 = -2 * A * ((A - 1) + temp3)
    b2 = A * ((A + 1) + temp2 - temp1)
    a0 = (A + 1) - temp2 + temp1
    a1 = 2 * ((A - 1) - temp3)
    a2 = (A + 1) - temp2 - temp1
    return biquad(x, b0, b1, b2, a0, a1, a2)


def highpass_biquad(x: torch.Tensor, sample_rate: int, cutoff_freq: float,
                    Q: float = 0.707) -> torch.Tensor:
    """torchaudio.functional.highpass_biquad."""
    w0 = 2 * math.pi * cutoff_freq / sample_rate
    alpha = math.sin(w0) / 2.0 / Q
    b0 = (1 + math.cos(w0)) / 2
    b1 = -1 - math.cos(w0)
    b2 = b0
    a0 = 1 + alpha
    a1 = -2 * math.cos(w0)
    a2 = 1 - alpha
    return biquad(x, b0, b1, b2, a0, a1, a2)


def basic_loudness(waveform: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Loudness per gated block of 0.4 s (overlap 0.75) of a waveform
    [..., C, T] -> [..., blocks]: K-weighting, mean square per block,
    channel weights (1, 1, 1, 1.41, 1.41), -0.691 + 10 log10."""
    if waveform.shape[-2] > 5:
        raise ValueError("Only up to 5 channels are supported.")
    gate_samples = int(round(0.4 * sample_rate))
    step = int(round(gate_samples * (1 - 0.75)))
    waveform = treble_biquad(waveform, sample_rate, 4.0, 1500.0,
                             1 / math.sqrt(2))
    waveform = highpass_biquad(waveform, sample_rate, 38.0, 0.5)
    T = waveform.shape[-1]
    blocks = waveform.unfold(-1, min(gate_samples, T), step)   # [..., C, F, G]
    energy = blocks.square().mean(dim=-1)                       # [..., C, F]
    g = torch.tensor([1.0, 1.0, 1.0, 1.41, 1.41], dtype=energy.dtype,
                     device=energy.device)[:waveform.shape[-2]]
    energy_weighted = (g[:, None] * energy).sum(dim=-2)        # [..., F]
    return -0.691 + 10 * torch.log10(energy_weighted + _EPS)


def _unfold(a: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """[*, T] -> [*, frames, kernel_size], zero-padded at the end to
    ceil(T / stride) frames."""
    length = a.shape[-1]
    n_frames = math.ceil(length / stride)
    tgt_length = (n_frames - 1) * stride + kernel_size
    return F.pad(a, (0, tgt_length - length)).unfold(-1, kernel_size, stride)


def _weighted_ratio(l_noise: torch.Tensor, l_ref: torch.Tensor, B: int,
                    temperature: float = 1.0) -> torch.Tensor:
    l_ratio = (l_noise - l_ref).reshape(-1, B)
    return torch.softmax(l_ratio / temperature, dim=0) * l_ratio


class FLoudnessRatio:
    """Loudness ratio of the noise per mel band, over whole signals."""

    def __init__(self, sample_rate: int = 16000,
                 segment: tp.Optional[float] = 20, overlap: float = 0.5,
                 epsilon: float = _EPS, n_bands: int = 0):
        self.sample_rate = sample_rate
        self.segment = segment
        self.overlap = overlap
        self.epsilon = epsilon
        self.filter = SplitBands(sample_rate, n_bands) if n_bands else None

    def __call__(self, out_sig: torch.Tensor,
                 ref_sig: torch.Tensor) -> torch.Tensor:
        B, C, T = ref_sig.shape
        assert ref_sig.shape == out_sig.shape
        assert self.filter is not None
        bands_ref = self.filter(ref_sig)
        bands_out = self.filter(out_sig)
        l_noise = basic_loudness(bands_ref - bands_out, self.sample_rate)
        l_ref = basic_loudness(bands_ref, self.sample_rate)
        return _weighted_ratio(l_noise, l_ref, B).sum()


class TLoudnessRatio:
    """Loudness ratio of the noise per time segment (mono)."""

    def __init__(self, sample_rate: int = 16000, segment: float = 0.5,
                 overlap: float = 0.5):
        self.sample_rate = sample_rate
        self.segment = segment
        self.overlap = overlap

    def __call__(self, out_sig: torch.Tensor,
                 ref_sig: torch.Tensor) -> torch.Tensor:
        B, C, T = ref_sig.shape
        assert ref_sig.shape == out_sig.shape
        assert C == 1
        frame = int(self.segment * self.sample_rate)
        stride = int(frame * (1 - self.overlap))
        gt = _unfold(ref_sig, frame, stride).reshape(-1, 1, frame)
        est = _unfold(out_sig, frame, stride).reshape(-1, 1, frame)
        l_noise = basic_loudness(gt - est, self.sample_rate)
        l_ref = basic_loudness(gt, self.sample_rate)
        return _weighted_ratio(l_noise, l_ref, B).sum()


class TFLoudnessRatio:
    """Loudness ratio of the noise per (mel band, time segment) (mono),
    the softmax at `temperature`, averaged."""

    def __init__(self, sample_rate: int = 16000, segment: float = 0.5,
                 overlap: float = 0.5, n_bands: int = 0,
                 clip_min: float = -100, temperature: float = 1.0):
        self.sample_rate = sample_rate
        self.segment = segment
        self.overlap = overlap
        self.clip_min = clip_min
        self.temperature = temperature
        self.n_bands = n_bands
        self.filter = SplitBands(sample_rate, n_bands) if n_bands else None

    def __call__(self, out_sig: torch.Tensor,
                 ref_sig: torch.Tensor) -> torch.Tensor:
        B, C, T = ref_sig.shape
        assert ref_sig.shape == out_sig.shape
        assert C == 1
        assert self.filter is not None
        bands_ref = self.filter(ref_sig).reshape(B * self.n_bands, 1, -1)
        bands_out = self.filter(out_sig).reshape(B * self.n_bands, 1, -1)
        frame = int(self.segment * self.sample_rate)
        stride = int(frame * (1 - self.overlap))
        gt = _unfold(bands_ref, frame, stride)[:, 0].reshape(-1, 1, frame)
        est = _unfold(bands_out, frame, stride)[:, 0].reshape(-1, 1, frame)
        l_noise = basic_loudness(est - gt, self.sample_rate)
        l_ref = basic_loudness(gt, self.sample_rate)
        return _weighted_ratio(l_noise, l_ref, B, self.temperature).mean()

"""Waveform utilities (counterpart of `audiocraft_tpu/data/audio_utils.py`):
channel and sample-rate conversion (torch), the BS.1770 loudness and the
normalisations that `audio_write` applies (numpy, on the host), PCM
conversions, and mp3 / aac round trips through the libav binding."""
import logging
import math
import re
import tempfile
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..ops.resample import resample_frac

logger = logging.getLogger(__name__)


def convert_audio_channels(wav: torch.Tensor, channels: int = 2) -> torch.Tensor:
    """wav [..., C, T] -> [..., channels, T]: average to mono, repeat mono,
    or keep the first `channels` channels."""
    *shape, src_channels, length = wav.shape
    if src_channels == channels:
        return wav
    if channels == 1:
        return wav.mean(dim=-2, keepdim=True)
    if src_channels == 1:
        return wav.expand(*shape, channels, length)
    if src_channels >= channels:
        return wav[..., :channels, :]
    raise ValueError("The audio file has less channels than requested but is "
                     "not mono.")


def convert_audio(wav, from_rate: float, to_rate: float,
                  to_channels: int) -> torch.Tensor:
    """Resample, then convert channels; wav [..., C, T] as f32."""
    wav = torch.as_tensor(wav, dtype=torch.float32)
    if int(from_rate) != int(to_rate):
        wav = resample_frac(wav, int(from_rate), int(to_rate))
    return convert_audio_channels(wav, to_channels)


# ------------------------------------------------------------- loudness

def _k_weighting_coeffs(sample_rate: int):
    """The two biquads of the ITU-R BS.1770-4 K-weighting, designed for
    `sample_rate` by the bilinear transform: the head's high shelf, then
    the RLB high-pass. Returns ((b, a) shelf, (b, a) high-pass)."""
    def biquad(f0: float, q: float):
        k = math.tan(math.pi * f0 / sample_rate)
        return k, 1.0 + k / q + k * k

    k, a0 = biquad(1681.974450955533, 0.7071752369554196)
    q = 0.7071752369554196
    vh = 10.0 ** (3.999843853973347 / 20.0)
    vb = vh ** 0.4996667741545416
    shelf = (np.array([vh + vb * k / q + k * k, 2.0 * (k * k - vh),
                       vh - vb * k / q + k * k]) / a0,
             np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                       (1.0 - k / q + k * k) / a0]))
    q = 0.5003270373238773
    k, a0 = biquad(38.13547087602444, q)
    highpass = (np.array([1.0, -2.0, 1.0]) / a0,
                np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                          (1.0 - k / q + k * k) / a0]))
    return shelf, highpass


def measure_loudness(wav: np.ndarray, sample_rate: int) -> float:
    """Integrated loudness in LKFS (BS.1770-4) of [C, T] or [T]: K-weighted
    power over 400 ms blocks at a 100 ms hop (a shorter signal is one
    zero-padded block), every channel of weight 1, gated at -70 LKFS and
    then 10 LU below the gated mean; -70 when no block passes."""
    from scipy.signal import lfilter
    y = np.asarray(wav, np.float64)
    if y.ndim == 1:
        y = y[None]
    for b, a in _k_weighting_coeffs(sample_rate):
        y = lfilter(b, a, y, axis=-1)
    block = int(0.4 * sample_rate)
    hop = max(block // 4, 1)
    if y.shape[-1] < block:
        y = np.pad(y, ((0, 0), (0, block - y.shape[-1])))
    windows = np.lib.stride_tricks.sliding_window_view(
        np.square(y), block, axis=-1)[:, ::hop]
    powers = windows.mean(axis=-1).sum(axis=0)  # [n_blocks]
    loudness = -0.691 + 10 * np.log10(np.maximum(powers, 1e-12))
    absolute = loudness > -70.0
    if not absolute.any():
        return -70.0
    threshold = -0.691 + 10 * np.log10(powers[absolute].mean()) - 10.0
    relative = absolute & (loudness > threshold)
    if not relative.any():
        return -70.0
    return float(-0.691 + 10 * np.log10(powers[relative].mean()))


def normalize_loudness(wav: np.ndarray, sample_rate: int,
                       loudness_headroom_db: float = 14.0,
                       loudness_compressor: bool = False,
                       energy_floor: float = 2e-3) -> np.ndarray:
    """Scale to -`loudness_headroom_db` LKFS (tanh-compressed with
    `loudness_compressor`); a signal of RMS below `energy_floor` is
    returned as it is."""
    if float(np.sqrt(np.mean(np.square(wav)))) < energy_floor:
        return wav
    input_loudness = measure_loudness(wav, sample_rate)
    gain = 10.0 ** ((-loudness_headroom_db - input_loudness) / 20.0)
    out = gain * wav
    if loudness_compressor:
        out = np.tanh(out)
    assert np.isfinite(out).all(), (input_loudness, float(np.abs(wav).max()))
    return out


def _clip_wav(wav: np.ndarray, log_clipping: bool = False,
              stem_name: tp.Optional[str] = None) -> np.ndarray:
    """Clip to [-1, 1], printing how much clips when `log_clipping`."""
    peak = float(np.abs(wav).max())
    if log_clipping and peak > 1:
        share = float((np.abs(wav) > 1).astype(np.float32).mean())
        print(f"CLIPPING {stem_name or ''} happening with proba (a bit of "
              f"clipping is okay):", share, "maximum scale: ", peak)
    return np.clip(wav, -1, 1)


def normalize_audio(wav: np.ndarray, normalize: bool = True,
                    strategy: str = "peak", peak_clip_headroom_db: float = 1.0,
                    rms_headroom_db: float = 18.0,
                    loudness_headroom_db: float = 14.0,
                    loudness_compressor: bool = False,
                    log_clipping: bool = False,
                    sample_rate: tp.Optional[int] = None,
                    stem_name: tp.Optional[str] = None) -> np.ndarray:
    """Normalise f32 audio by `strategy`: 'peak' (peak at
    -`peak_clip_headroom_db` dB), 'clip', 'rms' (mono RMS at
    -`rms_headroom_db` dB, then clip), 'loudness' (`normalize_loudness`,
    then clip), or none ('' / 'none', which asserts the audio is in range).
    Without `normalize`, 'peak' and 'rms' only scale down."""
    wav = np.asarray(wav, np.float32)
    if strategy == "peak":
        target = 10 ** (-peak_clip_headroom_db / 20)
        scale = target / max(float(np.abs(wav).max()), 1e-8)
        if normalize or scale < 1:
            wav = wav * scale
    elif strategy == "clip":
        wav = _clip_wav(wav, log_clipping=log_clipping, stem_name=stem_name)
    elif strategy == "rms":
        target = 10 ** (-rms_headroom_db / 20)
        mono = wav.mean(axis=0) if wav.ndim > 1 else wav
        scale = target / max(float(np.sqrt(np.mean(mono ** 2))), 1e-8)
        if normalize or scale < 1:
            wav = wav * scale
        wav = _clip_wav(wav, log_clipping=log_clipping, stem_name=stem_name)
    elif strategy == "loudness":
        assert sample_rate is not None, \
            "Loudness normalization requires sample rate."
        wav = normalize_loudness(wav, sample_rate, loudness_headroom_db,
                                 loudness_compressor)
        wav = _clip_wav(wav, log_clipping=log_clipping, stem_name=stem_name)
    else:
        assert float(np.abs(wav).max()) <= 1
        assert not normalize or strategy in ("", "none"), \
            f"Unexpected strategy: '{strategy}'"
    return wav


def f32_pcm(wav: np.ndarray) -> np.ndarray:
    """16 or 32-bit integer PCM (or floats) -> f32 in [-1, 1]."""
    if wav.dtype.kind == "f":
        return wav.astype(np.float32)
    if wav.dtype == np.int16:
        return wav.astype(np.float32) / 2 ** 15
    if wav.dtype == np.int32:
        return wav.astype(np.float32) / 2 ** 31
    raise ValueError(f"Unsupported wav dtype: {wav.dtype}")


def i16_pcm(wav: np.ndarray) -> np.ndarray:
    """Floats in [-1, 1] -> 16-bit PCM, rounded and saturated."""
    if wav.dtype.kind == "f":
        assert np.abs(wav).max() <= 1
        return np.clip((wav * 2 ** 15).round(), -2 ** 15,
                       2 ** 15 - 1).astype(np.int16)
    assert wav.dtype == np.int16
    return wav


# --------------------------------------------------- lossy codec round trips

def _kbps(bitrate: str) -> int:
    match = re.search(r"\d+(\.\d+)?", str(bitrate))
    return int(float(match.group())) if match else 128


def codec_round_trip(wav: np.ndarray, sample_rate: int, fmt: str,
                     bitrate_kbps: int) -> np.ndarray:
    """[B, C, T] f32 through an encode and a decode of `fmt` by libav: the
    batch, clipped to [-1, 1], goes as one mono stream, and comes back cut
    or zero-padded to its length."""
    from . import _native
    b, c, t = wav.shape
    flat = np.clip(np.asarray(wav, np.float32).reshape(1, -1), -1.0, 1.0)
    suffix = ".m4a" if fmt == "aac" else "." + fmt
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / f"round_trip{suffix}")
        _native.av_write(path, flat, sample_rate, fmt, bitrate_kbps)
        back, _ = _native.av_read(path)
    back = back.reshape(-1)[:b * c * t]
    back = np.pad(back, (0, b * c * t - back.shape[0]))
    return back.reshape(b, c, t).astype(np.float32)


def _straight_through(wav: torch.Tensor, sample_rate: int, fmt: str,
                      bitrate: str) -> torch.Tensor:
    """The codec's output forward, the identity's gradient backward."""
    host = wav.detach().float().cpu().numpy()
    out = torch.from_numpy(codec_round_trip(host, sample_rate, fmt,
                                            _kbps(bitrate)))
    out = out.to(device=wav.device, dtype=wav.dtype)
    return out + (wav - wav.detach())  # exactly `out`; the identity's grad


def get_mp3(wav: torch.Tensor, sr: int, bitrate: str = "128k") -> torch.Tensor:
    """An mp3 round trip of [B, C, T] audio (any device) at `bitrate`,
    with a straight-through gradient."""
    return _straight_through(wav, sr, "mp3", bitrate)


def get_aac(wav: torch.Tensor, sr: int, bitrate: str = "128k",
            lowpass_freq: tp.Optional[float] = None) -> torch.Tensor:
    """An aac round trip of [B, C, T] audio, as `get_mp3`. `lowpass_freq`
    is accepted and ignored (warned once): the libav wrapper takes no
    cutoff, as in the JAX package."""
    if lowpass_freq is not None:
        from ..utils.utils import warn_once
        warn_once(logger, "get_aac: lowpass_freq is not supported by the "
                  "native encoder and is ignored")
    return _straight_through(wav, sr, "aac", bitrate)

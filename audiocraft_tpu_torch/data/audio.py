"""Audio files: metadata, reads with seek, writes with normalisation
(counterpart of `audiocraft_tpu/data/audio.py`).

WAV (16, 24 and 32-bit integer PCM, 32-bit float) is read through the
native library (`data/_native.py`), which decodes only the frames asked
for; mp3, ogg, flac, aac (m4a) and opus go through the libav wrapper, with
sample-accurate seek. WAV is written as 16-bit PCM here; the compressed
formats through libav. Audio is numpy [C, T] f32 on the host: decoding
never touches the card.
"""
import struct
import typing as tp
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import _native
from .audio_utils import i16_pcm, normalize_audio

COMPRESSED_FORMATS = {"mp3": (".mp3", 320), "ogg": (".ogg", 128),
                      "flac": (".flac", 0), "aac": (".m4a", 128),
                      "opus": (".opus", 128)}


@dataclass(frozen=True)
class AudioFileInfo:
    sample_rate: int
    duration: float
    channels: int


def _is_wav(path: Path) -> bool:
    return path.suffix.lower() == ".wav"


def audio_info(filepath: tp.Union[str, Path]) -> AudioFileInfo:
    """Sample rate, duration in seconds and channels, without decoding."""
    filepath = Path(filepath)
    if _is_wav(filepath):
        sr, ch, frames = _native.wav_info(str(filepath))
        return AudioFileInfo(sr, frames / sr, ch)
    sr, ch, _, duration = _native.av_info(str(filepath))
    return AudioFileInfo(sr, duration, ch)


def audio_read(filepath: tp.Union[str, Path], seek_time: float = 0.0,
               duration: float = -1.0, pad: bool = False
               ) -> tp.Tuple[np.ndarray, int]:
    """([C, T] f32, sample rate): `duration` seconds from `seek_time` (all
    of the rest when not positive), zero-padded to `duration` when `pad`
    and the file ends first."""
    filepath = Path(filepath)
    read = _native.wav_read if _is_wav(filepath) else _native.av_read
    wav, sample_rate = read(str(filepath), seek_time, duration)
    if duration > 0 and pad:
        missing = int(duration * sample_rate) - wav.shape[-1]
        if missing > 0:
            wav = np.pad(wav, ((0, 0), (0, missing)))
    return wav, sample_rate


def _write_wav(path: Path, wav: np.ndarray, sample_rate: int) -> None:
    """16-bit PCM WAV of [C, T] f32 in [-1, 1]."""
    frames = i16_pcm(wav).T  # [T, C], interleaved once flattened
    data = frames.astype("<i2").tobytes()
    channels = frames.shape[1]
    header = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
              + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                            sample_rate * channels * 2, channels * 2, 16)
              + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)


def audio_write(stem_name: tp.Union[str, Path], wav, sample_rate: int,
                format: str = "wav", normalize: bool = True,
                strategy: str = "peak", peak_clip_headroom_db: float = 1.0,
                rms_headroom_db: float = 18.0,
                loudness_headroom_db: float = 14.0,
                loudness_compressor: bool = False, log_clipping: bool = True,
                make_parent_dir: bool = True,
                add_suffix: bool = True) -> Path:
    """Normalise `wav` ([C, T] or [T]; numpy or a tensor) with
    `normalize_audio`, then write it as `stem_name` + the format's suffix
    (`.m4a` for aac). Returns the path; a failed write leaves no file."""
    if hasattr(wav, "detach"):
        wav = wav.detach().cpu().numpy()
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    elif wav.ndim != 2:
        raise ValueError("Input wav should be at most 2 dimension.")
    assert np.isfinite(wav).all()
    wav = normalize_audio(wav, normalize, strategy, peak_clip_headroom_db,
                          rms_headroom_db, loudness_headroom_db,
                          loudness_compressor, log_clipping=log_clipping,
                          sample_rate=sample_rate, stem_name=str(stem_name))
    if format == "wav":
        suffix = ".wav"
    elif format in COMPRESSED_FORMATS:
        suffix = COMPRESSED_FORMATS[format][0]
    else:
        raise RuntimeError(f"Invalid format {format}. Only wav/mp3/ogg/flac/"
                           "aac/opus are supported.")
    path = Path(str(stem_name) + suffix) if add_suffix else Path(stem_name)
    if make_parent_dir:
        path.parent.mkdir(exist_ok=True, parents=True)
    try:
        if format == "wav":
            _write_wav(path, wav, sample_rate)
        else:
            _native.av_write(str(path), wav, sample_rate, format,
                             COMPRESSED_FORMATS[format][1])
    except Exception:
        if path.exists():
            path.unlink()
        raise
    return path


def get_spec(y, sr: int = 16000, n_fft: int = 4096, hop_length: int = 128,
             dur: float = 8) -> np.ndarray:
    """A 128-bin mel spectrogram in dB [128, frames] of the first `dur`
    seconds of `y` (any shape, flattened): the power floored at 1e-10,
    `10 log10`, then at most 80 dB below its peak (librosa's
    `power_to_db(ref=max)`). Computed on the host in f32."""
    import torch

    from ..ops.stft import mel_spectrogram
    y = np.asarray(y, np.float32).reshape(-1)[:int(dur * sr)]
    with torch.no_grad():
        mel = mel_spectrogram(torch.from_numpy(y)[None], sr, n_fft=n_fft,
                              hop_length=hop_length, n_mels=128)[0].numpy()
    db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    return np.maximum(db - db.max(), -80.0)


def save_spectrograms(ys: tp.List[np.ndarray], sr: int, path: str,
                      names: tp.List[str], n_fft: int = 4096,
                      hop_length: int = 128, dur: float = 8.0) -> None:
    """One spectrogram per waveform of `ys`, stacked in one figure titled
    by `names` (default: ground truth, watermarked audio, watermark) and
    saved to `path` with matplotlib's Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not names:
        names = ["Ground Truth", "Audio Watermarked", "Watermark"]
    assert len(names) == len(ys), \
        f"There are {len(ys)} wavs but {len(names)} names ({names})"
    fig, axes = plt.subplots(len(ys), 1, figsize=(8, 3 * len(ys)),
                             squeeze=False)
    for ax, y, name in zip(axes[:, 0], ys, names):
        spec = get_spec(np.asarray(y), sr=sr, n_fft=n_fft,
                        hop_length=hop_length, dur=dur)
        ax.imshow(spec, origin="lower", aspect="auto", cmap="magma",
                  vmin=-80.0, vmax=0.0)
        ax.set_title(name, fontsize=10)
        ax.set_ylabel("mel bin")
    axes[-1, 0].set_xlabel("frame")
    fig.tight_layout()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path)
    plt.close(fig)

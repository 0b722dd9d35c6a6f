"""The repository's data assets (counterpart of
`audiocraft_tpu/utils/assets.py`), under `<repo>/assets/` or
`$AUDIOCRAFT_ASSETS_DIR`:

- `melody_sample.mp3`, a deterministic synthesised melody clip for the
  melody-conditioning demos, made by `generate_melody_clip` on first use;
- `chord_to_index_mapping.pkl`, the chord-symbol to embedding-index map
  JASCO checkpoints were trained with (part of the weights' contract).
"""
import os
import pickle
import typing as tp
from pathlib import Path

import numpy as np


def assets_root() -> Path:
    override = os.environ.get("AUDIOCRAFT_ASSETS_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "assets"


def chord_mapping_path() -> str:
    return str(assets_root() / "chord_to_index_mapping.pkl")


def load_chord_mapping() -> tp.Dict[str, int]:
    with open(chord_mapping_path(), "rb") as f:
        return pickle.load(f)


def melody_clip_path() -> str:
    """The melody clip's path, made on first use."""
    path = assets_root() / "melody_sample.mp3"
    if not path.exists():
        generate_melody_clip(path)
    return str(path)


def generate_melody_clip(path: tp.Union[str, Path], duration: float = 12.0,
                         sample_rate: int = 32000) -> Path:
    """A deterministic clip: the progression Am, F, C, G twice (root, third
    and fifth, four harmonics each) under a pentatonic melody of two notes a
    chord drawn from `RandomState(7)`, with soft attacks and releases,
    peak 0.7, written in the format of `path`'s suffix."""
    path = Path(path)
    t = np.arange(int(duration * sample_rate)) / sample_rate

    def note_hz(semitones_from_a4: float) -> float:
        return 440.0 * 2.0 ** (semitones_from_a4 / 12.0)

    chords = [(-12, -9, -5), (-16, -12, -9), (-21, -17, -14),
              (-14, -10, -7)]
    beat = duration / 8.0
    wav = np.zeros_like(t)
    for i in range(8):
        lo, hi = i * beat, (i + 1) * beat
        seg = (t >= lo) & (t < hi)
        env = np.clip((t - lo) / 0.05, 0, 1) * np.clip((hi - t) / 0.15, 0, 1)
        for st in chords[i % 4]:
            f = note_hz(st)
            for harm, amp in ((1, 0.5), (2, 0.25), (3, 0.12), (4, 0.06)):
                wav += seg * env * amp * np.sin(2 * np.pi * f * harm * t) / 3
    penta = [0, 3, 5, 7, 10, 12]
    rng = np.random.RandomState(7)
    for i in range(16):
        lo, hi = i * beat / 2, (i + 1) * beat / 2
        seg = (t >= lo) & (t < hi)
        env = np.clip((t - lo) / 0.02, 0, 1) * np.clip((hi - t) / 0.1, 0, 1)
        f = note_hz(penta[rng.randint(len(penta))])
        wav += seg * env * 0.3 * np.sin(2 * np.pi * f * t)
    wav = (0.7 * wav / np.max(np.abs(wav))).astype(np.float32)

    from ..data.audio import audio_write
    fmt = path.suffix.lstrip(".") or "wav"
    return audio_write(str(path.with_suffix("")), wav[None], sample_rate,
                       format=fmt, normalize=False)

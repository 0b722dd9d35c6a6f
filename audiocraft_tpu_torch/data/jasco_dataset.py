"""JASCO segments: music with frame chords and melody salience
(counterpart of `audiocraft_tpu/data/jasco_dataset.py`).

Chords come from a pickle beside the manifest, `chords_per_track.pkl`
({track stem: [(chord, start time), ...]}, sorted by time), mapped to
indices through `chord_to_index_mapping.pkl`; a segment's chords are found
by binary search and laid out one per frame of the codec's frame rate. The
melody is a salience matrix per track (`<stem>_multif0_salience.npz`
under `chroma_root`, listed by the `*.txt` files there), cut to the
segment, linearly interpolated to the codec's frames and, with
`do_argmax`, made one-hot; without a `chroma_root` it is zeros.
"""
import bisect
import dataclasses
import math
import os
import pickle
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..modules.conditioners import ConditioningAttributes, SymbolicCondition
from ..utils.utils import construct_frame_chords
from .audio_dataset import _manifest_file, load_audio_meta
from .music_dataset import MusicDataset, MusicInfo


@dataclasses.dataclass
class JascoInfo(MusicInfo):
    """A music segment with its frame chords and melody salience, which
    become the symbolic conditions `chords` and `melody`."""
    chords: tp.Optional[SymbolicCondition] = None
    melody: tp.Optional[SymbolicCondition] = None

    def to_condition_attributes(self) -> ConditioningAttributes:
        out = ConditioningAttributes()
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if field.name == "self_wav":
                out.wav[field.name] = value
            elif field.name in ("chords", "melody"):
                if value is not None:
                    out.symbolic[field.name] = value
            elif field.name == "joint_embed":
                out.joint_embed.update(value)
            else:
                out.text[field.name] = (" ".join(value)
                                        if isinstance(value, list) else value)
        return out


def _stem(path: str) -> str:
    return path.split("/")[-1].split(".")[0]


class MelodyData:
    """The melody salience of a segment at the codec's frame rate
    (`latent_fr`): [melody_salience_dim, latent_fr * segment_duration]."""
    SALIENCE_MODEL_EXPECTED_SAMPLE_RATE = 22050
    SALIENCE_MODEL_EXPECTED_HOP_SIZE = 256

    def __init__(self, latent_fr: int, segment_duration: float,
                 melody_fr: int = 86, melody_salience_dim: int = 53,
                 chroma_root: tp.Optional[str] = None,
                 override_cache: bool = False, do_argmax: bool = True):
        self.segment_duration = segment_duration
        self.melody_fr = melody_fr
        self.latent_fr = latent_fr
        self.melody_salience_dim = melody_salience_dim
        self.do_argmax = do_argmax
        self.tgt_chunk_len = int(latent_fr * segment_duration)
        self.null_op = chroma_root is None
        self.model_frame_rate = int(self.SALIENCE_MODEL_EXPECTED_SAMPLE_RATE
                                    / self.SALIENCE_MODEL_EXPECTED_HOP_SIZE)
        if not self.null_op:
            self._index(Path(chroma_root), override_cache)

    def _index(self, root: Path, override_cache: bool) -> None:
        """Tracks and their salience files, cached in `root/cache.pkl`."""
        cache_file = root / "cache.pkl"
        if cache_file.exists() and not override_cache:
            with open(cache_file, "rb") as f:
                cached = pickle.load(f)
            self.tracks = cached["tracks"]
            self.saliency_files = cached["saliency_files"]
            self.trk2idx = cached["trk2idx"]
            return
        self.tracks = []
        for listing in sorted(root.rglob("*.txt")):
            self.tracks += [line.strip()
                            for line in listing.read_text().splitlines(True)]
        self.saliency_files = []
        for track in self.tracks:
            path = f"{root}/{_stem(track)}_multif0_salience.npz"
            assert os.path.exists(path), f"File {path} does not exist"
            self.saliency_files.append(path)
        self.trk2idx = {_stem(t): i for i, t in enumerate(self.tracks)}
        with open(cache_file, "wb") as f:
            pickle.dump({"tracks": self.tracks,
                         "saliency_files": self.saliency_files,
                         "trk2idx": self.trk2idx}, f)

    def get_null_salience(self) -> np.ndarray:
        return np.zeros((self.melody_salience_dim, self.tgt_chunk_len),
                        np.float32)

    def _interpolate(self, sal: np.ndarray) -> np.ndarray:
        """Each row linearly resampled, end to end, to the target length."""
        x_src = np.linspace(0, 1, sal.shape[-1])
        x_tgt = np.linspace(0, 1, self.tgt_chunk_len)
        return np.stack([np.interp(x_tgt, x_src, row)
                         for row in sal]).astype(np.float32)

    def __call__(self, info: MusicInfo) -> np.ndarray:
        if self.null_op:
            return self.get_null_salience()
        stem = _stem(info.meta.path)
        if stem not in self.trk2idx:
            return self.get_null_salience()
        salience = np.asarray(
            np.load(self.saliency_files[self.trk2idx[stem]])["salience"])
        start = int(info.seek_time * self.model_frame_rate)
        end = start + int(self.segment_duration * self.model_frame_rate)
        out = self._interpolate(salience[:self.melody_salience_dim, start:end])
        if self.do_argmax and out.size:
            one_hot = np.zeros_like(out)
            one_hot[out.argmax(axis=0), np.arange(out.shape[1])] = 1.0
            out = one_hot * (out.max(axis=0, keepdims=True) > 0)
        return out


class JascoDataset(MusicDataset):
    """`MusicDataset` whose items are (wav, JascoInfo) with their `chords`
    (frame chord indices; all `chords_card`, the null chord, without a
    chords pickle) and `melody` (`MelodyData` of `melody_kwargs`)."""

    @classmethod
    def from_meta(cls, root: tp.Union[str, Path], **kwargs):
        """The manifest (a file, or `data.jsonl[.gz]` in a folder) with the
        chords pickles beside it unless the caller names others."""
        manifest = _manifest_file(Path(root))
        folder = manifest.parent
        kwargs.setdefault("chords_path", str(folder / "chords_per_track.pkl"))
        kwargs.setdefault("chords_mapping_path",
                          str(folder / "chord_to_index_mapping.pkl"))
        return cls(load_audio_meta(manifest), **kwargs)

    def __init__(self, *args, compression_model_framerate: int = 50,
                 chords_card: int = 194,
                 chords_path: tp.Optional[str] = None,
                 chords_mapping_path: tp.Optional[str] = None,
                 melody_kwargs: tp.Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)

        def load(path):
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    return pickle.load(f)
            return None

        self.chords_per_track = load(chords_path)
        self.mapping_dict = load(chords_mapping_path)
        self.compression_model_framerate = compression_model_framerate
        self.null_chord_idx = chords_card
        self.melody_module = MelodyData(**(melody_kwargs or dict(
            latent_fr=compression_model_framerate,
            segment_duration=self.segment_duration or 10.0)))

    def _get_relevant_sublist(self, chords, timestamp: float):
        """The (time, chord) changes inside [timestamp, timestamp +
        segment), and the change in force at `timestamp` ((0, 'N') when
        none)."""
        end_time = timestamp + (self.segment_duration or 0.0)
        first = bisect.bisect_left(chords, (timestamp,))
        previous = chords[first - 1] if first else (0.0, "N")
        inside = []
        for change in chords[first:]:
            if change[0] >= end_time:
                break
            inside.append(change)
        return inside, previous

    def _get_chords(self, info: MusicInfo,
                    effective_segment_dur: float) -> np.ndarray:
        if self.chords_per_track is None:
            length = math.ceil(self.compression_model_framerate
                               * effective_segment_dur)
            return np.full((length,), self.null_chord_idx, np.int64)
        fr = self.compression_model_framerate
        changes = [(item[1], item[0])
                   for item in self.chords_per_track[_stem(info.meta.path)]]
        inside, previous = self._get_relevant_sublist(changes, info.seek_time)
        return np.asarray(construct_frame_chords(
            int(info.seek_time * fr) + 1, inside, self.mapping_dict,
            previous[1], fr, self.segment_duration), np.int64)

    def __getitem__(self, index: int):
        wav, music_info = super().__getitem__(index)
        assert torch.isfinite(wav).all(), f"inf in wav file: {music_info}"
        info = JascoInfo(**{f.name: getattr(music_info, f.name)
                            for f in dataclasses.fields(music_info)})
        duration = (wav.shape[-1] / self.sample_rate
                    if self.segment_duration is None
                    else self.segment_duration)
        info.chords = SymbolicCondition(
            frame_chords=self._get_chords(music_info, duration))
        info.melody = SymbolicCondition(melody=self.melody_module(music_info))
        return wav, info

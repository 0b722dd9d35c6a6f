"""Manifests of audio files and the dataset of random segments drawn from
them (counterpart of `audiocraft_tpu/data/audio_dataset.py`).

A manifest is a JSON-lines file (gzipped when its name ends in `.gz`), one
`AudioMeta` per line. `AudioDataset` draws, for item `index`, a file (by
duration, weight, both, uniformly, or through a per-epoch permutation of
the files) and a start inside it from a numpy `RandomState` seeded with
`index + num_samples * (epoch + shuffle_seed)`, so an item is a pure
function of (index, epoch, shuffle_seed) and any number of loader workers
yields the same batches. Before `start_epoch` is called a shuffled dataset
seeds from Python's unseeded `random`, as the JAX package does. The
segment is decoded on the host, resampled to the dataset's rate
(`ops/resample.resample_frac`, on the CPU), converted to its channels and
zero-padded to the segment's length; items are f32 torch tensors [C, T].

Run as a module to write a manifest:
`python -m audiocraft_tpu_torch.data.audio_dataset <root> <out.jsonl[.gz]>`.
"""
import argparse
import copy
import dataclasses
import functools
import gzip
import json
import logging
import random
import sys
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .audio import audio_info, audio_read
from .audio_utils import convert_audio
from .zip import PathInZip

logger = logging.getLogger(__name__)

DEFAULT_EXTS = [".wav", ".mp3", ".flac", ".ogg", ".m4a"]


class BaseInfo:
    """Conversions between a dataclass and a dict of its fields."""

    @classmethod
    def _dict2fields(cls, dictionary: dict) -> dict:
        return {f.name: dictionary[f.name] for f in dataclasses.fields(cls)
                if f.name in dictionary}

    @classmethod
    def from_dict(cls, dictionary: dict):
        return cls(**cls._dict2fields(dictionary))

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(order=True)
class AudioMeta(BaseInfo):
    """One audio file of a manifest: path, duration in seconds, sample rate,
    optional peak amplitude, sampling weight and side-info file (a member
    of a zip archive)."""
    path: str
    duration: float
    sample_rate: int
    amplitude: tp.Optional[float] = None
    weight: tp.Optional[float] = None
    info_path: tp.Optional[PathInZip] = None

    @classmethod
    def from_dict(cls, dictionary: dict) -> "AudioMeta":
        base = cls._dict2fields(dictionary)
        if base.get("info_path") is not None:
            base["info_path"] = PathInZip(base["info_path"])
        return cls(**base)

    def to_dict(self) -> dict:
        out = super().to_dict()
        if out["info_path"] is not None:
            out["info_path"] = str(out["info_path"])
        return out


@dataclasses.dataclass(order=True)
class SegmentInfo(BaseInfo):
    """One segment cut from a file: where it starts, how many frames are
    audio (`n_frames`) and how many the padded segment holds."""
    meta: AudioMeta
    seek_time: float
    n_frames: int
    total_frames: int
    sample_rate: int
    channels: int


# ------------------------------------------------------------------ manifests

def _get_audio_meta(file_path: str, minimal: bool = True) -> AudioMeta:
    """The file's meta; with `minimal` False also its peak amplitude (which
    decodes the whole file)."""
    info = audio_info(file_path)
    amplitude = None
    if not minimal:
        wav, _ = audio_read(file_path)
        amplitude = float(np.abs(wav).max())
    return AudioMeta(file_path, info.duration, info.sample_rate, amplitude)


def _resolve_audio_meta(meta: AudioMeta, fast: bool = True) -> AudioMeta:
    """Relative paths are made absolute through dora's git-save helper in
    the JAX package when dora is installed; neither package ships dora, so
    paths are kept as they are."""
    return meta


def find_audio_files(path: tp.Union[Path, str],
                     exts: tp.List[str] = DEFAULT_EXTS,
                     resolve: bool = True, minimal: bool = True,
                     progress: bool = False,
                     workers: int = 0) -> tp.List[AudioMeta]:
    """The sorted metas of every file under `path` (links followed) whose
    suffix is in `exts`, read by `workers` threads (0: in this thread). A
    file that cannot be read is reported on stderr and left out."""
    files = sorted((p for p in Path(path).rglob("*")
                    if p.suffix.lower() in exts and p.is_file()), key=str)
    if progress:
        print(format(len(files), " 8d"), file=sys.stderr)

    def meta_or_error(file_path: Path):
        try:
            return _get_audio_meta(str(file_path), minimal)
        except Exception as err:  # reported and skipped, as a manifest tool
            return err

    if workers > 0:
        with ThreadPoolExecutor(workers) as pool:
            results = list(pool.map(meta_or_error, files))
    else:
        results = [meta_or_error(f) for f in files]
    metas = []
    for file_path, result in zip(files, results):
        if isinstance(result, Exception):
            print("Error with", str(file_path), result, file=sys.stderr)
            continue
        metas.append(_resolve_audio_meta(result) if resolve else result)
    metas.sort()
    return metas


def _open(path: tp.Union[str, Path], mode: str):
    return (gzip.open if str(path).lower().endswith(".gz") else open)(
        path, mode)


def load_audio_meta(path: tp.Union[str, Path], resolve: bool = True,
                    fast: bool = True) -> tp.List[AudioMeta]:
    """The metas of a `.jsonl` or `.jsonl.gz` manifest."""
    with _open(path, "rb") as f:
        metas = [AudioMeta.from_dict(json.loads(line)) for line in f
                 if line.strip()]
    return [_resolve_audio_meta(m, fast) for m in metas] if resolve else metas


def save_audio_meta(path: tp.Union[str, Path],
                    meta: tp.List[AudioMeta]) -> None:
    """Write a `.jsonl` or `.jsonl.gz` manifest, one meta per line."""
    Path(path).parent.mkdir(exist_ok=True, parents=True)
    with _open(path, "wb") as f:
        for m in meta:
            f.write((json.dumps(m.to_dict()) + "\n").encode("utf-8"))


def _manifest_file(root: Path) -> Path:
    """`root` itself, or the `data.jsonl` (or `.gz`) in the folder."""
    if not root.is_dir():
        return root
    for name in ("data.jsonl", "data.jsonl.gz"):
        if (root / name).exists():
            return root / name
    raise ValueError("Don't know where to read metadata from in the dir. "
                     "Expecting either a data.jsonl or data.jsonl.gz file "
                     "but none found.")


# -------------------------------------------------------------------- dataset

class AudioDataset:
    """Segments of `segment_duration` seconds drawn at random from the files
    of `meta` (`num_samples` of them per epoch), or, without a segment
    duration, each file whole (one item per file, padded to the longest of
    a batch by `collater`).

    Files are drawn with probabilities proportional to duration
    (`sample_on_duration`) times weight (`sample_on_weight`), uniformly
    when neither, or in order through a seeded permutation per pass over
    the files (`permutation_on_files`). A segment starts uniformly in
    [0, duration - segment_duration * min_segment_ratio]. A failed read is
    retried on another draw up to `max_read_retry` times. With
    `return_info`, an item is (wav, SegmentInfo). Files shorter than
    `min_audio_duration` or longer than `max_audio_duration` are dropped.
    With `load_wav` False the audio is zeros (the metadata alone)."""

    def __init__(self, meta: tp.List[AudioMeta],
                 segment_duration: tp.Optional[float] = None,
                 shuffle: bool = True, num_samples: int = 10_000,
                 sample_rate: int = 48_000, channels: int = 2,
                 pad: bool = True, sample_on_duration: bool = True,
                 sample_on_weight: bool = True, min_segment_ratio: float = 0.5,
                 max_read_retry: int = 10, return_info: bool = False,
                 min_audio_duration: tp.Optional[float] = None,
                 max_audio_duration: tp.Optional[float] = None,
                 shuffle_seed: int = 0, load_wav: bool = True,
                 permutation_on_files: bool = False):
        assert len(meta) > 0, ("No audio meta provided to AudioDataset. "
                               "Please check loading of audio meta.")
        assert segment_duration is None or segment_duration > 0
        assert segment_duration is None or min_segment_ratio >= 0
        if min_audio_duration is not None and max_audio_duration is not None:
            assert min_audio_duration <= max_audio_duration
        self.segment_duration = segment_duration
        self.min_segment_ratio = min_segment_ratio
        self.min_audio_duration = min_audio_duration
        self.max_audio_duration = max_audio_duration
        self.meta = self._filter_duration(meta)
        assert len(self.meta)
        self.total_duration = sum(m.duration for m in self.meta)
        self.num_samples = (len(self.meta) if segment_duration is None
                            else num_samples)
        self.shuffle = shuffle
        self.sample_rate = sample_rate
        self.channels = channels
        self.pad = pad
        self.sample_on_weight = sample_on_weight
        self.sample_on_duration = sample_on_duration
        self.sampling_probabilities = self._get_sampling_probabilities()
        self.max_read_retry = max_read_retry
        self.return_info = return_info
        self.shuffle_seed = shuffle_seed
        self.current_epoch: tp.Optional[int] = None
        self.load_wav = load_wav
        if not load_wav:
            assert segment_duration is not None
        self.permutation_on_files = permutation_on_files
        if permutation_on_files:
            assert shuffle and not sample_on_duration and not sample_on_weight

    def start_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def _filter_duration(self, meta: tp.List[AudioMeta]) -> tp.List[AudioMeta]:
        kept = [m for m in meta
                if (self.min_audio_duration is None
                    or m.duration >= self.min_audio_duration)
                and (self.max_audio_duration is None
                     or m.duration <= self.max_audio_duration)]
        removed = 100 * (1 - len(kept) / len(meta))
        (logger.debug if removed < 10 else logger.warning)(
            "Removed %.2f percent of the data because it was too short or too "
            "long.", removed)
        return kept

    def _get_sampling_probabilities(self, normalized: bool = True
                                    ) -> np.ndarray:
        scores = np.ones(len(self.meta), np.float64)
        for i, m in enumerate(self.meta):
            if self.sample_on_weight and m.weight is not None:
                scores[i] *= m.weight
            if self.sample_on_duration:
                scores[i] *= m.duration
        return scores / scores.sum() if normalized else scores

    @staticmethod
    @functools.lru_cache(16)
    def _get_file_permutation(num_files: int, permutation_index: int,
                              base_seed: int) -> np.ndarray:
        return np.random.RandomState(
            base_seed + permutation_index).permutation(num_files)

    def sample_file(self, index: int, rng: np.random.RandomState) -> AudioMeta:
        """The file of item `index` (one draw from `rng`, none for a
        permutation)."""
        if self.permutation_on_files:
            assert self.current_epoch is not None
            position = self.current_epoch * len(self) + index
            permutation = AudioDataset._get_file_permutation(
                len(self.meta), position // len(self.meta), self.shuffle_seed)
            return self.meta[int(permutation[position % len(self.meta)])]
        n = len(self.sampling_probabilities)
        if self.sample_on_weight or self.sample_on_duration:
            return self.meta[int(rng.choice(n, p=self.sampling_probabilities))]
        return self.meta[int(rng.randint(n))]

    def _item_seed(self, index: int) -> int:
        if not self.shuffle:
            return index
        if self.current_epoch is None:  # unseeded, as in the JAX package
            return index + self.num_samples * random.randint(0, 2 ** 24)
        return index + self.num_samples * (self.current_epoch
                                           + self.shuffle_seed)

    def _read(self, path: str, seek_time: float, duration: float
              ) -> torch.Tensor:
        """The segment, resampled to the dataset's rate and converted to
        its channels, as a contiguous f32 tensor [C, T]."""
        if self.load_wav:
            wav, sr = audio_read(path, seek_time, duration, pad=False)
        else:
            wav = np.zeros((self.channels,
                            int(self.sample_rate * self.segment_duration)),
                           np.float32)
            sr = self.sample_rate
        return convert_audio(torch.from_numpy(wav), sr, self.sample_rate,
                             self.channels).contiguous()

    def _whole_file(self, index: int):
        meta = self.meta[index]
        out = self._read(meta.path, 0.0, -1.0)
        n = out.shape[-1]
        return out, SegmentInfo(meta, seek_time=0.0, n_frames=n,
                                total_frames=n, sample_rate=self.sample_rate,
                                channels=out.shape[0])

    def _segment(self, index: int):
        rng = np.random.RandomState(self._item_seed(index) & 0x7FFFFFFF)
        for retry in range(self.max_read_retry):
            meta = self.sample_file(index, rng)
            max_seek = max(0, meta.duration
                           - self.segment_duration * self.min_segment_ratio)
            seek_time = rng.rand() * max_seek
            try:
                out = self._read(meta.path, seek_time, self.segment_duration)
            except Exception as exc:
                logger.warning("Error opening file %s: %r", meta.path, exc)
                if retry == self.max_read_retry - 1:
                    raise
                continue
            n = out.shape[-1]
            target = int(self.segment_duration * self.sample_rate)
            if self.pad:
                out = torch.nn.functional.pad(out, (0, target - n))
            return out, SegmentInfo(meta, seek_time, n_frames=n,
                                    total_frames=target,
                                    sample_rate=self.sample_rate,
                                    channels=out.shape[0])
        raise RuntimeError("max_read_retry must be at least 1")

    def __getitem__(self, index: int):
        if self.segment_duration is None:
            out, info = self._whole_file(index)
        else:
            out, info = self._segment(index)
        return (out, info) if self.return_info else out

    def _copy_info(self, info):
        return copy.deepcopy(info)

    def collater(self, samples):
        """Stack items into [B, C, T] (and their infos into a list, copied).
        Without a segment duration the items are zero-padded to the longest
        and each info's `total_frames` set to it."""
        if self.segment_duration is None and len(samples) > 1:
            assert self.pad, ("Must allow padding when batching examples of "
                              "different durations.")
        wavs = [s[0] for s in samples] if self.return_info else list(samples)
        if self.segment_duration is None and self.pad:
            longest = max(w.shape[-1] for w in wavs)
            wavs = [torch.nn.functional.pad(w, (0, longest - w.shape[-1]))
                    for w in wavs]
        batch = torch.stack(wavs)
        if not self.return_info:
            return batch
        infos = [self._copy_info(s[1]) for s in samples]
        assert all(isinstance(i, SegmentInfo) for i in infos)
        if self.segment_duration is None and self.pad:
            for info in infos:
                info.total_frames = batch.shape[-1]
        return batch, infos

    @classmethod
    def from_meta(cls, root: tp.Union[str, Path], **kwargs):
        """The dataset of a manifest file, or of the `data.jsonl[.gz]` in a
        folder."""
        return cls(load_audio_meta(_manifest_file(Path(root))), **kwargs)

    @classmethod
    def from_path(cls, root: tp.Union[str, Path], minimal_meta: bool = True,
                  exts: tp.List[str] = DEFAULT_EXTS, **kwargs):
        """The dataset of a manifest file, or of every audio file under a
        folder."""
        root = Path(root)
        if root.is_file():
            meta = load_audio_meta(root, resolve=True)
        else:
            meta = find_audio_files(root, exts, minimal=minimal_meta,
                                    resolve=True)
        return cls(meta, **kwargs)


def main(argv: tp.Optional[tp.List[str]] = None) -> None:
    """Write the manifest of every audio file under a folder."""
    logging.basicConfig(stream=sys.stderr, level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="audio_dataset",
        description="Generate .jsonl files by scanning a folder.")
    parser.add_argument("root", help="Root folder with all the audio files")
    parser.add_argument("output_meta_file",
                        help="Output file to store the metadata")
    parser.add_argument("--complete", action="store_false", dest="minimal",
                        default=True,
                        help="Retrieve all metadata, even the expensive ones.")
    parser.add_argument("--resolve", action="store_true", default=False,
                        help="Resolve the paths to be absolute.")
    parser.add_argument("--workers", default=10, type=int)
    args = parser.parse_args(argv)
    meta = find_audio_files(args.root, DEFAULT_EXTS, progress=True,
                            resolve=args.resolve, minimal=args.minimal,
                            workers=args.workers)
    save_audio_meta(args.output_meta_file, meta)


if __name__ == "__main__":
    main()

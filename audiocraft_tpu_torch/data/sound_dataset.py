"""Sound-effect segments with their descriptions, and the mixing
augmentation (counterpart of `audiocraft_tpu/data/sound_dataset.py`).

`SoundDataset` reads the JSON beside each file (or of the same name under
`external_metadata_source`) into a `SoundInfo`; a list of descriptions
gives one drawn at random. With `aug_p` > 0 (mono only) the collater mixes
pairs of the batch at a random SNR with probability `aug_p` (their texts
joined), and otherwise keeps a random `mix_p` share of it. The JAX package
draws these from Python's and numpy's global generators; here an item's
draws come from a `random.Random` of the item's seed, and a batch's from a
`random.Random` and a numpy `RandomState` seeded from its segments.
"""
import copy
import dataclasses
import json
import logging
import random
import typing as tp
import zlib
from pathlib import Path

import numpy as np
import torch

from ..modules.conditioners import ConditioningAttributes, WavCondition
from .audio_dataset import SegmentInfo
from .info_audio_dataset import InfoAudioDataset, get_keyword_or_keyword_list

logger = logging.getLogger(__name__)

EPS = 1e-8
TARGET_LEVEL_LOWER = -35
TARGET_LEVEL_UPPER = -15


@dataclasses.dataclass
class SoundInfo(SegmentInfo):
    """A sound segment: its description (a text attribute) and its own
    waveform (`self_wav`)."""
    description: tp.Optional[str] = None
    self_wav: tp.Optional[WavCondition] = None

    @property
    def has_sound_meta(self) -> bool:
        return self.description is not None

    def to_condition_attributes(self) -> ConditioningAttributes:
        out = ConditioningAttributes()
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if field.name == "self_wav":
                out.wav[field.name] = value
            else:
                out.text[field.name] = value
        return out

    @staticmethod
    def attribute_getter(attribute: str) -> tp.Optional[tp.Callable]:
        return get_keyword_or_keyword_list if attribute == "description" \
            else None

    @classmethod
    def from_dict(cls, dictionary: dict, fields_required: bool = False):
        values = {}
        for field in dataclasses.fields(cls):
            if field.name == "self_wav":
                continue
            if field.name not in dictionary:
                if fields_required:
                    raise KeyError(f"Unexpected missing key: {field.name}")
                continue
            getter = cls.attribute_getter(field.name)
            value = dictionary[field.name]
            values[field.name] = getter(value) if getter else value
        return cls(**values)


class SoundDataset(InfoAudioDataset):
    """`InfoAudioDataset` whose items are (wav, SoundInfo); see the module's
    docstring."""

    def __init__(self, *args, info_fields_required: bool = True,
                 external_metadata_source: tp.Optional[str] = None,
                 aug_p: float = 0., mix_p: float = 0., mix_snr_low: int = -5,
                 mix_snr_high: int = 5, mix_min_overlap: float = 0.5,
                 **kwargs):
        kwargs["return_info"] = True
        super().__init__(*args, **kwargs)
        self.info_fields_required = info_fields_required
        self.external_metadata_source = external_metadata_source
        self.aug_p = aug_p
        self.mix_p = mix_p
        if aug_p > 0:
            assert mix_p > 0, \
                "Expecting some mixing proportion mix_p if aug_p > 0"
            assert self.channels == 1, \
                "SoundDataset with audio mixing considers only monophonic audio"
        self.mix_snr_low = mix_snr_low
        self.mix_snr_high = mix_snr_high
        self.mix_min_overlap = mix_min_overlap

    def _get_info_path(self, path: tp.Union[str, Path]) -> Path:
        info_path = Path(path).with_suffix(".json")
        if info_path.exists():
            return info_path
        if self.external_metadata_source:
            external = Path(self.external_metadata_source) / info_path.name
            if external.exists():
                return external
        raise Exception(f"Unable to find a metadata JSON for path: {path}")

    def __getitem__(self, index: int):
        wav, info = super().__getitem__(index)
        data = json.loads(self._get_info_path(info.meta.path).read_text())
        data.update(info.to_dict())
        sound_info = SoundInfo.from_dict(
            data, fields_required=self.info_fields_required)
        if isinstance(sound_info.description, list):
            rng = random.Random(self._item_seed(index))
            sound_info.description = rng.choice(sound_info.description)
        sound_info.self_wav = WavCondition(
            wav=wav[None], length=torch.tensor([info.n_frames]),
            sample_rate=[sound_info.sample_rate], path=[info.meta.path],
            seek_time=[info.seek_time])
        return wav, sound_info

    def _copy_info(self, info):
        if info.self_wav is None:
            return super()._copy_info(info)
        return copy.deepcopy(info, {id(info.self_wav.wav): info.self_wav.wav})

    def collater(self, samples):
        wav, infos = super().collater(samples)
        if self.segment_duration is not None:
            for i, info in enumerate(infos):
                info.self_wav = info.self_wav._replace(wav=wav[i:i + 1])
        if self.aug_p > 0:
            key = repr([(i.meta.path, i.seek_time) for i in infos]).encode()
            seed = zlib.crc32(key)
            wav, infos = mix_samples(
                wav, infos, self.aug_p, self.mix_p, snr_low=self.mix_snr_low,
                snr_high=self.mix_snr_high, min_overlap=self.mix_min_overlap,
                rng=random.Random(seed), np_rng=np.random.RandomState(seed))
        return wav, infos


def rms_f(x: np.ndarray) -> np.ndarray:
    """RMS of each row of [B, T]."""
    return np.sqrt((x ** 2).mean(axis=1))


def normalize(audio: np.ndarray, target_level: int = -25) -> np.ndarray:
    """Rows of [B, T] scaled to an RMS of `target_level` dB."""
    scale = 10 ** (target_level / 20) / (rms_f(audio) + EPS)
    return audio * scale[:, None]


def is_clipped(audio: np.ndarray,
               clipping_threshold: float = 0.99) -> np.ndarray:
    return (np.abs(audio) > clipping_threshold).any(axis=1)


def mix_pair(src: np.ndarray, dst: np.ndarray, min_overlap: float,
             rng: random.Random) -> np.ndarray:
    """`dst` added into `src` from a random start that keeps at least
    `min_overlap` of `src` covered (cut at `src`'s end)."""
    start = rng.randint(0, int(src.shape[1] * (1 - min_overlap)))
    n = min(src.shape[1] - start, dst.shape[1])
    out = src.copy()
    out[:, start:start + n] += dst[:, :n]
    return out


def snr_mixer(clean: np.ndarray, noise: np.ndarray, snr: int,
              min_overlap: float, target_level: int = -25,
              clipping_threshold: float = 0.99,
              rng: tp.Optional[random.Random] = None,
              np_rng: tp.Optional[np.random.RandomState] = None
              ) -> np.ndarray:
    """Rows of `noise` mixed into `clean` ([B, T]) at `snr` dB: both peak-
    then RMS-normalised to `target_level`, the mix scaled to a random level
    in [-35, -15) dB and rescaled where it clips."""
    rng = rng or random.Random()
    np_rng = np_rng or np.random.RandomState()
    if clean.shape[1] > noise.shape[1]:
        noise = np.pad(noise, ((0, 0), (0, clean.shape[1] - noise.shape[1])))
    else:
        noise = noise[:, :clean.shape[1]]
    clean = normalize(clean / (np.abs(clean).max(axis=1, keepdims=True) + EPS),
                      target_level)
    noise = normalize(noise / (np.abs(noise).max(axis=1, keepdims=True) + EPS),
                      target_level)
    noise_scale = rms_f(clean) / (10 ** (snr / 20)) / (rms_f(noise) + EPS)
    noisy = mix_pair(clean, noise * noise_scale[:, None], min_overlap, rng)
    level = np_rng.randint(TARGET_LEVEL_LOWER, TARGET_LEVEL_UPPER)
    noisy = noisy * (10 ** (level / 20) / (rms_f(noisy) + EPS))[:, None]
    clipped = is_clipped(noisy)
    if clipped.any():
        peak = (np.abs(noisy[clipped]).max(axis=1, keepdims=True)
                / (clipping_threshold - EPS))
        noisy[clipped] = noisy[clipped] / peak
    return noisy


def snr_mix(src: np.ndarray, dst: np.ndarray, snr_low: int, snr_high: int,
            min_overlap: float, rng: tp.Optional[random.Random] = None,
            np_rng: tp.Optional[np.random.RandomState] = None) -> np.ndarray:
    """`snr_mixer` at an SNR drawn in [snr_low, snr_high)."""
    np_rng = np_rng or np.random.RandomState()
    snr = snr_low if snr_low == snr_high else np_rng.randint(snr_low, snr_high)
    return snr_mixer(src, dst, snr, min_overlap, rng=rng, np_rng=np_rng)


def mix_text(src_text: str, dst_text: str) -> str:
    return src_text if src_text == dst_text else src_text + " " + dst_text


def mix_samples(wavs, infos: tp.List[SoundInfo], aug_p: float, mix_p: float,
                snr_low: int, snr_high: int, min_overlap: float,
                rng: tp.Optional[random.Random] = None,
                np_rng: tp.Optional[np.random.RandomState] = None):
    """With probability `aug_p`, `int(mix_p * B)` mixes of random pairs of
    the mono batch [B, 1, T] (texts joined); otherwise a random
    `int(mix_p * B)` of its rows. `mix_p` 0 returns the batch as it is.
    Draws: the branch from `rng`, then the pairs (two permutations), the
    SNR and the level from `np_rng`, each mix's start from `rng`."""
    if mix_p == 0:
        return wavs, infos
    rng = rng or random.Random()
    np_rng = np_rng or np.random.RandomState()
    wavs = torch.as_tensor(wavs)
    if rng.uniform(0, 1) < aug_p:
        assert wavs.shape[1] == 1, \
            f"Mix samples requires monophonic audio but C={wavs.shape[1]}"
        mono = wavs.mean(dim=1).numpy()
        B = mono.shape[0]
        k = int(mix_p * B)
        sources = np_rng.permutation(B)[:k]
        targets = np_rng.permutation(B)[:k]
        mixed = snr_mix(mono[sources], mono[targets], snr_low, snr_high,
                        min_overlap, rng=rng, np_rng=np_rng)
        out_infos = []
        for i, j in zip(sources, targets):
            info = dataclasses.replace(infos[i])
            info.description = mix_text(infos[i].description,
                                        infos[j].description)
            out_infos.append(info)
        assert len(out_infos) > 0, "Samples mixing returned empty batch."
        return torch.from_numpy(np.ascontiguousarray(mixed[:, None])), \
            out_infos
    keep = np_rng.permutation(wavs.shape[0])[:int(mix_p * wavs.shape[0])]
    return wavs[torch.from_numpy(keep)], [infos[i] for i in keep]

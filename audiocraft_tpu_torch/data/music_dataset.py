"""Music segments with their tags (counterpart of
`audiocraft_tpu/data/music_dataset.py`).

`MusicDataset` reads a JSON sidecar beside each audio file (same stem,
`.json`) into a `MusicInfo`: title, artist, key, bpm, genre, moods,
keywords, description, name, instrument, each cleaned by its getter. An
item also carries its own waveform as the `self_wav` condition (a view of
the item's tensor, not a copy) and, for each of `joint_embed_attributes`,
a joint text-audio condition. The description may be paraphrased from a
JSON source and merged with the other tags; those draws come from a
`random.Random` seeded with the item's seed (its index and epoch), where
the JAX package draws from Python's global `random`.
"""
import copy
import dataclasses
import gzip
import json
import logging
import random
import typing as tp
from pathlib import Path

import torch

from ..modules.conditioners import (ConditioningAttributes,
                                    JointEmbedCondition, WavCondition)
from ..utils.utils import warn_once
from .info_audio_dataset import (AudioInfo, InfoAudioDataset, get_keyword,
                                 get_keyword_list, get_string)

logger = logging.getLogger(__name__)


def get_musical_key(value: tp.Optional[str]) -> tp.Optional[str]:
    """A key, lower-cased; None for no string, '' , 'None' or several keys
    (a comma)."""
    if not isinstance(value, str) or not value or value == "None" \
            or "," in value:
        return None
    return value.strip().lower()


def get_bpm(value) -> tp.Optional[float]:
    """The tempo as a float, None when it does not parse."""
    if value is None:
        return None
    try:
        return float(value)
    except ValueError:
        return None


_GETTERS: tp.Dict[str, tp.Callable] = {
    "bpm": get_bpm, "key": get_musical_key,
    "moods": get_keyword_list, "keywords": get_keyword_list,
    "genre": get_keyword, "name": get_keyword, "instrument": get_keyword,
    "title": get_string, "artist": get_string, "description": get_string}


@dataclasses.dataclass
class MusicInfo(AudioInfo):
    """A music segment with its tags. Every field becomes a text attribute
    (lists joined by spaces), except `self_wav`, which becomes the waveform
    condition of the same name, and `joint_embed`, whose conditions become
    joint ones; the model reads only the attributes its conditioners name
    (MusicGen: `description`)."""
    title: tp.Optional[str] = None
    artist: tp.Optional[str] = None
    key: tp.Optional[str] = None
    bpm: tp.Optional[float] = None
    genre: tp.Optional[str] = None
    moods: tp.Optional[list] = None
    keywords: tp.Optional[list] = None
    description: tp.Optional[str] = None
    name: tp.Optional[str] = None
    instrument: tp.Optional[str] = None
    self_wav: tp.Optional[WavCondition] = None
    joint_embed: tp.Dict[str, JointEmbedCondition] = dataclasses.field(
        default_factory=dict)

    @property
    def has_music_meta(self) -> bool:
        return self.name is not None

    def to_condition_attributes(self) -> ConditioningAttributes:
        out = ConditioningAttributes()
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if field.name == "self_wav":
                out.wav[field.name] = value
            elif field.name == "joint_embed":
                out.joint_embed.update(value)
            else:
                out.text[field.name] = (" ".join(value)
                                        if isinstance(value, list) else value)
        return out

    @staticmethod
    def attribute_getter(attribute: str) -> tp.Optional[tp.Callable]:
        return _GETTERS.get(attribute)

    @classmethod
    def from_dict(cls, dictionary: dict, fields_required: bool = False):
        """The info of a sidecar's dict, each tag through its getter. With
        `fields_required` a missing field other than `keywords` raises."""
        values = {}
        for field in dataclasses.fields(cls):
            if field.name in ("self_wav", "joint_embed"):
                continue
            if field.name not in dictionary:
                if fields_required and field.name != "keywords":
                    raise KeyError(f"Unexpected missing key: {field.name}")
                continue
            getter = cls.attribute_getter(field.name)
            value = dictionary[field.name]
            values[field.name] = getter(value) if getter else value
        return cls(**values)


def augment_music_info_description(music_info: MusicInfo,
                                   merge_text_p: float = 0.,
                                   drop_desc_p: float = 0.,
                                   drop_other_p: float = 0.,
                                   rng: tp.Optional[random.Random] = None
                                   ) -> MusicInfo:
    """A copy of the info whose description, with probability
    `merge_text_p`, is followed by 'name: value' pairs of its key, bpm,
    genre, moods, instrument and keywords (each kept with probability
    `drop_other_p`, in a shuffled order), and dropped with probability
    `drop_desc_p`. Draws, in this order: merge, one keep per field, the
    shuffle, the drop."""
    rng = rng or random.Random()

    def kept(name: str, value) -> bool:
        keep = rng.uniform(0, 1) < drop_other_p  # drawn for every field
        return (keep and name in ("key", "bpm", "genre", "moods",
                                  "instrument", "keywords")
                and isinstance(value, (int, float, str, list)))

    def as_text(value) -> str:
        if isinstance(value, (int, float, str)):
            return str(value)
        if isinstance(value, list):
            return ", ".join(value)
        raise ValueError(f"Unknown type for text value! ({type(value), value})")

    description = music_info.description
    metadata_text = ""
    if rng.uniform(0, 1) < merge_text_p:
        pairs = []
        for field in dataclasses.fields(music_info):
            value = getattr(music_info, field.name)
            if kept(field.name, value):
                pairs.append(f"{field.name}: {as_text(value)}")
        rng.shuffle(pairs)
        metadata_text = ". ".join(pairs)
        if rng.uniform(0, 1) < drop_desc_p:
            description = None
    if description is None:
        description = metadata_text if len(metadata_text) > 1 else None
    else:
        description = ". ".join([description.rstrip("."), metadata_text])
    music_info = dataclasses.replace(music_info)
    music_info.description = description.strip() if description else None
    return music_info


class Paraphraser:
    """Replaces a description, with probability `paraphrase_p`, by one of
    the paraphrases that a JSON (or `.json.gz`) source lists under the
    audio file's `.json` path."""

    def __init__(self, paraphrase_source: tp.Union[str, Path],
                 paraphrase_p: float = 0.0):
        self.paraphrase_p = paraphrase_p
        opener = gzip.open if str(paraphrase_source).lower().endswith(".gz") \
            else open
        with opener(paraphrase_source, "rb") as f:
            self.paraphrase_source = json.loads(f.read())
        logger.info(f"loaded paraphrasing source from: {paraphrase_source}")

    def sample_paraphrase(self, audio_path: str, description: str,
                          rng: tp.Optional[random.Random] = None) -> str:
        rng = rng or random.Random()
        if rng.random() >= self.paraphrase_p:
            return description
        info_path = str(Path(audio_path).with_suffix(".json"))
        if info_path not in self.paraphrase_source:
            warn_once(logger, f"{info_path} not in paraphrase source!")
            return description
        new_desc = rng.choice(self.paraphrase_source[info_path])
        logger.debug(f"{description} -> {new_desc}")
        return new_desc


class MusicDataset(InfoAudioDataset):
    """`InfoAudioDataset` whose items are (wav, MusicInfo); see the module's
    docstring. `info_fields_required` makes a sidecar missing a tag an
    error."""

    def __init__(self, *args, info_fields_required: bool = True,
                 merge_text_p: float = 0., drop_desc_p: float = 0.,
                 drop_other_p: float = 0.,
                 joint_embed_attributes: tp.Sequence[str] = (),
                 paraphrase_source: tp.Optional[str] = None,
                 paraphrase_p: float = 0, **kwargs):
        kwargs["return_info"] = True
        super().__init__(*args, **kwargs)
        self.info_fields_required = info_fields_required
        self.merge_text_p = merge_text_p
        self.drop_desc_p = drop_desc_p
        self.drop_other_p = drop_other_p
        self.joint_embed_attributes = list(joint_embed_attributes)
        self.paraphraser = (Paraphraser(paraphrase_source, paraphrase_p)
                            if paraphrase_source is not None else None)

    def item_rng(self, index: int) -> random.Random:
        """The generator of an item's text draws."""
        return random.Random(self._item_seed(index))

    def __getitem__(self, index: int):
        wav, info = super().__getitem__(index)
        info_data = info.to_dict()
        sidecar = Path(info.meta.path).with_suffix(".json")
        if sidecar.exists():
            music_data = json.loads(sidecar.read_text())
            music_data.update(info_data)
            music_info = MusicInfo.from_dict(
                music_data, fields_required=self.info_fields_required)
            rng = self.item_rng(index)
            if self.paraphraser is not None:
                music_info.description = self.paraphraser.sample_paraphrase(
                    music_info.meta.path, music_info.description, rng)
            if self.merge_text_p:
                music_info = augment_music_info_description(
                    music_info, self.merge_text_p, self.drop_desc_p,
                    self.drop_other_p, rng)
        else:
            music_info = MusicInfo.from_dict(info_data, fields_required=False)

        length = torch.tensor([info.n_frames])
        common = dict(sample_rate=[info.sample_rate], path=[info.meta.path],
                      seek_time=[info.seek_time])
        music_info.self_wav = WavCondition(wav=wav[None], length=length,
                                           **common)
        for attribute in self.joint_embed_attributes:
            music_info.joint_embed[attribute] = JointEmbedCondition(
                wav[None], [getattr(music_info, attribute)], length, **common)
        return wav, music_info

    def _copy_info(self, info):
        return copy.deepcopy(info, {id(c.wav): c.wav for c in _wav_conds(info)})

    def collater(self, samples):
        """As `AudioDataset.collater`; each info's waveform conditions then
        view the stacked batch, so that a batch sent from a loader worker
        carries each segment once."""
        wav, infos = super().collater(samples)
        if self.segment_duration is not None:
            for i, info in enumerate(infos):
                row = wav[i:i + 1]
                if info.self_wav is not None:
                    info.self_wav = info.self_wav._replace(wav=row)
                for name, cond in info.joint_embed.items():
                    info.joint_embed[name] = cond._replace(wav=row)
        return wav, infos


def _wav_conds(info) -> list:
    conds = list((getattr(info, "joint_embed", None) or {}).values())
    if getattr(info, "self_wav", None) is not None:
        conds.append(info.self_wav)
    return conds

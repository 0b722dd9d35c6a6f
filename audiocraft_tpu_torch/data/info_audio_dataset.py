"""Datasets whose segments carry conditioning attributes (counterpart of
`audiocraft_tpu/data/info_audio_dataset.py`): every manifest path goes
through the cluster's dataset mappers, and an item's info becomes an
`AudioInfo` (no conditions). Also the keyword cleaners of the music and
sound datasets."""
import dataclasses
import logging
import math
import re
import typing as tp

from ..environment import AudioCraftEnvironment
from ..modules.conditioners import ConditioningAttributes
from .audio_dataset import AudioDataset, AudioMeta, SegmentInfo

logger = logging.getLogger(__name__)


def _clusterify_meta(meta: AudioMeta) -> AudioMeta:
    meta.path = AudioCraftEnvironment.apply_dataset_mappers(meta.path)
    if meta.info_path is not None:
        meta.info_path.zip_path = AudioCraftEnvironment.apply_dataset_mappers(
            meta.info_path.zip_path)
    return meta


def clusterify_all_meta(meta: tp.List[AudioMeta]) -> tp.List[AudioMeta]:
    """The metas with their paths mapped for this cluster (in place)."""
    return [_clusterify_meta(m) for m in meta]


@dataclasses.dataclass
class SegmentWithAttributes(SegmentInfo):
    """A segment that turns into conditioning attributes."""

    def to_condition_attributes(self) -> ConditioningAttributes:
        raise NotImplementedError()


@dataclasses.dataclass
class AudioInfo(SegmentWithAttributes):
    """A plain audio segment: no conditions. `audio_tokens` can carry the
    segment's precomputed codes."""
    audio_tokens: tp.Optional[tp.Any] = None

    def to_condition_attributes(self) -> ConditioningAttributes:
        return ConditioningAttributes()


class InfoAudioDataset(AudioDataset):
    """`AudioDataset` over mapped paths; with `return_info` an item is
    (wav, AudioInfo)."""

    def __init__(self, meta: tp.List[AudioMeta], **kwargs):
        super().__init__(clusterify_all_meta(meta), **kwargs)

    def __getitem__(self, index: int):
        if not self.return_info:
            return super().__getitem__(index)
        wav, info = super().__getitem__(index)
        return wav, AudioInfo(**info.to_dict())


def _valid_string(value) -> bool:
    return isinstance(value, str) and len(value) > 0 and value != "None"


def get_string(value: tp.Optional[str]) -> tp.Optional[str]:
    """The string stripped; None for no string, '' or 'None'."""
    return value.strip() if _valid_string(value) else None


def get_keyword(value: tp.Optional[str]) -> tp.Optional[str]:
    """As `get_string`, lower-cased."""
    return value.strip().lower() if _valid_string(value) else None


def get_keyword_list(values: tp.Union[str, tp.List[str]]
                     ) -> tp.Optional[tp.List[str]]:
    """A list of keywords from a list, or from a string split at commas
    and white space (NaN: none); None when nothing is left."""
    if isinstance(values, str):
        values = [v.strip() for v in re.split(r"[,\s]", values)]
    elif isinstance(values, float) and math.isnan(values):
        values = []
    if not isinstance(values, list):
        logger.debug(f"Unexpected keyword list {values}")
        values = [str(values)]
    keywords = [k for k in map(get_keyword, values) if k is not None]
    return keywords or None


def get_keyword_or_keyword_list(value):
    """`get_keyword_list` of a list, else `get_keyword`."""
    if isinstance(value, list):
        return get_keyword_list(value)
    return get_keyword(value)

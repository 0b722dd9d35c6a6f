"""Segment metadata that turns into conditioning attributes (the
dataclasses of `audiocraft_tpu/data/info_audio_dataset.py`)."""
import dataclasses
import typing as tp

from ..modules.conditioners import ConditioningAttributes
from .audio_dataset import SegmentInfo


@dataclasses.dataclass
class AudioInfo(SegmentInfo):
    """A plain audio segment: no conditions. `audio_tokens` can carry the
    segment's precomputed codes."""
    audio_tokens: tp.Optional[tp.Any] = None

    def to_condition_attributes(self) -> ConditioningAttributes:
        return ConditioningAttributes()

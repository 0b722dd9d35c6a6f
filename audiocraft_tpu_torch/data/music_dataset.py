"""Music segment metadata (the `MusicInfo` dataclass of
`audiocraft_tpu/data/music_dataset.py`)."""
import dataclasses
import typing as tp

from ..modules.conditioners import ConditioningAttributes
from .info_audio_dataset import AudioInfo


@dataclasses.dataclass
class MusicInfo(AudioInfo):
    """A music segment with its tags. Every field becomes a text attribute
    (lists joined by spaces), except `self_wav`, which becomes the waveform
    condition of the same name; the model reads only the attributes its
    conditioners name (MusicGen: `description`)."""
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
    self_wav: tp.Optional[tp.Any] = None

    def to_condition_attributes(self) -> ConditioningAttributes:
        out = ConditioningAttributes()
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if field.name == "self_wav":
                out.wav[field.name] = value
            else:
                out.text[field.name] = (" ".join(value)
                                        if isinstance(value, list) else value)
        return out

"""JASCO segment metadata (the `JascoInfo` dataclass of
`audiocraft_tpu/data/jasco_dataset.py`). The dataset that reads chords and
melody side files is not ported yet (ROADMAP, slice H)."""
import dataclasses
import typing as tp

from ..modules.conditioners import ConditioningAttributes, SymbolicCondition
from .music_dataset import MusicInfo


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
            else:
                out.text[field.name] = (" ".join(value)
                                        if isinstance(value, list) else value)
        return out

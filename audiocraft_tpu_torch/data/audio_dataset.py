"""Audio file and segment metadata (the dataclasses of
`audiocraft_tpu/data/audio_dataset.py`)."""
import dataclasses
import typing as tp


class BaseInfo:
    """`to_dict` over a dataclass's own fields."""

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


@dataclasses.dataclass(order=True)
class AudioMeta(BaseInfo):
    """One audio file of a manifest: path, duration in seconds, sample rate,
    optional peak amplitude, sampling weight and path of a side-info file."""
    path: str
    duration: float
    sample_rate: int
    amplitude: tp.Optional[float] = None
    weight: tp.Optional[float] = None
    info_path: tp.Optional[str] = None


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

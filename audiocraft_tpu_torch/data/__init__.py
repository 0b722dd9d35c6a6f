"""Segment metadata that a training batch carries beside its audio. The
datasets and loaders themselves are not ported yet (ROADMAP, slice H)."""
from .audio_dataset import AudioMeta, SegmentInfo
from .info_audio_dataset import AudioInfo
from .jasco_dataset import JascoInfo
from .music_dataset import MusicInfo

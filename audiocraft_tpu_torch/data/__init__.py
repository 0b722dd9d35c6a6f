"""The host-side data plane: audio files, manifests, datasets and their
loader (counterpart of `audiocraft_tpu/data`)."""
# flake8: noqa
from . import (audio, audio_dataset, audio_utils, info_audio_dataset,
               jasco_dataset, loader, music_dataset, sound_dataset, zip)
from .audio_dataset import AudioDataset, AudioMeta, SegmentInfo
from .info_audio_dataset import AudioInfo, InfoAudioDataset
from .jasco_dataset import JascoDataset, JascoInfo
from .music_dataset import MusicDataset, MusicInfo
from .sound_dataset import SoundDataset, SoundInfo

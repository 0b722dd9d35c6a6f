"""Channel and sample-rate conversion of waveforms (counterpart of
`convert_audio_channels` and `convert_audio` in
`audiocraft_tpu/data/audio_utils.py`)."""
import torch

from ..ops.resample import resample_frac


def convert_audio_channels(wav: torch.Tensor, channels: int = 2) -> torch.Tensor:
    """wav [..., C, T] -> [..., channels, T]: average to mono, repeat mono,
    or keep the first `channels` channels."""
    *shape, src_channels, length = wav.shape
    if src_channels == channels:
        return wav
    if channels == 1:
        return wav.mean(dim=-2, keepdim=True)
    if src_channels == 1:
        return wav.expand(*shape, channels, length)
    if src_channels >= channels:
        return wav[..., :channels, :]
    raise ValueError("The audio file has less channels than requested but is "
                     "not mono.")


def convert_audio(wav, from_rate: float, to_rate: float,
                  to_channels: int) -> torch.Tensor:
    """Resample, then convert channels; wav [..., C, T] as f32."""
    wav = torch.as_tensor(wav, dtype=torch.float32)
    if int(from_rate) != int(to_rate):
        wav = resample_frac(wav, int(from_rate), int(to_rate))
    return convert_audio_channels(wav, to_channels)

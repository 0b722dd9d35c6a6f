"""Notebook helpers (counterpart of `audiocraft_tpu/utils/notebook.py`)."""
from .utils import host_f32


def display_audio(samples, sample_rate: int) -> None:
    """An audio player per item in a notebook. samples: [B, C, T] or
    [C, T], a tensor on any device or an array."""
    import IPython.display as ipd  # only in a notebook
    samples = host_f32(samples)
    assert samples.ndim in (2, 3)
    if samples.ndim == 2:
        samples = samples[None]
    for audio in samples:
        ipd.display(ipd.Audio(audio, rate=sample_rate))

"""Differentiable audio effects: the attacks of watermark training
(counterpart of `audiocraft_tpu/utils/audio_effects.py`).

Every effect takes and returns audio [B, C, T]; with a `mask` it returns
(audio, mask). An effect that draws (`speed`, `echo`, `smooth`,
`random_noise`, `pink_noise`) takes its draws from `generator`, a CPU
`torch.Generator` (None: torch's default), through the module functions
`uniform` and `randn`, so that a step on the card draws what the same step
on the CPU draws, and a test can replace them. The JAX package draws
`speed`, `echo` and `smooth` from Python's `random` and keys the noise
with `random.getrandbits`, inside its traced step, so each draw is made
once per compiled step and then repeated (ROADMAP §3); the port draws
anew at every call. The mp3 and aac attacks go through the libav binding
of the data slice and are not ported (ROADMAP, slice H): they raise.
"""
import typing as tp
from functools import partial

import torch
import torch.nn.functional as F

from ..ops.filters import lowpass_filters
from ..ops.resample import resample_frac

CODEC_EFFECTS = ("mp3_compression", "aac_compression")


def uniform(low: float, high: float,
            generator: tp.Optional[torch.Generator] = None) -> float:
    """A uniform draw in [low, high) (Python's `random.uniform`)."""
    u = float(torch.rand((), generator=generator, dtype=torch.float64))
    return low + (high - low) * u


def randn(shape: tp.Sequence[int], generator: tp.Optional[torch.Generator],
          device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal noise of `shape`, drawn on the CPU, on `device`."""
    return torch.randn(tuple(shape), generator=generator,
                       dtype=dtype).to(device)


def audio_effect_return(tensor: torch.Tensor,
                        mask: tp.Optional[torch.Tensor]):
    if mask is None:
        return tensor
    return tensor, mask


def generate_pink_noise(length: int, generator=None, device=None,
                        dtype=torch.float32) -> torch.Tensor:
    """Voss-McCartney pink noise [length], peak 1: the cumulative sums of
    16 rows of white noise, read row after row."""
    num_rows = 16
    array = randn((num_rows, length // num_rows + 1), generator, device, dtype)
    reshaped = array.cumsum(dim=1).reshape(-1)[:length]
    return reshaped / reshaped.abs().max()


def compress_with_encodec(tensor: torch.Tensor, n_q: int, model,
                          sample_rate: int,
                          mask: tp.Optional[torch.Tensor] = None):
    """An EnCodec round trip at `n_q` codebooks (resampled to the codec's
    rate and back, cut or zero-padded to the input's length) with a
    straight-through gradient: the value of the round trip, the gradient
    of the identity."""
    model.set_num_codebooks(n_q)
    resampled = resample_frac(tensor.detach(), sample_rate, model.sample_rate)
    codes, scale = model.encode(resampled, device=tensor.device)
    compressed = model.decode(codes, scale, device=tensor.device)
    compressed = resample_frac(compressed.to(tensor.dtype), model.sample_rate,
                               sample_rate)[..., :tensor.shape[-1]]
    compressed = F.pad(compressed, (0, tensor.shape[-1] - compressed.shape[-1]))
    out = tensor + (compressed - tensor).detach()
    return audio_effect_return(out, mask)


def _lowpass(x: torch.Tensor, cutoff: float) -> torch.Tensor:
    return lowpass_filters(x, (cutoff,))[0].to(x.dtype)


def _highpass(x: torch.Tensor, cutoff: float) -> torch.Tensor:
    return x - _lowpass(x, cutoff)


class AudioEffects:
    """The attacks; each is a static method over [B, C, T]."""

    @staticmethod
    def speed(tensor, speed_range: tuple = (0.5, 1.5),
              sample_rate: int = 16000, mask=None, generator=None):
        """Playback at a speed drawn from `speed_range`: a resample to
        sample_rate / speed, so the output's length differs; a mask is
        taken to the new length by nearest frame."""
        speed = uniform(*speed_range, generator=generator)
        new_sr = int(sample_rate * 1 / speed)
        resampled = resample_frac(tensor, sample_rate, new_sr)
        if mask is None:
            return resampled
        T_new = resampled.shape[-1]
        idx = torch.clamp(torch.arange(T_new, device=mask.device)
                          * mask.shape[-1] // T_new, max=mask.shape[-1] - 1)
        return resampled, mask.index_select(-1, idx)

    @staticmethod
    def updownresample(tensor, sample_rate: int = 16000,
                       intermediate_freq: int = 32000, mask=None,
                       generator=None):
        orig_T = tensor.shape[-1]
        x = resample_frac(tensor, sample_rate, intermediate_freq)
        x = resample_frac(x, intermediate_freq, sample_rate)[..., :orig_T]
        return audio_effect_return(x, mask)

    @staticmethod
    def echo(tensor, volume_range: tuple = (0.1, 0.5),
             duration_range: tuple = (0.1, 0.5), sample_rate: int = 16000,
             mask=None, generator=None):
        """One reflection of a drawn delay (the duration, drawn first) and
        volume, the result rescaled to the input's peak (over the whole
        batch)."""
        duration = uniform(*duration_range, generator=generator)
        volume = uniform(*volume_range, generator=generator)
        n_samples = int(sample_rate * duration)
        T = tensor.shape[-1]
        delayed = F.pad(tensor, (n_samples - 1, 0))[..., :T]
        reverbed = tensor + volume * delayed
        reverbed = (reverbed / reverbed.abs().max().clamp_min(1e-12)
                    * tensor.abs().max())
        return audio_effect_return(reverbed, mask)

    @staticmethod
    def random_noise(waveform, noise_std: float = 0.001, mask=None,
                     generator=None):
        noise = randn(waveform.shape, generator, waveform.device,
                      waveform.dtype) * noise_std
        return audio_effect_return(waveform + noise, mask)

    @staticmethod
    def pink_noise(waveform, noise_std: float = 0.01, mask=None,
                   generator=None):
        noise = generate_pink_noise(waveform.shape[-1], generator,
                                    waveform.device, waveform.dtype)
        return audio_effect_return(waveform + noise * noise_std, mask)

    @staticmethod
    def lowpass_filter(waveform, cutoff_freq: float = 5000,
                       sample_rate: int = 16000, mask=None, generator=None):
        return audio_effect_return(
            _lowpass(waveform, cutoff_freq / sample_rate), mask)

    @staticmethod
    def highpass_filter(waveform, cutoff_freq: float = 500,
                        sample_rate: int = 16000, mask=None, generator=None):
        return audio_effect_return(
            _highpass(waveform, cutoff_freq / sample_rate), mask)

    @staticmethod
    def bandpass_filter(waveform, cutoff_freq_low: float = 300,
                        cutoff_freq_high: float = 8000,
                        sample_rate: int = 16000, mask=None, generator=None):
        x = _highpass(waveform, cutoff_freq_low / sample_rate)
        x = _lowpass(x, cutoff_freq_high / sample_rate)
        return audio_effect_return(x, mask)

    @staticmethod
    def smooth(tensor, window_size_range: tuple = (2, 10), mask=None,
               generator=None):
        """A moving average over a drawn window (zero-padded, centred)."""
        window_size = int(uniform(*window_size_range, generator=generator))
        B, C, T = tensor.shape
        kernel = torch.full((1, 1, window_size), 1.0 / window_size,
                            dtype=tensor.dtype, device=tensor.device)
        half = window_size // 2
        flat = F.pad(tensor.reshape(B * C, 1, T),
                     (half, window_size - 1 - half))
        return audio_effect_return(F.conv1d(flat, kernel).reshape(B, C, T),
                                   mask)

    @staticmethod
    def boost_audio(tensor, amount: float = 20, mask=None, generator=None):
        return audio_effect_return(tensor * (1 + amount / 100), mask)

    @staticmethod
    def duck_audio(tensor, amount: float = 20, mask=None, generator=None):
        return audio_effect_return(tensor * (1 - amount / 100), mask)

    @staticmethod
    def shush(tensor, fraction: float = 0.001, mask=None, generator=None):
        """Zero the loudest `fraction` of each row's samples (at least
        one; ties with the threshold are zeroed too)."""
        k = max(int(fraction * tensor.shape[-1]), 1)
        mags = tensor.abs()
        thresh = mags.topk(k, dim=-1).values[..., -1:]
        out = torch.where(mags >= thresh, torch.zeros_like(tensor), tensor)
        return audio_effect_return(out, mask)

    @staticmethod
    def identity(tensor, mask=None, generator=None):
        return audio_effect_return(tensor, mask)

    @staticmethod
    def mp3_compression(tensor, sample_rate: int = 16000,
                        bitrate: str = "128k", mask=None, generator=None):
        raise NotImplementedError("the mp3 attack needs the libav binding, "
                                  "which is not ported (ROADMAP, slice H)")

    @staticmethod
    def aac_compression(tensor, sample_rate: int = 16000,
                        bitrate: str = "128k", lowpass_freq=None, mask=None,
                        generator=None):
        raise NotImplementedError("the aac attack needs the libav binding, "
                                  "which is not ported (ROADMAP, slice H)")


def sample(keys: tp.Sequence[str], k: int,
           generator: tp.Optional[torch.Generator] = None) -> tp.List[str]:
    """k distinct keys in a random order (Python's `random.sample`)."""
    order = torch.randperm(len(keys), generator=generator)[:k]
    return [keys[int(i)] for i in order]


def select_audio_effects(audio_effects: tp.Dict[str, tp.Callable],
                         weights: tp.Optional[tp.Dict[str, float]] = None,
                         mode: str = "all",
                         max_length: tp.Optional[int] = None,
                         generator: tp.Optional[torch.Generator] = None
                         ) -> tp.Dict[str, tp.Callable]:
    """A subset of the effects: all, or (`weighted`) each kept when a
    uniform draw falls below its weight (default 1); then at most
    `max_length` of them in a random order; identity when none is left."""
    if mode == "all":
        out = dict(audio_effects)
    elif mode == "weighted":
        assert weights is not None
        out = {name: value for name, value in audio_effects.items()
               if uniform(0.0, 1.0, generator) < weights.get(name, 1.0)}
    else:
        raise ValueError(f"Unknown mode {mode}")
    if max_length is not None:
        keys = sample(list(out), min(max_length, len(out)), generator)
        out = {key: out[key] for key in keys}
    if not out:
        out = {"identity": AudioEffects.identity}
    return out


def get_audio_effects(cfg: dict) -> tp.Dict[str, tp.Callable]:
    """{name: the effect with its config's settings} of
    `cfg['audio_effects']`; names that are not effects are skipped."""
    assert "audio_effects" in cfg
    return {name: partial(getattr(AudioEffects, name), **(effect_cfg or {}))
            for name, effect_cfg in dict(cfg["audio_effects"]).items()
            if hasattr(AudioEffects, name)}

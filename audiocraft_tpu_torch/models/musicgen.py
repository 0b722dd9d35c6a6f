"""MusicGen: text-, melody- and style-conditioned music generation
(counterpart of `audiocraft_tpu/models/musicgen.py`)."""
import typing as tp

import torch

from ..data.audio_utils import convert_audio
from ..modules.conditioners import (ChromaStemConditioner, StyleConditioner,
                                    WavCondition, set_style_params)
from .genmodel import BaseGenModel

# upstream's names of the released checkpoints, resolved as local paths
HF_MODEL_CHECKPOINTS_MAP = {
    "small": "facebook/musicgen-small",
    "medium": "facebook/musicgen-medium",
    "large": "facebook/musicgen-large",
    "melody": "facebook/musicgen-melody",
    "style": "facebook/musicgen-style",
    "stereo-small": "facebook/musicgen-stereo-small",
    "stereo-medium": "facebook/musicgen-stereo-medium",
    "stereo-large": "facebook/musicgen-stereo-large",
    "stereo-melody": "facebook/musicgen-stereo-melody",
}


MelodyType = tp.Union[torch.Tensor, tp.Sequence[tp.Optional[torch.Tensor]]]


class MusicGen(BaseGenModel):
    """Text (and, on a melody model, a melody) -> music. Defaults: duration
    15 s (capped by `max_duration`), sampling with top-k 250, CFG
    coefficient 3."""

    def __init__(self, name, compression_model, lm, max_duration: float = 30,
                 device=None):
        super().__init__(name, compression_model, lm, max_duration, device)
        self.set_generation_params(duration=min(15, self.max_duration),
                                   extend_stride=min(18, self.max_duration / 2))

    @staticmethod
    def get_pretrained(name: str = "debug", device=None) -> "MusicGen":
        """The `debug` model, its interleaved-stereo twin `debug-stereo`,
        its melody twin `debug-melody` or its style twin `debug-style`
        (tiny, seeded random weights), or a
        checkpoint from local files:
        `name` (a released model's short name like 'small' maps to its
        upstream name first) is a directory or file of audiocraft export
        packages, or one under `AUDIOCRAFT_CACHE_DIR`
        (`models/loaders.py`). Nothing is downloaded: a name with no local
        files raises FileNotFoundError."""
        from . import builders, loaders
        if name in ("debug", "debug-stereo", "debug-melody", "debug-style"):
            codec = builders.get_debug_compression_model(device=device)
            if name == "debug":
                lm = builders.get_debug_lm_model(device=device)
            elif name == "debug-melody":
                lm = builders.get_debug_melody_lm_model(device=device)
            elif name == "debug-style":
                lm = builders.get_debug_style_lm_model(device=device)
            else:
                codec = builders.get_wrapped_compression_model(
                    codec, {"interleave_stereo_codebooks": {"use": True}})
                lm = builders.get_debug_stereo_lm_model(device=device)
            return MusicGen(name, codec, lm, max_duration=30, device=device)
        name = HF_MODEL_CHECKPOINTS_MAP.get(name, name)
        codec = loaders.load_compression_model(name, device=device)
        lm, cfg = loaders.load_lm_model(name, device=device)
        conditioners = lm.condition_provider.conditioners
        melody = conditioners["self_wav"] if "self_wav" in conditioners else None
        if isinstance(melody, ChromaStemConditioner):
            # generation matches the chroma to the training duration
            melody.match_len_on_eval = True
        # stereo checkpoints name the interleave in their config
        codec = builders.get_wrapped_compression_model(codec, cfg)
        return MusicGen(name, codec, lm,
                        max_duration=cfg["dataset"]["segment_duration"],
                        device=device)

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 250,
                              top_p: float = 0.0, temperature: float = 1.0,
                              duration: float = 30.0, cfg_coef: float = 3.0,
                              cfg_coef_beta: tp.Optional[float] = None,
                              two_step_cfg: bool = False,
                              extend_stride: float = 18):
        """Sampling, CFG (`two_step_cfg` runs the conditional and null
        forwards as two streams; `cfg_coef_beta` adds the waveform-only rows
        of double CFG on a melody model) and durations."""
        assert extend_stride < self.max_duration, \
            "Cannot stride by more than max generation duration."
        self.extend_stride = extend_stride
        self.duration = duration
        self.generation_params = {
            "use_sampling": use_sampling,
            "temp": temperature,
            "top_k": top_k,
            "top_p": top_p,
            "cfg_coef": cfg_coef,
            "cfg_coef_beta": cfg_coef_beta,
            "two_step_cfg": two_step_cfg,
        }

    def set_style_conditioner_params(self, eval_q: int = 3,
                                     excerpt_length: float = 3.0,
                                     ds_factor: tp.Optional[int] = None,
                                     encodec_n_q: tp.Optional[int] = None):
        """MusicGen-Style's knobs: the RVQ streams kept at eval (`eval_q`,
        at most the conditioner's `n_q_out`), the style excerpt's seconds,
        the downsampling of the style tokens, and the codec streams embedded
        (`encodec_n_q`, which may only shrink)."""
        cond = self.lm.condition_provider.conditioners["self_wav"] \
            if "self_wav" in self.lm.condition_provider.conditioners else None
        assert isinstance(cond, StyleConditioner), \
            "Only use this function if your model is MusicGen-Style"
        set_style_params(cond, eval_q=eval_q, excerpt_length=excerpt_length,
                         ds_factor=ds_factor, encodec_n_q=encodec_n_q)

    def _prepare_tokens_and_attributes(self, descriptions, prompt):
        """The base attributes, with the null melody (or style) on a model
        with a waveform condition."""
        attributes, prompt_tokens = super()._prepare_tokens_and_attributes(
            descriptions, prompt)
        if "self_wav" in self.lm.condition_provider.conditioners:
            for attr in attributes:
                attr.wav["self_wav"] = WavCondition(
                    torch.zeros(1, 1, 1), torch.zeros(1, dtype=torch.long),
                    sample_rate=[self.sample_rate], path=[None])
        return attributes, prompt_tokens

    def generate_with_chroma(self, descriptions: tp.List[tp.Optional[str]],
                             melody_wavs: MelodyType, melody_sample_rate: int,
                             return_tokens: bool = False):
        """Music following each text and the melody (on a melody model) or
        the style (on a style model) of each waveform: one [C, T] per text
        (a list, None for none) or a batch [B, C, T] (or [C, T] for one), at
        `melody_sample_rate`. Each waveform is converted to the model's
        rate in mono; the same one conditions every window past
        `max_duration` (as in the JAX package)."""
        assert "self_wav" in self.lm.condition_provider.conditioners, \
            "This model doesn't support melody conditioning."
        if isinstance(melody_wavs, torch.Tensor):
            if melody_wavs.dim() == 2:
                melody_wavs = melody_wavs[None]
            melody_wavs = list(melody_wavs)
        melodies = []
        for wav in melody_wavs:
            if wav is None:
                melodies.append(None)
                continue
            wav = torch.as_tensor(wav, dtype=torch.float32)
            wav = wav[None] if wav.dim() == 2 else wav[None, None]
            melodies.append(convert_audio(wav.to(self.device),
                                          melody_sample_rate,
                                          self.sample_rate, 1)[0])
        attributes, prompt_tokens = self._prepare_tokens_and_attributes(
            descriptions, None)
        assert len(attributes) == len(melodies)
        for attr, melody in zip(attributes, melodies):
            if melody is not None:
                attr.wav["self_wav"] = WavCondition(
                    melody[None], torch.tensor([melody.shape[-1]]),
                    sample_rate=[self.sample_rate], path=[None])
        tokens = self._generate_tokens(attributes, prompt_tokens)
        audio = self.generate_audio(tokens)
        return (audio, tokens) if return_tokens else audio

"""Base generative model: the user-facing generation API (counterpart of
`audiocraft_tpu/models/genmodel.py`): text-conditioned and unconditional
generation, continuation of an audio prompt, and the sliding window past
`max_duration`."""
import typing as tp

import torch

from ..data.audio_utils import convert_audio
from ..modules.conditioners import ConditioningAttributes
from ..utils import tracing
from ..utils.utils import resolve_device
from .encodec import CompressionModel
from .lm import GenParams, LMModel


class BaseGenModel:
    """A compression model and an LM on one device, with a seeded sampler."""

    def __init__(self, name: str, compression_model: CompressionModel,
                 lm: LMModel, max_duration: float, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.compression_model = compression_model.to(self.device).eval()
        self.lm = lm.to(self.device).eval()
        self.max_duration: float = max_duration
        self.duration = max_duration
        self.extend_stride: tp.Optional[float] = None
        self.generation_params: dict = {}
        self._progress_callback: tp.Optional[tp.Callable[[int, int], None]] = None
        self.generator = torch.Generator(self.device)
        self.set_seed(0)

    def set_seed(self, seed: int):
        """Seed the sampler and the conditioners' own generators (the style
        excerpt's start)."""
        self.generator.manual_seed(seed)
        for cond in self.lm.condition_provider.conditioners.values():
            if hasattr(cond, "set_seed"):
                cond.set_seed(seed)

    def set_custom_progress_callback(
            self, progress_callback: tp.Optional[tp.Callable[[int, int],
                                                             None]] = None):
        """Store a (generated, total) progress callback, as the JAX package
        does. Neither package calls it from inside its decode program (the
        JAX package's compiled scan, the port's CUDA graph)."""
        self._progress_callback = progress_callback

    @property
    def frame_rate(self) -> float:
        return self.compression_model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.compression_model.sample_rate

    @property
    def audio_channels(self) -> int:
        return self.compression_model.channels

    def _prepare_tokens_and_attributes(
            self, descriptions: tp.Sequence[tp.Optional[str]],
            prompt: tp.Optional[torch.Tensor]
    ) -> tp.Tuple[tp.List[ConditioningAttributes], tp.Optional[torch.Tensor]]:
        """Texts -> attributes; a prompt waveform [B, C, T] -> its codes."""
        attributes = [ConditioningAttributes(text={"description": d})
                      for d in descriptions]
        if prompt is None:
            return attributes, None
        assert len(descriptions) == len(prompt), \
            "Prompt and nb. descriptions doesn't match"
        prompt_tokens, scale = self.compression_model.encode(
            prompt, device=self.device)
        assert scale is None
        return attributes, prompt_tokens

    def generate_unconditional(self, num_samples: int,
                               return_tokens: bool = False):
        return self._generate([None] * num_samples, None, return_tokens)

    def generate(self, descriptions: tp.List[str], return_tokens: bool = False):
        """Text-conditioned generation -> audio [B, C, T] (and codes)."""
        return self._generate(descriptions, None, return_tokens)

    def generate_continuation(self, prompt, prompt_sample_rate: int,
                              descriptions: tp.Optional[
                                  tp.List[tp.Optional[str]]] = None,
                              return_tokens: bool = False):
        """Continue the audio prompt [B, C, T] (or [C, T]) at
        `prompt_sample_rate`: it is converted to the model's rate and
        channels, encoded, and kept verbatim at the start of the codes."""
        prompt = torch.as_tensor(prompt, dtype=torch.float32)
        if prompt.dim() == 2:
            prompt = prompt[None]
        if prompt.dim() != 3:
            raise ValueError("prompt should have 3 dimensions: [B, C, T] "
                             "(C = 1).")
        prompt = convert_audio(prompt.to(self.device), prompt_sample_rate,
                               self.sample_rate, self.audio_channels)
        if descriptions is None:
            descriptions = [None] * len(prompt)
        return self._generate(descriptions, prompt, return_tokens)

    def _generate(self, descriptions, prompt, return_tokens: bool):
        with tracing.span("generate", rows=len(descriptions),
                          frames=int(self.duration * self.frame_rate)):
            attributes, prompt_tokens = self._prepare_tokens_and_attributes(
                descriptions, prompt)
            tokens = self._generate_tokens(attributes, prompt_tokens)
            audio = self.generate_audio(tokens)
        return (audio, tokens) if return_tokens else audio

    def _lm_generate(self, prompt_tokens, attributes, max_gen_len: int):
        return self.lm.generate(prompt_tokens, attributes,
                                max_gen_len=max_gen_len,
                                gen=GenParams(**self.generation_params),
                                generator=self.generator, device=self.device)

    def _generate_tokens(self, attributes: tp.List[ConditioningAttributes],
                         prompt_tokens: tp.Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Codes for `self.duration`; past `max_duration` a sliding window
        re-prompts the LM with the last `max_duration - extend_stride`."""
        total_gen_len = int(self.duration * self.frame_rate)
        max_prompt_len = int(min(self.duration, self.max_duration)
                             * self.frame_rate)
        if prompt_tokens is not None:
            assert max_prompt_len >= prompt_tokens.shape[-1], \
                "Prompt is longer than audio to generate"
        if self.duration <= self.max_duration:
            return self._lm_generate(prompt_tokens, attributes, total_gen_len)
        assert self.extend_stride is not None and \
            self.extend_stride < self.max_duration
        all_tokens = []
        prompt_length = 0
        if prompt_tokens is not None:
            all_tokens.append(prompt_tokens)
            prompt_length = prompt_tokens.shape[-1]
        stride_tokens = int(self.frame_rate * self.extend_stride)
        current_gen_offset = 0
        while current_gen_offset + prompt_length < total_gen_len:
            time_offset = current_gen_offset / self.frame_rate
            chunk_duration = min(self.duration - time_offset, self.max_duration)
            max_gen_len = int(chunk_duration * self.frame_rate)
            gen_tokens = self._lm_generate(prompt_tokens, attributes, max_gen_len)
            all_tokens.append(gen_tokens if prompt_tokens is None
                              else gen_tokens[:, :, prompt_tokens.shape[-1]:])
            prompt_tokens = gen_tokens[:, :, stride_tokens:]
            prompt_length = prompt_tokens.shape[-1]
            current_gen_offset += stride_tokens
        return torch.cat(all_tokens, dim=-1)

    def generate_audio(self, gen_tokens: torch.Tensor) -> torch.Tensor:
        """Codes [B, K, T] -> audio [B, C, T * hop]."""
        assert gen_tokens.dim() == 3
        with tracing.span("codec.decode", device=self.device.type == "cuda"):
            return self.compression_model.decode(gen_tokens,
                                                 device=self.device)

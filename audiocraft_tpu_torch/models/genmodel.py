"""Base generative model: the user-facing generation API (counterpart of
`audiocraft_tpu/models/genmodel.py`)."""
import typing as tp

import torch

from ..modules.conditioners import ConditioningAttributes
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
        self.generator = torch.Generator(self.device)
        self.set_seed(0)

    def set_seed(self, seed: int):
        self.generator.manual_seed(seed)

    @property
    def frame_rate(self) -> float:
        return self.compression_model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.compression_model.sample_rate

    @property
    def audio_channels(self) -> int:
        return self.compression_model.channels

    def _prepare_attributes(self, descriptions: tp.Sequence[tp.Optional[str]]
                            ) -> tp.List[ConditioningAttributes]:
        return [ConditioningAttributes(text={"description": d})
                for d in descriptions]

    def generate_unconditional(self, num_samples: int,
                               return_tokens: bool = False):
        return self._generate([None] * num_samples, return_tokens)

    def generate(self, descriptions: tp.List[str], return_tokens: bool = False):
        """Text-conditioned generation -> audio [B, C, T] (and codes)."""
        return self._generate(descriptions, return_tokens)

    def _generate(self, descriptions, return_tokens: bool):
        tokens = self._generate_tokens(self._prepare_attributes(descriptions))
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
        return self.compression_model.decode(gen_tokens, device=self.device)

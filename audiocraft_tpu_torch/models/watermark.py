"""Audio watermarking with AudioSeal: a generator that embeds an n-bit
message as an additive watermark, and a detector (counterpart of
`audiocraft_tpu/models/watermark.py`).

Both are SEANet stacks (weight norm, non-causal, constant padding) under
the `audioseal` package's state-dict names: the generator's `encoder.*`,
`decoder.*` and `msg_processor.msg_embeddings.weight`; the detector's
`detector.0.model.*` (the encoder), `detector.0.reverse_convolution.*` and
`detector.1.*` (the 1x1 head). As in the JAX package, a missing message is
all zeros and `sample_rate` is not used for resampling.
"""
import math
import typing as tp
from abc import ABC, abstractmethod

import torch
import torch.nn as nn

from ..modules.seanet import SEANetDecoder, SEANetEncoder
from ..utils.utils import resolve_device


class MsgProcessor(nn.Module):
    """Adds to the latent [B, D, T] one embedding per (bit, value):
    row 2 i + b_i of `msg_embeddings`, summed over the bits."""

    def __init__(self, nbits: int, hidden_size: int, device=None):
        super().__init__()
        self.nbits = nbits
        self.hidden_size = hidden_size
        self.msg_embeddings = nn.Embedding(2 * nbits, hidden_size,
                                           device=device)

    def forward(self, hidden: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        indices = 2 * torch.arange(msg.shape[-1], device=msg.device) + msg.long()
        return hidden + self.msg_embeddings(indices).sum(dim=-2)[..., None]


def _seanet_args(dimension: int, n_filters: int, n_residual_layers: int,
                 lstm: int, ratios: tp.Sequence[int], channels: int) -> dict:
    return dict(channels=channels, dimension=dimension, n_filters=n_filters,
                n_residual_layers=n_residual_layers, lstm=lstm,
                ratios=tuple(ratios), norm="weight_norm", causal=False,
                pad_mode="constant")


class AudioSealWM(nn.Module):
    """Watermark generator: SEANet encoder, + message, SEANet decoder."""

    def __init__(self, nbits: int = 16, dimension: int = 128,
                 channels: int = 1, n_filters: int = 32,
                 n_residual_layers: int = 1, lstm: int = 2,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), device=None):
        super().__init__()
        kw = _seanet_args(dimension, n_filters, n_residual_layers, lstm,
                          ratios, channels)
        self.nbits = nbits
        self.encoder = SEANetEncoder(device=device, **kw)
        self.decoder = SEANetDecoder(device=device, **kw)
        self.msg_processor = (MsgProcessor(nbits, dimension, device=device)
                              if nbits > 0 else None)

    def get_watermark(self, x: torch.Tensor,
                      message: tp.Optional[torch.Tensor] = None,
                      sample_rate: int = 16_000) -> torch.Tensor:
        """x [B, C, T] -> the watermark [B, C, T]; message [B, nbits] of
        0/1 (default zeros)."""
        hidden = self.encoder(x)
        if self.msg_processor is not None:
            if message is None:
                message = torch.zeros(x.shape[0], self.nbits,
                                      dtype=torch.long, device=x.device)
            hidden = self.msg_processor(hidden, message.to(x.device))
        return self.decoder(hidden)[..., :x.shape[-1]]

    def forward(self, x: torch.Tensor,
                message: tp.Optional[torch.Tensor] = None,
                sample_rate: int = 16_000, alpha: float = 1.0
                ) -> torch.Tensor:
        return x + alpha * self.get_watermark(x, message, sample_rate)


class SEANetEncoderKeepDimension(SEANetEncoder):
    """The SEANet encoder, then a transposed conv of stride hop back to
    the input's sample rate, with `output_dim` channels."""

    def __init__(self, output_dim: int = 8, device=None, **kwargs):
        super().__init__(device=device, **kwargs)
        hop = math.prod(self.ratios)
        self.output_dim = output_dim
        self.reverse_convolution = nn.ConvTranspose1d(
            self.dimension, output_dim, hop, hop, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reverse_convolution(self.model(x))[..., :x.shape[-1]]


class AudioSealDetector(nn.Module):
    """Detector: x [B, C, T] -> [B, 2 + nbits, T], the two detection
    channels softmaxed, then the message logits."""

    def __init__(self, nbits: int = 16, dimension: int = 128,
                 output_dim: int = 32, channels: int = 1, n_filters: int = 32,
                 n_residual_layers: int = 1, lstm: int = 2,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), device=None):
        super().__init__()
        self.nbits = nbits
        encoder = SEANetEncoderKeepDimension(
            output_dim=output_dim, device=device,
            **_seanet_args(dimension, n_filters, n_residual_layers, lstm,
                           ratios, channels))
        self.detector = nn.Sequential(
            encoder, nn.Conv1d(output_dim, 2 + nbits, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.detector(x)
        return torch.cat([torch.softmax(logits[:, :2], dim=1), logits[:, 2:]],
                         dim=1)


class WMModel(ABC):
    """The watermarking interface."""

    @abstractmethod
    def get_watermark(self, x: torch.Tensor,
                      message: tp.Optional[torch.Tensor] = None,
                      sample_rate: int = 16_000) -> torch.Tensor:
        ...

    @abstractmethod
    def detect_watermark(self, x: torch.Tensor) -> torch.Tensor:
        ...


class AudioSeal(WMModel):
    """A generator and a detector trained together, on one device (CUDA
    unless `device` names another)."""

    def __init__(self, generator: AudioSealWM, detector: AudioSealDetector,
                 nbits: int = 0, device=None):
        self.device = resolve_device(device)
        self.generator = generator.to(self.device).eval()
        self.detector = detector.to(self.device).eval()
        self.nbits = nbits if nbits else generator.nbits

    @torch.no_grad()
    def get_watermark(self, x: torch.Tensor,
                      message: tp.Optional[torch.Tensor] = None,
                      sample_rate: int = 16_000) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return self.generator.get_watermark(x, message, sample_rate)

    @torch.no_grad()
    def detect_watermark(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, 2 + nbits, T]."""
        return self.detector(torch.as_tensor(x, dtype=torch.float32).to(
            self.device))

    def forward(self, x: torch.Tensor,
                message: tp.Optional[torch.Tensor] = None,
                sample_rate: int = 16_000, alpha: float = 1.0
                ) -> torch.Tensor:
        """The watermarked audio `x + alpha * watermark`."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return x + alpha * self.get_watermark(x, message, sample_rate)

    @staticmethod
    def get_pretrained(name: str = "base", device=None) -> "AudioSeal":
        """`generator_<name>.pth` and `detector_<name>.pth` of a local
        `facebook/audioseal` snapshot (a path, or one under
        `AUDIOCRAFT_CACHE_DIR`)."""
        from . import loaders
        return loaders.load_audioseal_models("facebook/audioseal",
                                             filename=name, device=device)

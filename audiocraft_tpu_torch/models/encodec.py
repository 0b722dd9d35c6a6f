"""Compression models: the audio-tokenizer API and EnCodec (counterpart of
`audiocraft_tpu/models/encodec.py`).

Audio is [B, C, T] and codes [B, K, T] at the public functions, as in the JAX
package; inside, everything is channels-first.
"""
import typing as tp

import torch
import torch.nn as nn

from ..modules.seanet import SEANetDecoder, SEANetEncoder
from ..quantization import ResidualVectorQuantizer
from ..utils.utils import check_module_device, resolve_device


class CompressionModel(nn.Module):
    """Base API of the audio tokenizers."""

    def encode(self, x: torch.Tensor, device=None):
        raise NotImplementedError()

    def decode(self, codes: torch.Tensor, device=None):
        raise NotImplementedError()

    def decode_latent(self, codes: torch.Tensor):
        raise NotImplementedError()


class EncodecModel(CompressionModel):
    """SEANet encoder -> RVQ -> SEANet decoder."""

    def __init__(self, encoder: SEANetEncoder, decoder: SEANetDecoder,
                 quantizer: ResidualVectorQuantizer, frame_rate: int,
                 sample_rate: int, channels: int):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.quantizer = quantizer
        self.frame_rate = frame_rate
        self.sample_rate = sample_rate
        self.channels = channels

    def _on_device(self, x: torch.Tensor, device) -> torch.Tensor:
        device = resolve_device(device)
        check_module_device(self, device)
        return x.to(device)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Seeded random weights: torch's default conv/LSTM init and
        kaiming-uniform codebooks."""
        device = next(self.parameters()).device
        with torch.random.fork_rng(devices=[device] if device.type == "cuda"
                                   else []):
            torch.manual_seed(seed)
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.LSTM)):
                    m.reset_parameters()
            for layer in self.quantizer.vq.layers:
                embed = layer._codebook.embed
                bound = (3.0 * 2.0 / embed.shape[-1]) ** 0.5
                embed.uniform_(-bound, bound)
                layer._codebook.embed_avg.copy_(embed)

    @torch.no_grad()
    def encode(self, x: torch.Tensor, device=None):
        """[B, C, T] audio -> ([B, K, T_frames] codes, None): no
        renormalization scale, as for every EnCodec MusicGen uses."""
        assert x.dim() == 3
        x = self._on_device(x, device).to(self._dtype)
        return self.quantizer.encode(self.encoder(x)), None

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, device=None) -> torch.Tensor:
        """[B, K, T_frames] codes -> [B, C, T] audio."""
        codes = self._on_device(codes, device)
        return self.decoder(self.quantizer.decode(codes, dtype=self._dtype))

    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> continuous latent [B, T, D] (JAX package layout)."""
        return self.quantizer.decode(codes, dtype=self._dtype).transpose(1, 2)

    @property
    def _dtype(self) -> torch.dtype:
        return next(self.decoder.parameters()).dtype

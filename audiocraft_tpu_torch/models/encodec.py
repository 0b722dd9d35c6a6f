"""Compression models: the audio-tokenizer API and EnCodec (counterpart of
`audiocraft_tpu/models/encodec.py`).

Audio is [B, C, T] and codes [B, K, T] at the public functions, as in the JAX
package; inside, everything is channels-first. `InterleaveStereoCompressionModel`
serves stereo through a mono codec.

`EncodecModel.forward` is the training path: encoder, the quantizer's
training forward (in training mode: EMA codebook updates, k-means of new
codebooks, dead codes, the straight-through estimator) and decoder. With
`renormalize`, the input is divided by its volume (the RMS of its mono
mix, plus 1e-8) before the encoder and the output multiplied by it; encode
returns that scale and decode takes it.
"""
import typing as tp

import torch
import torch.nn as nn

from ..modules.seanet import SEANetDecoder, SEANetEncoder
from ..quantization import BaseQuantizer, QuantizedResult
from ..utils.utils import check_module_device, resolve_device


class CompressionModel(nn.Module):
    """Base API of the audio tokenizers."""

    def encode(self, x: torch.Tensor, device=None):
        raise NotImplementedError()

    def decode(self, codes: torch.Tensor, scale=None, device=None):
        raise NotImplementedError()

    def decode_latent(self, codes: torch.Tensor):
        raise NotImplementedError()


class EncodecModel(CompressionModel):
    """SEANet encoder -> RVQ -> SEANet decoder."""

    def __init__(self, encoder: SEANetEncoder, decoder: SEANetDecoder,
                 quantizer: BaseQuantizer, frame_rate: int,
                 sample_rate: int, channels: int, causal: bool = False,
                 renormalize: bool = False):
        super().__init__()
        if causal:
            assert not renormalize, "Causal model does not support renormalize"
        self.encoder = encoder
        self.decoder = decoder
        self.quantizer = quantizer
        self.frame_rate = frame_rate
        self.sample_rate = sample_rate
        self.channels = channels
        self.causal = causal
        self.renormalize = renormalize

    def _on_device(self, x: torch.Tensor, device) -> torch.Tensor:
        device = resolve_device(device)
        check_module_device(self, device)
        return x.to(device)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        """Seeded random weights: torch's default conv/LSTM init and
        kaiming-uniform codebooks (a k-means codebook that is not `inited`
        stays at zeros)."""
        device = next(self.parameters()).device
        with torch.random.fork_rng(devices=[device] if device.type == "cuda"
                                   else []):
            torch.manual_seed(seed)
            for m in self.modules():
                if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.LSTM)):
                    m.reset_parameters()
            for layer in getattr(getattr(self.quantizer, "vq", None),
                                 "layers", []):
                if not bool(layer._codebook.inited.all()):
                    continue
                embed = layer._codebook.embed
                bound = (3.0 * 2.0 / embed.shape[-1]) ** 0.5
                embed.uniform_(-bound, bound)
                layer._codebook.embed_avg.copy_(embed)

    def preprocess(self, x: torch.Tensor
                   ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """x [B, C, T] -> (x / scale, scale [B, 1]) with `renormalize`,
        else (x, None)."""
        if not self.renormalize:
            return x, None
        mono = x.mean(dim=1, keepdim=True)
        scale = 1e-8 + mono.square().mean(dim=2, keepdim=True).sqrt()
        return x / scale, scale.reshape(-1, 1)

    def postprocess(self, x: torch.Tensor,
                    scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if scale is not None:
            assert self.renormalize
            x = x * scale.reshape(-1, 1, 1).to(x.dtype)
        return x

    def forward(self, x: torch.Tensor,
                generator: tp.Optional[torch.Generator] = None,
                mesh=None) -> QuantizedResult:
        """The training path over audio [B, C, T] (on the model's device):
        a `QuantizedResult` whose x is the decoded audio [B, C, T] (cut to
        the input's length and rescaled), with the codes, the bandwidth and
        the commitment penalty. In training mode the quantizer updates its
        codebooks, drawing from `generator` (over the whole batch when x is
        this rank's slice of it on the data ranks of `mesh`)."""
        assert x.dim() == 3, "audio must be [B, C, T]"
        length = x.shape[-1]
        x, scale = self.preprocess(x)
        q_res = self.quantizer(self.encoder(x), self.frame_rate,
                               generator=generator, mesh=mesh)
        out = self.decoder(q_res.x)
        assert out.shape[-1] >= length, (out.shape[-1], length)
        q_res.x = self.postprocess(out[..., :length], scale)
        return q_res

    @torch.no_grad()
    def encode(self, x: torch.Tensor, device=None):
        """[B, C, T] audio -> ([B, K, T_frames] codes, scale): the scale
        [B, 1] with `renormalize`, else None (every EnCodec MusicGen
        uses)."""
        assert x.dim() == 3
        x = self._on_device(x, device).to(self._dtype)
        x, scale = self.preprocess(x)
        return self.quantizer.encode(self.encoder(x)), scale

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, scale: tp.Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
        """[B, K, T_frames] codes (and the scale of `encode`) -> [B, C, T]
        audio."""
        codes = self._on_device(codes, device)
        out = self.decoder(self.quantizer.decode(codes, dtype=self._dtype))
        if scale is not None:
            scale = self._on_device(scale, device)
        return self.postprocess(out, scale)

    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> continuous latent [B, T, D] (JAX package layout)."""
        return self.quantizer.decode(codes, dtype=self._dtype).transpose(1, 2)

    @property
    def cardinality(self) -> int:
        return self.quantizer.bins

    @property
    def num_codebooks(self) -> int:
        return self.quantizer.num_codebooks

    @property
    def total_codebooks(self) -> int:
        return self.quantizer.total_codebooks

    def set_num_codebooks(self, n: int) -> None:
        self.quantizer.set_num_codebooks(n)

    @property
    def _dtype(self) -> torch.dtype:
        return next(self.decoder.parameters()).dtype


class InterleaveStereoCompressionModel(CompressionModel):
    """Stereo through a mono codec: each channel is encoded on its own and
    the two code streams are interleaved codebook by codebook ([B, 2K, T]:
    left k0, right k0, left k1, ...) or, with `per_timestep`, step by step
    ([B, K, 2T]: left t0, right t0, left t1, ...)."""

    def __init__(self, model: EncodecModel, per_timestep: bool = False):
        super().__init__()
        assert model.channels == 1, "Wrapped model is expected to be mono"
        self.model = model
        self.per_timestep = per_timestep

    @property
    def total_codebooks(self) -> int:
        return self.model.total_codebooks

    @property
    def num_codebooks(self) -> int:
        """Doubled when codebooks are interleaved, unchanged when timesteps
        are."""
        if self.per_timestep:
            return self.model.num_codebooks
        return self.model.num_codebooks * 2

    def set_num_codebooks(self, n: int) -> None:
        assert n % 2 == 0, "Stereo interleaved model expects even codebooks"
        self.model.set_num_codebooks(n // 2)

    @property
    def num_virtual_steps(self) -> int:
        return 2 if self.per_timestep else 1

    @property
    def frame_rate(self) -> float:
        return self.model.frame_rate * self.num_virtual_steps

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def channels(self) -> int:
        return 2

    @property
    def cardinality(self) -> int:
        return self.model.cardinality

    def forward(self, x: torch.Tensor, generator=None):
        raise NotImplementedError("Not supported, use encode and decode.")

    def encode(self, x: torch.Tensor, device=None):
        """[B, 2, T] audio -> (interleaved codes, the channels' scales
        [B, 2, 1] with a renormalizing codec, else None)."""
        B, C, _ = x.shape
        assert C == self.channels, \
            f"Expecting stereo audio but audio num channels is {C}"
        left, scale_left = self.model.encode(x[:, 0:1], device=device)
        right, scale_right = self.model.encode(x[:, 1:2], device=device)
        scales = None
        if scale_left is not None and scale_right is not None:
            scales = torch.stack([scale_left, scale_right], dim=1)
        codes = torch.stack([left, right])  # [2, B, K, T]
        if self.per_timestep:
            return (codes.permute(1, 2, 3, 0).reshape(B, left.shape[1], -1),
                    scales)
        return codes.permute(1, 2, 0, 3).reshape(B, -1, left.shape[-1]), scales

    def get_left_right_codes(self, codes: torch.Tensor
                             ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        if self.per_timestep:
            B, K, T = codes.shape
            codes = codes.reshape(B, K, T // 2, 2)
            return codes[..., 0], codes[..., 1]
        B, K2, T = codes.shape
        codes = codes.reshape(B, K2 // 2, 2, T)
        return codes[:, :, 0], codes[:, :, 1]

    def decode(self, codes: torch.Tensor, scale=None,
               device=None) -> torch.Tensor:
        """Interleaved codes (and the scales of `encode`) -> [B, 2, T]
        audio."""
        B, K, T = codes.shape
        assert T > 0
        assert K == self.num_codebooks, \
            "Provided codes' number of codebooks does not match the model"
        scale_left = scale_right = None
        if scale is not None:
            assert scale.dim() >= 2 and scale.shape[1] == 2
            scale_left, scale_right = scale[:, 0], scale[:, 1]
        left, right = self.get_left_right_codes(codes)
        return torch.cat([self.model.decode(left, scale_left, device=device),
                          self.model.decode(right, scale_right,
                                            device=device)], dim=1)

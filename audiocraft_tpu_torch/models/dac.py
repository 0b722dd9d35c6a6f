"""The Descript Audio Codec (counterpart of `audiocraft_tpu/models/dac.py`):
a Snake-activated convolutional encoder and decoder around a projected
residual vector quantizer whose code lookup is by cosine (L2-normalised
latents and codebooks), with every convolution weight-normed.

The modules keep the `descript-audio-codec` package's state-dict names
(`encoder.block.*`, `decoder.model.*`, `quantizer.quantizers.{i}.in_proj`,
`.out_proj`, `.codebook.weight`, weight norm as `weight_g` / `weight_v`,
Snake's `alpha` [1, C, 1]), so its `weights.pth` loads with no conversion,
and one saved file feeds this package and the JAX one. Channels-first:
audio [B, 1, T], latents [B, D, T], codes [B, K, T]. The convolutions are
plain `conv1d`s over g * v / |v| formed at each call, as the JAX package's
(which floors |v| at 1e-12).
"""
import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encodec import CompressionModel


class Snake1d(nn.Module):
    """x + sin^2(alpha x) / (alpha + 1e-9), alpha per channel."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha
        return x + (1.0 / (a + 1e-9)) * torch.sin(a * x).square()


class WNConv1d(nn.Module):
    """Weight-normed Conv1d (torch's `weight_norm` over dim 0)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 device=None):
        super().__init__()
        conv = nn.Conv1d(in_channels, out_channels, kernel_size, device=device)
        self.stride, self.dilation, self.padding = stride, dilation, padding
        self.weight_v = nn.Parameter(conv.weight.detach().clone())
        self.weight_g = nn.Parameter(
            conv.weight.detach().norm(dim=(1, 2), keepdim=True))
        self.bias = nn.Parameter(conv.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.weight_v.norm(dim=(1, 2), keepdim=True).clamp_min(1e-12)
        return F.conv1d(x, self.weight_v * (self.weight_g / norm), self.bias,
                        self.stride, self.padding, self.dilation)


class WNConvTranspose1d(nn.Module):
    """Weight-normed ConvTranspose1d (`weight_norm` over dim 0, the input
    channels); output length (T - 1) * stride - 2 * padding + kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, device=None):
        super().__init__()
        conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size,
                                  device=device)
        self.stride, self.padding = stride, padding
        self.weight_v = nn.Parameter(conv.weight.detach().clone())
        self.weight_g = nn.Parameter(
            conv.weight.detach().norm(dim=(1, 2), keepdim=True))
        self.bias = nn.Parameter(conv.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.weight_v.norm(dim=(1, 2), keepdim=True).clamp_min(1e-12)
        return F.conv_transpose1d(x, self.weight_v * (self.weight_g / norm),
                                  self.bias, self.stride, self.padding)


class ResidualUnit(nn.Module):
    """Snake, dilated conv 7, Snake, conv 1, plus the input."""

    def __init__(self, dim: int, dilation: int = 1, device=None):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.Sequential(
            Snake1d(dim, device), WNConv1d(dim, dim, 7, dilation=dilation,
                                           padding=pad, device=device),
            Snake1d(dim, device), WNConv1d(dim, dim, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block(x)


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, stride: int, device=None):
        super().__init__()
        h = dim // 2
        self.block = nn.Sequential(
            *[ResidualUnit(h, d, device) for d in (1, 3, 9)],
            Snake1d(h, device),
            WNConv1d(h, dim, 2 * stride, stride=stride,
                     padding=math.ceil(stride / 2), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int,
                 device=None):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(input_dim, device),
            WNConvTranspose1d(input_dim, output_dim, 2 * stride, stride,
                              padding=math.ceil(stride / 2), device=device),
            *[ResidualUnit(output_dim, d, device) for d in (1, 3, 9)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Encoder(nn.Module):
    def __init__(self, d_model: int = 64, strides=(2, 4, 8, 8),
                 d_latent: int = 1024, device=None):
        super().__init__()
        layers: tp.List[nn.Module] = [WNConv1d(1, d_model, 7, padding=3,
                                               device=device)]
        d = d_model
        for stride in strides:
            d *= 2
            layers.append(EncoderBlock(d, stride, device))
        layers += [Snake1d(d, device),
                   WNConv1d(d, d_latent, 3, padding=1, device=device)]
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class Decoder(nn.Module):
    def __init__(self, input_channel: int = 1024, channels: int = 1536,
                 rates=(8, 8, 4, 2), device=None):
        super().__init__()
        layers: tp.List[nn.Module] = [WNConv1d(input_channel, channels, 7,
                                               padding=3, device=device)]
        d = channels
        for stride in rates:
            layers.append(DecoderBlock(d, d // 2, stride, device))
            d //= 2
        layers += [Snake1d(d, device),
                   WNConv1d(d, 1, 7, padding=3, device=device), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class _VectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int,
                 device=None):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, codebook_dim, 1, device=device)
        self.out_proj = WNConv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = nn.Embedding(codebook_size, codebook_dim,
                                     device=device)

    def codes(self, residual: torch.Tensor) -> torch.Tensor:
        """[B, D, T] -> [B, T]: the codebook row of largest cosine with the
        projected latent (the nearest after both are L2-normalised)."""
        e = F.normalize(self.in_proj(residual).transpose(1, 2), dim=-1,
                        eps=1e-12)
        c = F.normalize(self.codebook.weight, dim=-1, eps=1e-12)
        return (e @ c.T).argmax(dim=-1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, D, T]."""
        return self.out_proj(self.codebook(codes).transpose(1, 2))


class DACQuantizer(nn.Module):
    """Projected residual VQ with cosine code lookup."""

    def __init__(self, input_dim: int = 1024, n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: int = 8,
                 device=None):
        super().__init__()
        self.n_codebooks = n_codebooks
        self.quantizers = nn.ModuleList([
            _VectorQuantize(input_dim, codebook_size, codebook_dim, device)
            for _ in range(n_codebooks)])

    def encode(self, z: torch.Tensor,
               n_quantizers: tp.Optional[int] = None) -> torch.Tensor:
        """z [B, D, T] -> codes [B, K, T]."""
        residual, codes = z, []
        for q in self.quantizers[:n_quantizers or self.n_codebooks]:
            idx = q.codes(residual)
            residual = residual - q.decode(idx)
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> latent [B, D, T]."""
        return sum(self.quantizers[i].decode(codes[:, i])
                   for i in range(codes.shape[1]))


class DACModel(nn.Module):
    """The whole codec at the dac package's default 44.1 kHz geometry
    (encoder 64 wide, strides 2-4-8-8, latent 1024; decoder 1536, rates
    8-8-4-2; 9 codebooks of 1024 x 8)."""

    def __init__(self, encoder_dim: int = 64,
                 encoder_rates: tp.Sequence[int] = (2, 4, 8, 8),
                 decoder_dim: int = 1536,
                 decoder_rates: tp.Sequence[int] = (8, 8, 4, 2),
                 n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: int = 8, sample_rate: int = 44100,
                 device=None):
        super().__init__()
        self.encoder_rates = tuple(encoder_rates)
        self.decoder_rates = tuple(decoder_rates)
        self.n_codebooks = n_codebooks
        self.codebook_size = codebook_size
        self.sample_rate = sample_rate
        latent = encoder_dim * 2 ** len(self.encoder_rates)
        self.encoder = Encoder(encoder_dim, self.encoder_rates, latent, device)
        self.quantizer = DACQuantizer(latent, n_codebooks, codebook_size,
                                      codebook_dim, device)
        self.decoder = Decoder(latent, decoder_dim, self.decoder_rates, device)

    @property
    def hop_length(self) -> int:
        return math.prod(self.encoder_rates)

    def encode(self, x: torch.Tensor,
               n_quantizers: tp.Optional[int] = None) -> torch.Tensor:
        """x [B, 1, T] -> codes [B, K, ceil(T / hop)] (right-padded to a hop
        multiple, as dac's preprocess)."""
        pad = (-x.shape[-1]) % self.hop_length
        return self.quantizer.encode(self.encoder(F.pad(x, (0, pad))),
                                     n_quantizers)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.quantizer.from_codes(codes))


class DAC(CompressionModel):
    """The `CompressionModel` interface over a `DACModel`: inference only
    (encode, decode, the codebook count), on one device (CUDA unless
    `device` names another)."""

    def __init__(self, model: DACModel, n_quantizers: tp.Optional[int] = None,
                 device=None):
        from ..utils.utils import resolve_device
        super().__init__()
        self.model = model.to(resolve_device(device)).eval()
        self.model.requires_grad_(False)
        self._n_quantizers = n_quantizers or model.n_codebooks

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def forward(self, x: torch.Tensor, generator=None):
        raise NotImplementedError("DAC is inference only here: use encode "
                                  "and decode")

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def frame_rate(self) -> int:
        return self.model.sample_rate // self.model.hop_length

    @property
    def channels(self) -> int:
        return 1

    @property
    def cardinality(self) -> int:
        return self.model.codebook_size

    @property
    def num_codebooks(self) -> int:
        return self._n_quantizers

    @property
    def total_codebooks(self) -> int:
        return self.model.n_codebooks

    def set_num_codebooks(self, n: int) -> None:
        assert 1 <= n <= self.model.n_codebooks
        self._n_quantizers = n

    @torch.no_grad()
    def encode(self, x: torch.Tensor, device=None):
        """x [B, 1, T] -> (codes [B, K, frames], None)."""
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        return self.model.encode(x, self._n_quantizers), None

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, scale=None, device=None):
        assert scale is None
        return self.model.decode(torch.as_tensor(codes).to(self.device))

    @torch.no_grad()
    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> the quantized latent [B, D, T]."""
        return self.model.quantizer.from_codes(codes.to(self.device))

    @staticmethod
    def get_pretrained(path, n_quantizers: tp.Optional[int] = None,
                       device=None) -> "DAC":
        """A local descript-audio-codec checkpoint: its `weights.pth`
        ({'state_dict', 'metadata': {'kwargs': ...}}, the geometry read
        from the metadata) or a raw state dict at the default geometry."""
        pkg = torch.load(path, map_location="cpu", weights_only=True)
        kwargs: dict = {}
        if isinstance(pkg, dict) and "state_dict" in pkg:
            md = pkg.get("metadata", {}) or {}
            kw = md.get("kwargs", md) if isinstance(md, dict) else {}
            for key in ("encoder_dim", "decoder_dim", "n_codebooks",
                        "codebook_size", "codebook_dim", "sample_rate"):
                if key in kw:
                    kwargs[key] = kw[key]
            for key in ("encoder_rates", "decoder_rates"):
                if key in kw:
                    kwargs[key] = tuple(kw[key])
            pkg = pkg["state_dict"]
        model = DACModel(device="meta", **kwargs)
        model = model.to_empty(device="cpu")
        model.load_state_dict({k: v.float() for k, v in pkg.items()})
        return DAC(model, n_quantizers, device)

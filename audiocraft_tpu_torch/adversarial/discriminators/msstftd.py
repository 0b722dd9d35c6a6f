"""Multi-scale STFT discriminator, EnCodec's adversary (counterpart of
`audiocraft_tpu/adversarial/discriminators/msstftd.py`).

Each sub-discriminator takes an STFT that is not centred, normalised by
the window's L2 norm (torchaudio's Spectrogram(normalized=True)), stacks
the real parts of the C channels then their imaginary parts as 2C input
channels, and runs a stack of 2-D convolutions with LeakyReLU over NCHW
[B, 2C, frames, bins] (the JAX package runs NHWC [B, frames, bins, 2C]).
"""
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modules.conv import NormConv2d
from ...ops.stft import stft
from .base import MultiDiscriminator, MultiDiscriminatorOutputType


def get_2d_padding(kernel_size: tp.Tuple[int, int],
                   dilation: tp.Tuple[int, int] = (1, 1)):
    return (((kernel_size[0] - 1) * dilation[0]) // 2,
            ((kernel_size[1] - 1) * dilation[1]) // 2)


class DiscriminatorSTFT(nn.Module):
    """One STFT resolution: a plain first convolution, one strided
    convolution per dilation (over frames), a square one, and `conv_post`
    to the logits; every convolution but the last one's output (after the
    activation) and the logits are the feature maps."""

    def __init__(self, filters: int, in_channels: int = 1,
                 out_channels: int = 1, n_fft: int = 1024,
                 hop_length: int = 256, win_length: int = 1024,
                 max_filters: int = 1024, filters_scale: int = 1,
                 kernel_size: tp.Tuple[int, int] = (3, 9),
                 dilations: tp.Sequence[int] = (1, 2, 4),
                 stride: tp.Tuple[int, int] = (1, 2), normalized: bool = True,
                 norm: str = "weight_norm", negative_slope: float = 0.2):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.normalized = normalized
        self.negative_slope = negative_slope
        kernel_size = tuple(kernel_size)
        self.convs = nn.ModuleList([NormConv2d(
            2 * in_channels, filters, kernel_size,
            padding=get_2d_padding(kernel_size))])
        in_chs = min(filters_scale * filters, max_filters)
        for i, dilation in enumerate(dilations):
            out_chs = min((filters_scale ** (i + 1)) * filters, max_filters)
            self.convs.append(NormConv2d(
                in_chs, out_chs, kernel_size, stride=tuple(stride),
                dilation=(dilation, 1),
                padding=get_2d_padding(kernel_size, (dilation, 1)), norm=norm))
            in_chs = out_chs
        out_chs = min((filters_scale ** (len(dilations) + 1)) * filters,
                      max_filters)
        k2 = (kernel_size[0], kernel_size[0])
        self.convs.append(NormConv2d(in_chs, out_chs, k2,
                                     padding=get_2d_padding(k2), norm=norm))
        self.conv_post = NormConv2d(out_chs, out_channels, k2,
                                    padding=get_2d_padding(k2), norm=norm)

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        B, C, T = x.shape
        s = stft(x.reshape(B * C, T), self.n_fft, self.hop_length,
                 self.win_length, center=False,
                 normalized="window" if self.normalized is True
                 else self.normalized)
        s = s.reshape(B, C, *s.shape[-2:]).transpose(-1, -2)
        z = torch.cat([s.real, s.imag], dim=1)        # [B, 2C, frames, bins]
        fmap = []
        for conv in self.convs:
            z = F.leaky_relu(conv(z), self.negative_slope)
            fmap.append(z)
        return self.conv_post(z), fmap


class MultiScaleSTFTDiscriminator(MultiDiscriminator):
    """One `DiscriminatorSTFT` per (n_fft, hop, window) resolution."""

    def __init__(self, filters: int = 32, in_channels: int = 1,
                 out_channels: int = 1, sep_channels: bool = False,
                 n_ffts: tp.Sequence[int] = (1024, 2048, 512),
                 hop_lengths: tp.Sequence[int] = (256, 512, 128),
                 win_lengths: tp.Sequence[int] = (1024, 2048, 512),
                 norm: str = "weight_norm"):
        super().__init__()
        assert len(n_ffts) == len(hop_lengths) == len(win_lengths)
        if sep_channels:
            raise NotImplementedError("sep_channels is not supported, as in "
                                      "the JAX package")
        self.discriminators = nn.ModuleList([
            DiscriminatorSTFT(filters, in_channels=in_channels,
                              out_channels=out_channels, n_fft=n_ffts[i],
                              win_length=win_lengths[i],
                              hop_length=hop_lengths[i], norm=norm)
            for i in range(len(n_ffts))])

    @property
    def num_discriminators(self) -> int:
        return len(self.discriminators)

    def forward(self, x: torch.Tensor) -> MultiDiscriminatorOutputType:
        logits, fmaps = [], []
        for disc in self.discriminators:
            logit, fmap = disc(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps

"""Multi-period discriminator, HiFi-GAN's (counterpart of
`audiocraft_tpu/adversarial/discriminators/mpd.py`): the waveform, reflect-
padded to a multiple of the period p, is viewed as NCHW [B, C, T / p, p]
and runs a stack of (k, 1) convolutions over T / p."""
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modules.conv import NormConv2d
from .base import MultiDiscriminator, MultiDiscriminatorOutputType


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, in_channels: int = 1, out_channels: int = 1,
                 n_layers: int = 5, kernel_sizes: tp.Sequence[int] = (5, 3),
                 stride: int = 3, filters: int = 8, filters_scale: int = 4,
                 max_filters: int = 1024, norm: str = "weight_norm",
                 negative_slope: float = 0.2):
        super().__init__()
        self.period = period
        self.negative_slope = negative_slope
        self.convs = nn.ModuleList()
        in_chs = in_channels
        for i in range(n_layers):
            out_chs = min(filters * (filters_scale ** (i + 1)), max_filters)
            eff_stride = 1 if i == n_layers - 1 else stride
            self.convs.append(NormConv2d(
                in_chs, out_chs, kernel_size=(kernel_sizes[0], 1),
                stride=(eff_stride, 1),
                padding=((kernel_sizes[0] - 1) // 2, 0), norm=norm))
            in_chs = out_chs
        self.conv_post = NormConv2d(in_chs, out_channels,
                                    kernel_size=(kernel_sizes[1], 1),
                                    padding=((kernel_sizes[1] - 1) // 2, 0),
                                    norm=norm)

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        b, c, t = x.shape
        if t % self.period != 0:
            n_pad = self.period - (t % self.period)
            x = F.pad(x, (0, n_pad), mode="reflect")
            t = t + n_pad
        h = x.reshape(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.negative_slope)
            fmap.append(h)
        logits = self.conv_post(h)
        fmap.append(logits)
        return logits, fmap


class MultiPeriodDiscriminator(MultiDiscriminator):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 periods: tp.Sequence[int] = (2, 3, 5, 7, 11), filters: int = 8,
                 norm: str = "weight_norm"):
        super().__init__()
        self.discriminators = nn.ModuleList([
            PeriodDiscriminator(p, in_channels, out_channels, filters=filters,
                                norm=norm) for p in periods])

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

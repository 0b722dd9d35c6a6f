"""Multi-scale waveform discriminator, MelGAN's (counterpart of
`audiocraft_tpu/adversarial/discriminators/msd.py`): each scale after the
first runs on the previous scale's input average-pooled (zero-padded, and
divided by the whole kernel). Upstream audiocraft drops the pooled result
(`msd.py:122` there); the JAX package pools, and so does the port."""
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modules.conv import NormConv1d, pad1d
from .base import MultiDiscriminator, MultiDiscriminatorOutputType


class ScaleDiscriminator(nn.Module):
    """A reflect-padded input convolution, grouped strided convolutions
    (groups = in_channels // 4), a middle convolution and `conv_post`;
    every output after its activation, and the logits, are feature maps."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 kernel_sizes: tp.Sequence[int] = (5, 3), filters: int = 16,
                 max_filters: int = 1024,
                 downsample_scales: tp.Sequence[int] = (4, 4, 4, 4),
                 norm: str = "weight_norm", negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.k0 = int(np.prod(kernel_sizes))
        self.convs = nn.ModuleList([NormConv1d(in_channels, filters,
                                               self.k0, norm=norm)])
        in_chs = filters
        for scale in downsample_scales:
            out_chs = min(in_chs * scale, max_filters)
            kernel_size = scale * 10 + 1
            self.convs.append(NormConv1d(
                in_chs, out_chs, kernel_size, stride=scale,
                groups=in_chs // 4, padding=(kernel_size - 1) // 2, norm=norm))
            in_chs = out_chs
        out_chs = min(in_chs * 2, max_filters)
        self.convs.append(NormConv1d(in_chs, out_chs, kernel_sizes[0],
                                     padding=(kernel_sizes[0] - 1) // 2,
                                     norm=norm))
        self.conv_post = NormConv1d(out_chs, out_channels, kernel_sizes[1],
                                    padding=(kernel_sizes[1] - 1) // 2,
                                    norm=norm)

    def forward(self, x: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        pad = (self.k0 - 1) // 2
        h = pad1d(x, (pad, pad), mode="reflect")
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), self.negative_slope)
            fmap.append(h)
        logits = self.conv_post(h)
        fmap.append(logits)
        return logits, fmap


class MultiScaleDiscriminator(MultiDiscriminator):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 downsample_factor: int = 2,
                 scale_norms: tp.Sequence[str] = ("weight_norm",) * 3,
                 filters: int = 16):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.discriminators = nn.ModuleList([
            ScaleDiscriminator(in_channels, out_channels, norm=norm,
                               filters=filters)
            for norm in scale_norms])

    @property
    def num_discriminators(self) -> int:
        return len(self.discriminators)

    def forward(self, x: torch.Tensor) -> MultiDiscriminatorOutputType:
        logits, fmaps = [], []
        f = self.downsample_factor
        for i, disc in enumerate(self.discriminators):
            if i != 0:
                x = F.avg_pool1d(x, 2 * f, f, padding=f)
            logit, fmap = disc(x)
            logits.append(logit)
            fmaps.append(fmap)
        return logits, fmaps

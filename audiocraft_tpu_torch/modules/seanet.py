"""SEANet encoder/decoder, the EnCodec conv stack (counterpart of
`audiocraft_tpu/modules/seanet.py`).

Channels-first [B, C, T]. Layers sit in one `model` Sequential in upstream
audiocraft's order, activations included, so state-dict keys match
(`decoder.model.{i}.convtr.convtr.weight`, `...block.{1,3}.conv.conv...`).
"""
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from .activations import Activation
from .conv import StreamableConv1d, StreamableConvTranspose1d
from .lstm import StreamableLSTM

_ActParams = tp.Optional[tp.Mapping[str, tp.Any]]


class SEANetResnetBlock(nn.Module):
    """Residual block: [act, conv] per kernel size, identity (or 1x1 conv)
    shortcut."""

    def __init__(self, dim: int, kernel_sizes: tp.Sequence[int] = (3, 1),
                 dilations: tp.Sequence[int] = (1, 1), activation: str = "elu",
                 activation_params: _ActParams = None,
                 norm: str = "none", norm_params: _ActParams = None,
                 causal: bool = False, pad_mode: str = "reflect",
                 compress: int = 2, true_skip: bool = True, device=None,
                 dtype=None):
        super().__init__()
        assert len(kernel_sizes) == len(dilations)
        hidden = dim // compress
        common = dict(norm=norm, norm_kwargs=norm_params, causal=causal,
                      pad_mode=pad_mode, device=device, dtype=dtype)
        block: tp.List[nn.Module] = []
        n = len(kernel_sizes)
        for i, (kernel_size, dilation) in enumerate(zip(kernel_sizes, dilations)):
            in_chs = dim if i == 0 else hidden
            out_chs = dim if i == n - 1 else hidden
            block += [Activation(activation, activation_params),
                      StreamableConv1d(in_chs, out_chs, kernel_size=kernel_size,
                                       dilation=dilation, **common)]
        self.block = nn.Sequential(*block)
        self.shortcut: nn.Module = (nn.Identity() if true_skip else
                                    StreamableConv1d(dim, dim, kernel_size=1,
                                                     **common))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class _SEANet(nn.Module):
    def __init__(self, channels: int, dimension: int, n_filters: int,
                 ratios: tp.Sequence[int], disable_norm_outer_blocks: int):
        super().__init__()
        self.channels = channels
        self.dimension = dimension
        self.n_filters = n_filters
        self.ratios = tuple(ratios)
        self.hop_length = int(np.prod(self.ratios))
        self.n_blocks = len(self.ratios) + 2
        assert 0 <= disable_norm_outer_blocks <= self.n_blocks

    def _resblock(self, dim, j, block_norm, **kw):
        return SEANetResnetBlock(
            dim, kernel_sizes=(kw["residual_kernel_size"], 1),
            dilations=(kw["dilation_base"] ** j, 1),
            activation=kw["activation"],
            activation_params=kw["activation_params"],
            norm=block_norm, norm_params=kw["norm_params"],
            causal=kw["causal"], pad_mode=kw["pad_mode"],
            compress=kw["compress"], true_skip=kw["true_skip"],
            device=kw["device"], dtype=kw["dtype"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class SEANetEncoder(_SEANet):
    """conv -> [resblocks + strided downsample per ratio] -> LSTM -> conv.
    `ratios` are given in decoder order and reversed here."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 3,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), activation: str = "elu",
                 activation_params: _ActParams = None,
                 norm: str = "none", norm_params: _ActParams = None,
                 kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, causal: bool = False,
                 pad_mode: str = "reflect", true_skip: bool = True,
                 compress: int = 2, lstm: int = 0,
                 disable_norm_outer_blocks: int = 0, device=None, dtype=None):
        super().__init__(channels, dimension, n_filters, ratios,
                         disable_norm_outer_blocks)
        kw = dict(residual_kernel_size=residual_kernel_size,
                  dilation_base=dilation_base, activation=activation,
                  activation_params=activation_params,
                  norm_params=norm_params,
                  causal=causal, pad_mode=pad_mode, compress=compress,
                  true_skip=true_skip, device=device, dtype=dtype)
        conv = dict(norm_kwargs=norm_params, causal=causal, pad_mode=pad_mode,
                    device=device, dtype=dtype)
        dnob = disable_norm_outer_blocks
        mult = 1
        layers: tp.List[nn.Module] = [StreamableConv1d(
            channels, mult * n_filters, kernel_size,
            norm="none" if dnob >= 1 else norm, **conv)]
        for i, ratio in enumerate(reversed(self.ratios)):
            block_norm = "none" if dnob >= i + 2 else norm
            for j in range(n_residual_layers):
                layers.append(self._resblock(mult * n_filters, j, block_norm,
                                             **kw))
            layers += [Activation(activation, activation_params),
                       StreamableConv1d(mult * n_filters, mult * n_filters * 2,
                                        kernel_size=ratio * 2, stride=ratio,
                                        norm=block_norm, **conv)]
            mult *= 2
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         device=device, dtype=dtype))
        layers += [Activation(activation, activation_params),
                   StreamableConv1d(mult * n_filters, dimension,
                                    last_kernel_size,
                                    norm="none" if dnob == self.n_blocks
                                    else norm, **conv)]
        self.model = nn.Sequential(*layers)


class SEANetDecoder(_SEANet):
    """Mirror of the encoder with transposed convs."""

    def __init__(self, channels: int = 1, dimension: int = 128,
                 n_filters: int = 32, n_residual_layers: int = 3,
                 ratios: tp.Sequence[int] = (8, 5, 4, 2), activation: str = "elu",
                 activation_params: _ActParams = None,
                 norm: str = "none", norm_params: _ActParams = None,
                 kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, causal: bool = False,
                 pad_mode: str = "reflect", true_skip: bool = True,
                 compress: int = 2, lstm: int = 0,
                 disable_norm_outer_blocks: int = 0,
                 trim_right_ratio: float = 1.0, device=None, dtype=None):
        super().__init__(channels, dimension, n_filters, ratios,
                         disable_norm_outer_blocks)
        kw = dict(residual_kernel_size=residual_kernel_size,
                  dilation_base=dilation_base, activation=activation,
                  activation_params=activation_params,
                  norm_params=norm_params,
                  causal=causal, pad_mode=pad_mode, compress=compress,
                  true_skip=true_skip, device=device, dtype=dtype)
        dnob = disable_norm_outer_blocks
        mult = int(2 ** len(self.ratios))
        layers: tp.List[nn.Module] = [StreamableConv1d(
            dimension, mult * n_filters, kernel_size,
            norm="none" if dnob == self.n_blocks else norm,
            norm_kwargs=norm_params, causal=causal, pad_mode=pad_mode,
            device=device, dtype=dtype)]
        if lstm:
            layers.append(StreamableLSTM(mult * n_filters, num_layers=lstm,
                                         device=device, dtype=dtype))
        for i, ratio in enumerate(self.ratios):
            block_norm = "none" if dnob >= self.n_blocks - (i + 1) else norm
            layers += [Activation(activation, activation_params),
                       StreamableConvTranspose1d(
                           mult * n_filters, mult * n_filters // 2,
                           kernel_size=ratio * 2, stride=ratio, norm=block_norm,
                           norm_kwargs=norm_params, causal=causal,
                           trim_right_ratio=trim_right_ratio,
                           device=device, dtype=dtype)]
            for j in range(n_residual_layers):
                layers.append(self._resblock(mult * n_filters // 2, j,
                                             block_norm, **kw))
            mult //= 2
        layers += [Activation(activation, activation_params),
                   StreamableConv1d(n_filters, channels, last_kernel_size,
                                    norm="none" if dnob >= 1 else norm,
                                    norm_kwargs=norm_params, causal=causal,
                                    pad_mode=pad_mode, device=device,
                                    dtype=dtype)]
        self.model = nn.Sequential(*layers)

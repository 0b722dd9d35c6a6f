"""Streamable 1d convolutions with causal / asymmetric padding laws
(counterpart of `audiocraft_tpu/modules/conv.py`).

Layout is channels-first [B, C, T]. Module nesting follows upstream
audiocraft (`StreamableConv1d.conv.conv.weight`); with weight norm the
parameters are `weight_g` / `weight_v` as in torch's `weight_norm(dim=0)`:
per output channel for a conv ([Cout, Cin, K]) and per *input* channel for a
transposed conv ([Cin, Cout, K]). `NormConv2d` (the discriminators') is
NCHW, its weight [Cout, Cin, kh, kw] normed per output channel.

`time_group_norm` is a GroupNorm of one group (over channels and time)
after the convolution and its bias, `norm` beside `conv` in the module tree
(upstream's key `conv.norm.weight`). Its `norm_kwargs` are flax's
`nn.GroupNorm` names with flax's defaults (`epsilon` 1e-6, `use_bias`,
`use_scale`), so one `norm_params` means the same in both packages.
`spectral_norm` applies no normalisation: the weight is a plain parameter,
as in the JAX package.
"""
import math
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

CONV_NORMALIZATIONS = frozenset(["none", "weight_norm", "spectral_norm",
                                 "time_group_norm"])


def get_extra_padding_for_conv1d(length: int, kernel_size: int, stride: int,
                                 padding_total: int = 0) -> int:
    """Extra right padding so that the last window is full."""
    n_frames = (length - kernel_size + padding_total) / stride + 1
    ideal_length = (math.ceil(n_frames) - 1) * stride + (kernel_size - padding_total)
    return ideal_length - length


def pad1d(x: torch.Tensor, paddings: tp.Tuple[int, int], mode: str = "constant",
          value: float = 0.0) -> torch.Tensor:
    """Pad the time axis; reflect-pads an input shorter than the pad by
    zero-extending it first."""
    length = x.shape[-1]
    padding_left, padding_right = paddings
    assert padding_left >= 0 and padding_right >= 0, (padding_left, padding_right)
    if mode == "reflect":
        max_pad = max(padding_left, padding_right)
        extra_pad = 0
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            x = F.pad(x, (0, extra_pad))
        padded = F.pad(x, paddings, mode="reflect")
        return padded[..., :padded.shape[-1] - extra_pad]
    return F.pad(x, paddings, mode="constant", value=value)


def unpad1d(x: torch.Tensor, paddings: tp.Tuple[int, int]) -> torch.Tensor:
    padding_left, padding_right = paddings
    assert padding_left >= 0 and padding_right >= 0, (padding_left, padding_right)
    assert padding_left + padding_right <= x.shape[-1]
    return x[..., padding_left:x.shape[-1] - padding_right]


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / ||v||, the norm over every axis but the first (torch
    `weight_norm(dim=0)`), floored at 1e-12 as the JAX package does."""
    norm = v.square().sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return v * (g / norm.clamp_min(1e-12))


def _norm_over_rest(w: torch.Tensor) -> torch.Tensor:
    """||w|| over every axis but the first, kept as [C, 1, ...]."""
    return w.square().sum(dim=tuple(range(1, w.dim())), keepdim=True).sqrt()


class TimeGroupNorm(nn.Module):
    """GroupNorm of one group over [B, C, T] (flax `nn.GroupNorm(
    num_groups=1)` over [B, T, C]): `weight` and `bias` [C] unless
    `use_scale` / `use_bias` is False."""

    def __init__(self, channels: int, epsilon: float = 1e-6,
                 use_bias: bool = True, use_scale: bool = True, device=None,
                 dtype=None):
        super().__init__()
        self.epsilon = epsilon
        factory = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(channels, **factory))
                       if use_scale else None)
        self.bias = (nn.Parameter(torch.zeros(channels, **factory))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, 1, self.weight, self.bias, self.epsilon)


def _norm_module(conv: nn.Module, norm: str,
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]]
                 ) -> nn.Module:
    if norm != "time_group_norm":
        return nn.Identity()
    # a time_group_norm conv keeps a plain weight
    return TimeGroupNorm(conv.out_channels, **dict(norm_kwargs or {}),
                         device=conv.weight.device, dtype=conv.weight.dtype)


class _NormMixin:
    """Weight-norm reparametrisation of a torch conv's `weight` (the other
    norms leave the weight a plain parameter)."""

    def _setup_norm(self, norm: str):
        if norm not in CONV_NORMALIZATIONS:
            raise ValueError(f"unknown norm {norm!r}")
        self.norm_type = norm
        if norm == "weight_norm":
            w = self.weight.detach()
            del self.weight
            self.weight_v = nn.Parameter(w.clone())
            self.weight_g = nn.Parameter(_norm_over_rest(w))

    def reset_parameters(self) -> None:
        """torch's conv init; with weight norm, v takes it and g = ||v||."""
        if getattr(self, "norm_type", "none") != "weight_norm":
            super().reset_parameters()
            return
        with torch.no_grad():
            w = torch.empty_like(self.weight_v)
            nn.init.kaiming_uniform_(w, a=math.sqrt(5))
            self.weight_v.copy_(w)
            self.weight_g.copy_(_norm_over_rest(w))
            if self.bias is not None:
                bound = 1 / math.sqrt(math.prod(w.shape[1:]))
                nn.init.uniform_(self.bias, -bound, bound)

    def _weight(self) -> torch.Tensor:
        if self.norm_type == "weight_norm":
            return weight_norm_kernel(self.weight_v, self.weight_g)
        return self.weight


class Conv1d(_NormMixin, nn.Conv1d):
    def __init__(self, *args, norm: str = "none", **kwargs):
        super().__init__(*args, **kwargs)
        self._setup_norm(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self._weight(), self.bias)


class ConvTranspose1d(_NormMixin, nn.ConvTranspose1d):
    def __init__(self, *args, norm: str = "none", **kwargs):
        super().__init__(*args, **kwargs)
        self._setup_norm(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self._weight(), self.bias, self.stride)


class Conv2d(_NormMixin, nn.Conv2d):
    def __init__(self, *args, norm: str = "none", **kwargs):
        super().__init__(*args, **kwargs)
        self._setup_norm(norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self._weight(), self.bias)


class NormConv1d(nn.Module):
    """Conv1d with its normalization (upstream key `conv.weight...`)."""

    def __init__(self, *args, norm: str = "none", causal: bool = False,
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 **kwargs):
        super().__init__()
        assert not (causal and norm == "time_group_norm"), \
            "GroupNorm doesn't support causal evaluation."
        self.conv = Conv1d(*args, norm=norm, **kwargs)
        self.norm = _norm_module(self.conv, norm, norm_kwargs)

    def forward(self, x):
        return self.norm(self.conv(x))


class NormConvTranspose1d(nn.Module):
    def __init__(self, *args, norm: str = "none", causal: bool = False,
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 **kwargs):
        super().__init__()
        assert not (causal and norm == "time_group_norm"), \
            "GroupNorm doesn't support causal evaluation."
        self.convtr = ConvTranspose1d(*args, norm=norm, **kwargs)
        self.norm = _norm_module(self.convtr, norm, norm_kwargs)

    def forward(self, x):
        return self.norm(self.convtr(x))


class StreamableConv1d(nn.Module):
    """Conv1d with built-in causal or symmetric padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, causal: bool = False, norm: str = "none",
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 pad_mode: str = "reflect", device=None, dtype=None):
        super().__init__()
        self.conv = NormConv1d(in_channels, out_channels, kernel_size,
                               stride=stride, dilation=dilation, groups=groups,
                               bias=bias, norm=norm, causal=causal,
                               norm_kwargs=norm_kwargs, device=device,
                               dtype=dtype)
        self.causal = causal
        self.pad_mode = pad_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv.conv
        kernel_size = (conv.kernel_size[0] - 1) * conv.dilation[0] + 1
        stride = conv.stride[0]
        padding_total = kernel_size - stride
        extra_padding = get_extra_padding_for_conv1d(
            x.shape[-1], kernel_size, stride, padding_total)
        if self.causal:
            x = pad1d(x, (padding_total, extra_padding), mode=self.pad_mode)
        else:
            padding_right = padding_total // 2
            padding_left = padding_total - padding_right
            x = pad1d(x, (padding_left, padding_right + extra_padding),
                      mode=self.pad_mode)
        return self.conv(x)


class StreamableConvTranspose1d(nn.Module):
    """ConvTranspose1d with causal or symmetric trimming."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, causal: bool = False, norm: str = "none",
                 trim_right_ratio: float = 1.0,
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 device=None, dtype=None):
        super().__init__()
        assert causal or trim_right_ratio == 1.0, \
            "`trim_right_ratio` != 1.0 only makes sense for causal convolutions"
        self.convtr = NormConvTranspose1d(in_channels, out_channels, kernel_size,
                                          stride=stride, norm=norm,
                                          causal=causal,
                                          norm_kwargs=norm_kwargs,
                                          device=device, dtype=dtype)
        self.causal = causal
        self.trim_right_ratio = trim_right_ratio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convtr = self.convtr.convtr
        padding_total = convtr.kernel_size[0] - convtr.stride[0]
        y = self.convtr(x)
        if self.causal:
            padding_right = math.ceil(padding_total * self.trim_right_ratio)
        else:
            padding_right = padding_total // 2
        return unpad1d(y, (padding_total - padding_right, padding_right))


class NormConv2d(nn.Module):
    """Conv2d over NCHW with its normalization (upstream key
    `conv.weight...`)."""

    def __init__(self, *args, norm: str = "none",
                 norm_kwargs: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 **kwargs):
        super().__init__()
        self.conv = Conv2d(*args, norm=norm, **kwargs)
        self.norm = _norm_module(self.conv, norm, norm_kwargs)

    def forward(self, x):
        return self.norm(self.conv(x))

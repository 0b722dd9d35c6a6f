"""1-D convolutional U-Net for waveform diffusion, the Multi-Band Diffusion
denoiser (counterpart of `audiocraft_tpu/models/unet.py`).

Channels-first [B, C, T] with upstream audiocraft's module names
(`encoders.{d}.conv`, `encoders.{d}.res_blocks.{j}.norm1`,
`decoders.{k}.convtr`, `embedding`, `embeddings.{d-1}`, `bilstm.lstm`,
`bilstm.linear`, `transformer.layers.{i}`, `conv_codec`), so upstream's
`model_state` loads as it is. `decoders` holds the deepest decoder first.
"""
import typing as tp

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..modules.transformer import StreamingTransformer, create_sin_embedding


class ResBlock(nn.Module):
    """Two (group norm, ReLU, dilated conv) blocks around a residual."""

    def __init__(self, channels: int, kernel: int = 3, norm_groups: int = 4,
                 dilation: int = 1, dropout: float = 0.0, device=None):
        super().__init__()
        padding = dilation * (kernel - 1) // 2
        conv = dict(kernel_size=kernel, padding=padding, dilation=dilation,
                    device=device)
        self.norm1 = nn.GroupNorm(norm_groups, channels, device=device)
        self.conv1 = nn.Conv1d(channels, channels, **conv)
        self.norm2 = nn.GroupNorm(norm_groups, channels, device=device)
        self.conv2 = nn.Conv1d(channels, channels, **conv)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.conv1(F.relu(self.norm1(x))))
        h = self.dropout(self.conv2(F.relu(self.norm2(h))))
        return x + h


class EncoderLayer(nn.Module):
    """Right-pad to a multiple of the stride, strided conv, group norm,
    ReLU, residual blocks."""

    def __init__(self, chin: int, chout: int, kernel: int = 4, stride: int = 2,
                 norm_groups: int = 4, res_blocks: int = 1,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(chin, chout, kernel, stride,
                              (kernel - stride) // 2, bias=False,
                              device=device)
        self.norm = nn.GroupNorm(norm_groups, chout, device=device)
        self.res_blocks = nn.Sequential(*[
            ResBlock(chout, norm_groups=norm_groups, dilation=2 ** idx,
                     dropout=dropout, device=device)
            for idx in range(res_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, (self.stride - x.shape[-1] % self.stride) % self.stride))
        return self.res_blocks(F.relu(self.norm(self.conv(x))))


class DecoderLayer(nn.Module):
    """Residual blocks, group norm, ReLU, transposed conv (its padding
    trims (kernel - stride) // 2 samples from each end)."""

    def __init__(self, chin: int, chout: int, kernel: int = 4, stride: int = 2,
                 norm_groups: int = 4, res_blocks: int = 1,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.res_blocks = nn.Sequential(*[
            ResBlock(chin, norm_groups=norm_groups, dilation=2 ** idx,
                     dropout=dropout, device=device)
            for idx in range(res_blocks)])
        self.norm = nn.GroupNorm(norm_groups, chin, device=device)
        self.convtr = nn.ConvTranspose1d(chin, chout, kernel, stride,
                                         (kernel - stride) // 2, bias=False,
                                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convtr(F.relu(self.norm(self.res_blocks(x))))


class BLSTM(nn.Module):
    """Bidirectional LSTM of `layers` layers (the second reads 2 * dim)
    and a Linear(2 * dim, dim), over [B, dim, T]."""

    def __init__(self, dim: int, layers: int = 2, device=None):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=layers, bidirectional=True,
                            device=device)
        self.linear = nn.Linear(2 * dim, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, _ = self.lstm(x.permute(2, 0, 1))
        return self.linear(y).permute(1, 2, 0)


class DiffusionUnet(nn.Module):
    """(x [B, chin, T], step: int or [B], condition [B, codec_dim, Tc])
    -> noise estimate [B, chin, T]. The step embedding is added after the
    first encoder (and after each, with `emb_all_layers`); the bottleneck
    is a BiLSTM, a 6-layer transformer (`transformer`), or zeros; the codec
    condition enters there through a 1x1 conv, added after a nearest
    resample or, with `cross_attention` in the transformer, attended with
    sinusoidal positions."""

    def __init__(self, chin: int = 3, hidden: int = 24, depth: int = 3,
                 growth: float = 2.0, max_channels: int = 10_000,
                 num_steps: int = 1000, emb_all_layers: bool = False,
                 cross_attention: bool = False, bilstm: bool = False,
                 transformer: bool = False,
                 codec_dim: tp.Optional[int] = None, kernel: int = 4,
                 stride: int = 2, norm_groups: int = 4, res_blocks: int = 1,
                 dropout: float = 0.0, device=None):
        super().__init__()
        layer = dict(kernel=kernel, stride=stride, norm_groups=norm_groups,
                     res_blocks=res_blocks, dropout=dropout, device=device)
        self.encoders = nn.ModuleList()
        self.decoders = nn.ModuleList()
        self.embedding = nn.Embedding(num_steps, hidden, device=device)
        self.embeddings = nn.ModuleList() if emb_all_layers else None
        for d in range(depth):
            self.encoders.append(EncoderLayer(chin, hidden, **layer))
            self.decoders.insert(0, DecoderLayer(hidden, chin, **layer))
            if emb_all_layers and d > 0:
                self.embeddings.append(nn.Embedding(num_steps, hidden,
                                                    device=device))
            chin = hidden
            hidden = min(int(chin * growth), max_channels)
        self.bilstm = BLSTM(chin, device=device) if bilstm else None
        self.use_transformer = transformer
        self.cross_attention = cross_attention if transformer else False
        if transformer:
            self.transformer = StreamingTransformer(
                chin, 8, 6, bias_ff=False, bias_attn=False,
                cross_attention=self.cross_attention, device=device)
        self.conv_codec = (nn.Conv1d(codec_dim, chin, 1, device=device)
                           if codec_dim is not None else None)

    def forward(self, x: torch.Tensor, step: tp.Union[int, torch.Tensor],
                condition: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        B = x.shape[0]
        if not isinstance(step, torch.Tensor) or step.dim() == 0:
            step = torch.full((B,), int(step), dtype=torch.long,
                              device=x.device)
        skips = []
        z = x
        for idx, encoder in enumerate(self.encoders):
            z = encoder(z)
            if idx == 0:
                z = z + self.embedding(step)[..., None]
            elif self.embeddings is not None:
                z = z + self.embeddings[idx - 1](step)[..., None]
            skips.append(z)

        cross_attention_src = None
        if self.conv_codec is not None:
            assert condition is not None, \
                "Model defined for conditional generation"
            condition_emb = self.conv_codec(condition)
            if not self.cross_attention:
                Tz, Tc = z.shape[-1], condition_emb.shape[-1]
                idx = torch.arange(Tz, device=z.device) * Tc // Tz
                z = z + condition_emb.index_select(-1, idx)
                # upstream adds the condition in place (`z += ...`), which
                # also changes the deepest skip
                skips[-1] = z
            else:
                src = condition_emb.transpose(1, 2)
                positions = torch.arange(src.shape[1], device=x.device)
                cross_attention_src = src + create_sin_embedding(
                    positions.reshape(1, -1, 1), src.shape[-1],
                    max_period=10_000).to(src.dtype)

        if self.use_transformer:
            z = self.transformer(z.transpose(1, 2),
                                 cross_attention_src=cross_attention_src
                                 ).transpose(1, 2)
        elif self.bilstm is not None:
            z = self.bilstm(z)
        else:
            z = torch.zeros_like(z)

        for decoder in self.decoders:
            s = skips.pop(-1)
            z = decoder(z[..., :s.shape[-1]] + s)
        return z[..., :x.shape[-1]]

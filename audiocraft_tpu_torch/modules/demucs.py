"""HTDemucs (hybrid transformer Demucs) stem separation (counterpart of
`audiocraft_tpu/modules/demucs.py`).

The melody conditioner keeps the melodic stems (vocals + other) of its
audio before taking the chroma. The network runs channel-first, as the
demucs package does, and its modules carry that package's names
(`encoder.{i}.conv`, `tencoder.{i}.dconv.layers.{j}.{0,1,3,4,6}`,
`crosstransformer.layers_t.{i}.cross_attn.in_proj_weight`, ...). Two parts
follow the JAX package where it differs from demucs v4's source: the
frequency decoders' rewrite convolution is 3 x 1 (demucs: 3 x 3), and each
transformer layer's `norm_out` is a LayerNorm per step (demucs: one group
norm over all steps and channels); the LayerNorms take flax's epsilon 1e-6.

`apply_demucs` separates in windows of the trained segment with a
triangle-weighted overlap-add at 25 % overlap and no random shift, as the
JAX package does. `get_stem_separator` finds an `htdemucs.th` payload
(`$DEMUCS_CHECKPOINT`, then `$AUDIOCRAFT_CACHE_DIR/htdemucs.th`); without
one, the melody conditioner takes the chroma of the full mix.
"""
import math
import os
import typing as tp
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.audio_utils import convert_audio
from ..ops.stft import hann_window, istft, stft

LN_EPS = 1e-6   # flax LayerNorm's default, as the JAX package's transformer
GN_EPS = 1e-5


def create_sin_embedding(length: int, dim: int, shift: float = 0.0,
                         max_period: float = 10000.0) -> np.ndarray:
    """1-D sinusoid table [length, dim]: the cosine half, then the sine."""
    assert dim % 2 == 0
    pos = shift + np.arange(length, dtype=np.float64)[:, None]
    half = dim // 2
    adim = np.arange(half, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)],
                          axis=-1).astype(np.float32)


def create_2d_sin_embedding(d_model: int, height: int, width: int,
                            max_period: float = 10000.0) -> np.ndarray:
    """2-D sinusoid table [d_model, height, width]: the first half of the
    channels encodes the width (time), the second the height (frequency),
    sine and cosine interleaved."""
    assert d_model % 4 == 0, "d_model must be divisible by 4"
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div_term = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(width, dtype=np.float64)[:, None]
    pos_h = np.arange(height, dtype=np.float64)[:, None]
    pe[0:half:2] = np.sin(pos_w * div_term).T[:, None, :]
    pe[1:half:2] = np.cos(pos_w * div_term).T[:, None, :]
    pe[half::2] = np.sin(pos_h * div_term).T[:, :, None]
    pe[half + 1::2] = np.cos(pos_h * div_term).T[:, :, None]
    return pe


class ScaledEmbedding(nn.Module):
    """An embedding whose output is multiplied by `scale`."""

    def __init__(self, num_embeddings: int, dim: int, scale: float = 10.0):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, dim)
        with torch.no_grad():
            self.embedding.weight.div_(scale)
        self.scale = scale

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding(idx) * self.scale


class LayerScale(nn.Module):
    """Per-channel scale of a residual branch, over channel-first inputs
    [B, C, T] or, with `channel_last`, [B, T, C]."""

    def __init__(self, channels: int, init: float = 1e-4,
                 channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x if self.channel_last else self.scale[:, None] * x


class DConv(nn.Module):
    """Residual branches of dilated convolutions over [B, C, T]: per layer
    j, conv k3 dilation 2^j to C / compress -> GroupNorm(1) -> GELU ->
    conv 1x1 to 2C -> GroupNorm(1) -> GLU -> LayerScale."""

    def __init__(self, channels: int, compress: float = 8, depth: int = 2,
                 init: float = 1e-3):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            dilation = 2 ** d
            self.layers.append(nn.Sequential(
                nn.Conv1d(channels, hidden, 3, dilation=dilation,
                          padding=dilation),
                nn.GroupNorm(1, hidden, eps=GN_EPS), nn.GELU(),
                nn.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels, eps=GN_EPS), nn.GLU(1),
                LayerScale(channels, init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    """Encoder layer: strided conv (along frequency of [B, C, F, T] with
    `freq`, else along time of [B, C, T]) -> GELU -> DConv over time ->
    1x1 rewrite -> GLU."""

    def __init__(self, chin: int, chout: int, freq: bool = True,
                 kernel_size: int = 8, stride: int = 4,
                 dconv_kw: tp.Optional[dict] = None):
        super().__init__()
        self.freq = freq
        self.stride = stride
        pad = kernel_size // 4
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel_size, 1), (stride, 1),
                                  (pad, 0))
            self.rewrite = nn.Conv2d(chout, 2 * chout, 1)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel_size, stride, pad)
            self.rewrite = nn.Conv1d(chout, 2 * chout, 1)
        self.dconv = DConv(chout, **(dconv_kw or {}))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = F.gelu(self.conv(x))
        if self.freq:
            B, C, Fr, T = y.shape
            y = self.dconv(y.permute(0, 2, 1, 3).reshape(B * Fr, C, T))
            y = y.reshape(B, Fr, C, T).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.rewrite(y), dim=1)


class HDecLayer(nn.Module):
    """Decoder layer: add the skip -> rewrite (3 wide) -> GLU -> transposed
    conv, cropped by (kernel - stride) / 2 at both frequency ends or to
    `length` in time -> GELU unless last."""

    def __init__(self, chin: int, chout: int, freq: bool = True,
                 kernel_size: int = 8, stride: int = 4, last: bool = False):
        super().__init__()
        self.freq = freq
        self.last = last
        self.pad = (kernel_size - stride) // 2
        if freq:
            self.rewrite = nn.Conv2d(chin, 2 * chin, (3, 1), padding=(1, 0))
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel_size, 1),
                                              (stride, 1))
        else:
            self.rewrite = nn.Conv1d(chin, 2 * chin, 3, padding=1)
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel_size, stride)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                length: int) -> torch.Tensor:
        y = F.glu(self.rewrite(x + skip), dim=1)
        z = self.conv_tr(y)
        if self.freq:
            z = z[:, :, self.pad:z.shape[2] - self.pad]
        else:
            z = z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


class _TransformerLayer(nn.Module):
    """Pre-norm self- or cross-attention layer over [B, T, C] with a GELU
    feed-forward, LayerScale on both branches and an output LayerNorm."""

    def __init__(self, dim: int, num_heads: int, hidden_scale: float = 4.0,
                 cross: bool = False, layer_scale_init: float = 1e-4):
        super().__init__()
        self.cross = cross
        attn = nn.MultiheadAttention(dim, num_heads, batch_first=True)
        if cross:
            self.cross_attn = attn
            self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        else:
            self.self_attn = attn
        hidden = int(dim * hidden_scale)
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_out = nn.LayerNorm(dim, eps=LN_EPS)
        self.gamma_1 = LayerScale(dim, layer_scale_init, channel_last=True)
        self.gamma_2 = LayerScale(dim, layer_scale_init, channel_last=True)

    def forward(self, x: torch.Tensor,
                kv: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.cross:
            q, k = self.norm1(x), self.norm2(kv)
            att = self.cross_attn(q, k, k, need_weights=False)[0]
            x = x + self.gamma_1(att)
            h = self.norm3(x)
        else:
            q = self.norm1(x)
            x = x + self.gamma_1(self.self_attn(q, q, q, need_weights=False)[0])
            h = self.norm2(x)
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(h))))
        return self.norm_out(x)


class CrossTransformerEncoder(nn.Module):
    """The bottleneck transformer: the frequency branch [B, C, F, T1]
    flattened time-major with a 2-D sin embedding, the time branch
    [B, C, T2] with a 1-D one; even layers self-attend within each branch,
    odd layers cross-attend between them."""

    def __init__(self, dim: int, depth: int = 5, num_heads: int = 8,
                 hidden_scale: float = 4.0, max_period: float = 10000.0,
                 weight_pos_embed: float = 1.0):
        super().__init__()
        self.max_period = max_period
        self.weight_pos_embed = weight_pos_embed
        self.norm_in = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm_in_t = nn.LayerNorm(dim, eps=LN_EPS)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for i in range(depth):
            cross = i % 2 == 1
            self.layers.append(_TransformerLayer(dim, num_heads, hidden_scale,
                                                 cross))
            self.layers_t.append(_TransformerLayer(dim, num_heads,
                                                   hidden_scale, cross))

    def forward(self, x: torch.Tensor, xt: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        B, C, Fr, T1 = x.shape
        T2 = xt.shape[-1]
        pe2d = torch.from_numpy(create_2d_sin_embedding(
            C, Fr, T1, self.max_period).transpose(2, 1, 0).reshape(T1 * Fr, C)
        ).to(x.device, x.dtype)
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        x = self.norm_in(x) + self.weight_pos_embed * pe2d
        pe1d = torch.from_numpy(create_sin_embedding(
            T2, C, max_period=self.max_period)).to(x.device, x.dtype)
        xt = self.norm_in_t(xt.transpose(1, 2)) + self.weight_pos_embed * pe1d
        for i, (layer, layer_t) in enumerate(zip(self.layers, self.layers_t)):
            if i % 2 == 0:
                x, xt = layer(x), layer_t(xt)
            else:
                x, xt = layer(x, xt), layer_t(xt, x)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)


class HTDemucs(nn.Module):
    """Hybrid transformer Demucs in complex-as-channels mode at the
    published `htdemucs` defaults: mix [B, audio_channels, T] at
    `samplerate` -> stems [B, len(sources), audio_channels, T]. Inputs
    shorter than `segment` seconds are zero-padded to it, then cropped."""

    def __init__(self, sources: tp.Sequence[str] = ("drums", "bass", "other",
                                                    "vocals"),
                 audio_channels: int = 2, channels: int = 48, growth: int = 2,
                 depth: int = 4, nfft: int = 4096, kernel_size: int = 8,
                 stride: int = 4, freq_emb_weight: float = 0.2,
                 emb_scale: float = 10.0, dconv_compress: float = 8,
                 dconv_depth: int = 2, dconv_init: float = 1e-3,
                 bottom_channels: int = 512, t_depth: int = 5,
                 t_heads: int = 8, t_hidden_scale: float = 4.0,
                 samplerate: int = 44100, segment: float = 7.8):
        super().__init__()
        self.sources = tuple(sources)
        self.audio_channels = audio_channels
        self.depth = depth
        self.nfft = nfft
        self.hop_length = nfft // 4
        self.freq_emb_weight = freq_emb_weight
        self.bottom_channels = bottom_channels
        self.samplerate = samplerate
        self.segment = segment
        dconv_kw = dict(compress=dconv_compress, depth=dconv_depth,
                        init=dconv_init)
        conv_kw = dict(kernel_size=kernel_size, stride=stride)
        S = len(self.sources)
        self.encoder, self.tencoder = nn.ModuleList(), nn.ModuleList()
        self.decoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chin, chin_z = audio_channels, 2 * audio_channels
        for idx in range(depth):
            chout = channels * growth ** idx
            self.encoder.append(HEncLayer(chin_z, chout, True,
                                          dconv_kw=dconv_kw, **conv_kw))
            self.tencoder.append(HEncLayer(chin, chout, False,
                                           dconv_kw=dconv_kw, **conv_kw))
            chin = chin_z = chout
        for idx in range(depth):
            level = depth - 1 - idx
            last = level == 0
            chin = channels * growth ** level
            chout = S * audio_channels if last else channels * growth ** (level - 1)
            self.decoder.append(HDecLayer(chin, 2 * chout if last else chout,
                                          True, last=last, **conv_kw))
            self.tdecoder.append(HDecLayer(chin, chout, False, last=last,
                                           **conv_kw))
        self.freq_emb = ScaledEmbedding(nfft // 2 // stride, channels,
                                        scale=emb_scale)
        bottom = channels * growth ** (depth - 1)
        if bottom_channels:
            self.channel_upsampler = nn.Conv1d(bottom, bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(bottom_channels, bottom, 1)
            self.channel_upsampler_t = nn.Conv1d(bottom, bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(bottom_channels, bottom, 1)
        self.crosstransformer = CrossTransformerEncoder(
            bottom_channels or bottom, depth=t_depth, num_heads=t_heads,
            hidden_scale=t_hidden_scale)

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> complex [B, C, nfft // 2, ceil(T / hop)]: reflect
        pre-padded by 3 hop / 2, the Nyquist bin and two pre-roll frames
        dropped."""
        hl = self.hop_length
        T = x.shape[-1]
        le = int(math.ceil(T / hl))
        pad = hl // 2 * 3
        x = F.pad(x, (pad, pad + le * hl - T), mode="reflect")
        z = stft(x, self.nfft, hl, window=hann_window(self.nfft, x.dtype,
                                                      x.device),
                 normalized=True, center=True, pad_mode="reflect")
        return z[..., :-1, 2:2 + le]

    def _ispec(self, z: torch.Tensor, length: int) -> torch.Tensor:
        """complex [B, S, C, nfft // 2, frames] -> [B, S, C, length]."""
        hl = self.hop_length
        z = torch.view_as_complex(F.pad(torch.view_as_real(z),
                                        (0, 0, 2, 2, 0, 1)).contiguous())
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        x = istft(z, self.nfft, hl, window=hann_window(self.nfft, z.real.dtype,
                                                       z.device),
                  normalized=True, center=True, length=le)
        return x[..., pad:pad + length]

    @staticmethod
    def _magnitude(z: torch.Tensor) -> torch.Tensor:
        """complex [B, C, F, T] -> [B, 2C, F, T] as c0_re, c0_im, c1_re..."""
        B, C, Fr, T = z.shape
        return torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(
            B, 2 * C, Fr, T)

    @staticmethod
    def _mask(m: torch.Tensor) -> torch.Tensor:
        """[B, S, 2C, F, T] -> complex [B, S, C, F, T]."""
        B, S, C2, Fr, T = m.shape
        out = m.reshape(B, S, C2 // 2, 2, Fr, T).permute(0, 1, 2, 4, 5, 3)
        return torch.view_as_complex(out.contiguous())

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        S = len(self.sources)
        mix = mix.to(self.freq_emb.embedding.weight.dtype)
        B, C_audio, length = mix.shape
        training_length = int(self.segment * self.samplerate)
        length_pre_pad = None
        if length < training_length:
            length_pre_pad = length
            mix = F.pad(mix, (0, training_length - length))
            length = training_length

        z = self._spec(mix)
        mag = self._magnitude(z)
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True)
        x = (mag - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths_t = [], [], []
        for idx in range(self.depth):
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = self.encoder[idx](x)
            if idx == 0:
                frs = torch.arange(x.shape[2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None]
                x = x + self.freq_emb_weight * emb
            saved.append(x)

        b, c, f, t = x.shape
        if self.bottom_channels:
            x = self.channel_upsampler(x.reshape(b, c, f * t)).reshape(
                b, -1, f, t)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            x = self.channel_downsampler(x.reshape(b, -1, f * t)).reshape(
                b, c, f, t)
            xt = self.channel_downsampler_t(xt)

        for idx in range(self.depth):
            x = self.decoder[idx](x, saved.pop(-1), 0)
            xt = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))

        Fq, T = x.shape[-2:]
        x = x.reshape(B, S, C_audio * 2, Fq, T)
        x = x * std[:, None] + mean[:, None]
        wave = self._ispec(self._mask(x), length)
        xt = xt.reshape(B, S, C_audio, length)
        out = wave + xt * stdt[:, None] + meant[:, None]
        if length_pre_pad is not None:
            out = out[..., :length_pre_pad]
        return out


@torch.no_grad()
def apply_demucs(model: HTDemucs, mix: torch.Tensor,
                 overlap: float = 0.25) -> torch.Tensor:
    """Separate mix [B, C, T] at `model.samplerate` in windows of the
    trained segment: each window (the last zero-padded) weighted by a
    triangle, overlap-added, divided by the summed weights. -> stems
    [B, S, C, T] on the model's device."""
    device = next(model.parameters()).device
    mix = torch.as_tensor(mix, dtype=torch.float32).to(device)
    B, C, T = mix.shape
    segment = int(model.samplerate * model.segment)
    stride = int((1 - overlap) * segment)
    weight = torch.cat([torch.arange(1, segment // 2 + 1),
                        torch.arange(segment - segment // 2, 0, -1)]).float()
    weight = (weight / weight.max()).to(device)
    out = torch.zeros(B, len(model.sources), C, T, device=device)
    sum_weight = torch.zeros(T, device=device)
    for start in range(0, max(T - segment, 0) + stride, stride):
        chunk = mix[..., start:start + segment]
        clen = chunk.shape[-1]
        if clen == 0:
            break
        if clen < segment:
            chunk = F.pad(chunk, (0, segment - clen))
        stems = model(chunk)[..., :clen]
        out[..., start:start + clen] += weight[:clen] * stems
        sum_weight[start:start + clen] += weight[:clen]
        if start + segment >= T:
            break
    return out / sum_weight.clamp_min(1e-8)


MELODY_STEMS = ("vocals", "other")


def separate_stems(model: HTDemucs, wav: torch.Tensor, sample_rate: int,
                   names: tp.Sequence[str]) -> torch.Tensor:
    """The sum of the stems `names` of wav [B, C, T] at `sample_rate`:
    converted to the separator's rate and channels, separated, summed, and
    mixed back down to mono at `sample_rate` -> [B, 1, T']."""
    device = next(model.parameters()).device
    x = convert_audio(torch.as_tensor(wav, dtype=torch.float32).to(device),
                      sample_rate, model.samplerate, model.audio_channels)
    stems = apply_demucs(model, x)
    keep = [i for i, s in enumerate(model.sources) if s in names]
    return convert_audio(stems[:, keep].sum(dim=1), model.samplerate,
                         sample_rate, 1)


def separate_melody(model: HTDemucs, wav: torch.Tensor,
                    sample_rate: int) -> torch.Tensor:
    """The melodic stems (vocals + other) of wav [B, C, T], mono at
    `sample_rate` -> [B, 1, T']."""
    return separate_stems(model, wav, sample_rate, MELODY_STEMS)


# --------------------------------------------------------------- checkpoints

def infer_htdemucs_config(state: tp.Mapping[str, tp.Any]) -> dict:
    """The architecture of an htdemucs state dict, read from its shapes."""
    def shape(key):
        return tuple(state[key].shape)

    depth = 1 + max(int(k.split(".")[1]) for k in state
                    if k.startswith("encoder."))
    channels = shape("encoder.0.conv.weight")[0]
    hidden = shape("encoder.0.dconv.layers.0.0.weight")[0]
    stride = 4  # every demucs encoder layer strides by 4
    return dict(
        depth=depth, channels=channels,
        audio_channels=shape("tencoder.0.conv.weight")[1],
        growth=shape("encoder.1.conv.weight")[0] // channels,
        kernel_size=shape("encoder.0.conv.weight")[2], stride=stride,
        dconv_compress=channels // hidden,
        dconv_depth=1 + max(int(k.split(".")[4]) for k in state
                            if k.startswith("encoder.0.dconv.layers.")),
        t_depth=1 + max(int(k.split(".")[2]) for k in state
                        if k.startswith("crosstransformer.layers.")),
        bottom_channels=(shape("channel_upsampler.weight")[0]
                         if "channel_upsampler.weight" in state else 0),
        nfft=shape("freq_emb.embedding.weight")[0] * stride * 2)


# payload kwargs that shapes do not show: head count, feed-forward scale,
# frequency-embedding weight, sources, rate and segment
_PAYLOAD_KWARGS = {"sources": "sources", "samplerate": "samplerate",
                   "segment": "segment", "t_heads": "t_heads",
                   "t_hidden_scale": "t_hidden_scale",
                   "freq_emb": "freq_emb_weight", "emb_scale": "emb_scale"}


def load_htdemucs_from_path(path, device=None) -> HTDemucs:
    """An HTDemucs from a demucs payload (`{'klass', 'args', 'kwargs',
    'state'}`) or a bare state dict, loaded strictly, in eval mode. Read
    with `weights_only=True`: a payload that pickles a class is refused."""
    pkg = torch.load(Path(path), map_location="cpu", weights_only=True)
    kwargs: dict = {}
    if isinstance(pkg, dict) and "state" in pkg:
        kwargs = dict(pkg.get("kwargs") or {})
        state = pkg["state"]
    else:
        state = pkg
    fields = infer_htdemucs_config(state)
    for theirs, ours in _PAYLOAD_KWARGS.items():
        if theirs in kwargs:
            fields[ours] = (tuple(kwargs[theirs]) if theirs == "sources"
                            else kwargs[theirs])
    model = HTDemucs(**fields)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


_SEPARATORS: tp.Dict[tp.Tuple[str, str], HTDemucs] = {}


def get_stem_separator(device=None) -> tp.Optional[HTDemucs]:
    """The HTDemucs of `$DEMUCS_CHECKPOINT`, else of
    `$AUDIOCRAFT_CACHE_DIR/htdemucs.th`, on `device`; None when neither
    exists. Loaded once per path and device."""
    path = os.environ.get("DEMUCS_CHECKPOINT")
    if not path:
        cache = os.environ.get("AUDIOCRAFT_CACHE_DIR")
        if cache and (Path(cache) / "htdemucs.th").exists():
            path = str(Path(cache) / "htdemucs.th")
    if not path or not Path(path).exists():
        return None
    key = (path, str(device))
    if key not in _SEPARATORS:
        _SEPARATORS[key] = load_htdemucs_from_path(path, device)
    return _SEPARATORS[key]

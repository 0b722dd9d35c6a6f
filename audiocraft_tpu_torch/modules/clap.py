"""CLAP, contrastive language-audio pretraining: the HTSAT audio tower, the
RoBERTa text tower and their projections into one joint space, with a
byte-level BPE tokenizer of its own (counterpart of
`audiocraft_tpu/modules/clap.py`).

- The audio tower is HTSAT, a Swin transformer over 48 kHz log-mel
  spectrograms: batch norm over the mel bins (running statistics), the
  mel-to-image fold (time cut into `freq_ratio` chunks stacked along
  frequency, after a bicubic resize of the time axis to the grid), a 4 x 4
  patch embedding, windowed attention with a relative position bias and
  shifted windows (no shift where a stage's grid is no larger than the
  window), patch merging between stages, and the mean over tokens.
- The text tower is a RoBERTa encoder: post-LN layers, position ids offset
  past the padding index, a tanh pooler over the first token.
- Each tower's pooled feature goes through a 2-layer MLP (linear, ReLU,
  linear) and is L2-normalised.

The modules carry the Hugging Face `ClapModel` names (`text_model.*`,
`audio_model.audio_encoder.*`, `text_projection.linear1`, ...), so a
checkpoint in that layout loads with no conversion and `state_dict()`
writes one; the laion_clap layout (`audio_branch.*`, `text_branch.*`, fused
qkv) is re-keyed on load. The architecture is read from the weights' shapes;
the text tower's head count is not in them (default: width / 64). Fusion
variants are not supported.

The tokenizer reads `vocab.json` and `merges.txt` (GPT-2's byte-level BPE
as RoBERTa uses it): GPT-2's pre-tokenising pattern with stdlib classes
(letters `[^\\W\\d_]`, numbers `\\d`, and `_` among the punctuation), then
`<s> ... </s>`, cut to 77 tokens and padded to the longest text.
"""
import json
import logging
import math
import os
import re
import typing as tp
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

logger = logging.getLogger(__name__)

SAMPLE_RATE = 48000
N_FFT = 1024
HOP_LENGTH = 480
MAX_LENGTH_S = 10.0
TEXT_MAX_TOKENS = 77


# ------------------------------------------------------------ preprocessing
def _mel_filter_bank(n_freqs: int, n_mels: int, fmin: float, fmax: float,
                     sample_rate: float, scale: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels]: slaney scale with slaney
    norm (the non-fusion CLAP feature extractor), or htk."""
    from ..ops.stft import mel_filters
    htk = scale == "htk"
    return mel_filters(int(sample_rate), 2 * (n_freqs - 1), n_mels, fmin,
                       fmax, htk=htk, norm=None if htk else "slaney")


def clap_mel(wav: np.ndarray, n_mels: int = 64, fmin: float = 50.0,
             fmax: float = 14000.0) -> np.ndarray:
    """[T] mono 48 kHz waveform -> [frames, n_mels] dB log-mel (power STFT
    with a periodic Hann window, centred reflect padding, slaney mel,
    10 log10), on the host in float64."""
    x = np.asarray(wav, np.float32)
    pad = N_FFT // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP_LENGTH
    idx = (np.arange(N_FFT)[None, :]
           + HOP_LENGTH * np.arange(n_frames)[:, None])
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(N_FFT)
                                 / N_FFT)).astype(np.float64)
    spec = np.abs(np.fft.rfft(x[idx] * window, axis=-1)) ** 2
    mel = spec @ _mel_filter_bank(spec.shape[-1], n_mels, fmin, fmax,
                                  SAMPLE_RATE).astype(np.float64)
    return (10.0 * np.log10(np.maximum(mel, 1e-10))).astype(np.float32)


@lru_cache(maxsize=8)
def _bicubic_time_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] interpolation matrix of torch's bicubic resize with
    align_corners=True (the time axis of HTSAT's mel-to-image fold)."""
    a = -0.75

    def kernel(x):
        x = np.abs(x)
        return np.where(
            x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                     0.0))

    W = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for i in range(n_out):
        src = i * scale
        base = int(np.floor(src))
        for k in range(-1, 3):
            idx = min(max(base + k, 0), n_in - 1)
            W[i, idx] += kernel(src - (base + k))
    return W.astype(np.float32)


@lru_cache(maxsize=8)
def _rel_position_index(ws: int) -> np.ndarray:
    """Swin's relative position index [ws*ws, ws*ws] into the bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + np.array([ws - 1, ws - 1])
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


@lru_cache(maxsize=16)
def _shift_attn_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """[windows, ws*ws, ws*ws] additive mask (0 / -100) of shifted-window
    attention: tokens of different regions of the rolled grid do not
    attend to each other."""
    img = np.zeros((Hp, Wp))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# ------------------------------------------------------------------ config
@dataclass
class CLAPConfig:
    """Widths of the two towers (defaults: HTSAT-base and RoBERTa-base with
    512-wide projections, the released music CLAP)."""
    num_mel_bins: int = 64
    spec_size: int = 256
    freq_ratio: int = 4
    patch_size: int = 4
    patch_embeds_hidden_size: int = 128
    window_size: int = 8
    depths: tp.List[int] = field(default_factory=lambda: [2, 2, 12, 2])
    num_heads: tp.List[int] = field(default_factory=lambda: [4, 8, 16, 32])
    mlp_ratio: int = 4
    vocab_size: int = 50265
    text_hidden_size: int = 768
    text_num_layers: int = 12
    text_num_heads: int = 12
    text_intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    projection_dim: int = 512

    @property
    def audio_hidden_size(self) -> int:
        return self.patch_embeds_hidden_size * 2 ** (len(self.depths) - 1)


# ------------------------------------------------------------------ network
class _Projection(nn.Module):
    def __init__(self, dim: int, out: int, device=None):
        super().__init__()
        self.linear1 = nn.Linear(dim, out, device=device)
        self.linear2 = nn.Linear(out, out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear2(F.relu(self.linear1(x)))
        return out / out.norm(dim=-1, keepdim=True)


class _Dense(nn.Module):
    """`dense` (+ `LayerNorm`): the HF output blocks."""

    def __init__(self, dim: int, out: int, norm_eps: tp.Optional[float] = None,
                 device=None):
        super().__init__()
        self.dense = nn.Linear(dim, out, device=device)
        if norm_eps is not None:
            self.LayerNorm = nn.LayerNorm(out, eps=norm_eps, device=device)


class _QKV(nn.Module):
    def __init__(self, dim: int, window: int = 0, heads: int = 0, device=None):
        super().__init__()
        self.query = nn.Linear(dim, dim, device=device)
        self.key = nn.Linear(dim, dim, device=device)
        self.value = nn.Linear(dim, dim, device=device)
        if window:
            self.relative_position_bias_table = nn.Parameter(
                0.02 * torch.randn((2 * window - 1) ** 2, heads, device=device))


class SwinBlock(nn.Module):
    """One HTSAT layer: (shifted-)window attention with relative position
    bias, then the MLP, each behind a pre-LN residual."""

    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: int,
                 device=None):
        super().__init__()
        self.heads = heads
        self.layernorm_before = nn.LayerNorm(dim, device=device)
        self.attention = nn.ModuleDict({
            "self": _QKV(dim, window, heads, device),
            "output": _Dense(dim, dim, device=device)})
        self.layernorm_after = nn.LayerNorm(dim, device=device)
        self.intermediate = _Dense(dim, mlp_ratio * dim, device=device)
        self.output = _Dense(mlp_ratio * dim, dim, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int, ws: int,
                shift: int) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.attention["self"]
        shortcut = x
        x = self.layernorm_before(x).reshape(B, H, W, C)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        nW = (Hp // ws) * (Wp // ws)
        x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B * nW, ws * ws, C)
        hd = C // self.heads

        def heads(t):
            return t.reshape(-1, ws * ws, self.heads, hd).transpose(1, 2)
        q = heads(qkv.query(x)) / math.sqrt(hd)
        k, v = heads(qkv.key(x)), heads(qkv.value(x))
        attn = q @ k.transpose(-1, -2)                   # [B*nW, nH, N, N]
        index = torch.from_numpy(_rel_position_index(ws).reshape(-1)).to(
            x.device)
        bias = qkv.relative_position_bias_table[index].reshape(
            ws * ws, ws * ws, self.heads).permute(2, 0, 1)
        attn = attn + bias[None]
        if shift > 0:
            mask = torch.from_numpy(_shift_attn_mask(Hp, Wp, ws, shift)).to(
                x.device, attn.dtype)
            attn = attn.reshape(B, nW, self.heads, ws * ws, ws * ws)
            attn = (attn + mask[None, :, None]).reshape(
                B * nW, self.heads, ws * ws, ws * ws)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(-1, ws * ws, C)
        out = self.attention["output"].dense(out)
        out = out.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = shortcut + out[:, :H, :W].reshape(B, N, C)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class PatchMerging(nn.Module):
    """2 x 2 neighbours -> concat (4C, order even-even, odd-even,
    even-odd, odd-odd) -> LayerNorm -> Linear to 2C without bias."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, _, C = x.shape
        x = F.pad(x.reshape(B, H, W, C), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, cfg: CLAPConfig,
                 downsample: bool, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, cfg.window_size, cfg.mlp_ratio, device)
            for _ in range(depth)])
        self.downsample = PatchMerging(dim, device) if downsample else None


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.proj = nn.Conv2d(1, cfg.patch_embeds_hidden_size, cfg.patch_size,
                              stride=cfg.patch_size, device=device)
        self.norm = nn.LayerNorm(cfg.patch_embeds_hidden_size, device=device)


class HTSATEncoder(nn.Module):
    """The audio tower up to its pooled feature: log-mel [B, T, n_mels] ->
    [B, hidden]."""

    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.batch_norm = nn.BatchNorm1d(cfg.num_mel_bins, device=device)
        self.patch_embed = _PatchEmbed(cfg, device)
        dim = cfg.patch_embeds_hidden_size
        self.layers = nn.ModuleList()
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            last = i == len(cfg.depths) - 1
            self.layers.append(_Stage(dim, depth, heads, cfg, not last,
                                      device))
            dim = dim if last else 2 * dim
        self.norm = nn.LayerNorm(dim, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        fr, F_ = cfg.freq_ratio, cfg.num_mel_bins
        spec_width = cfg.spec_size * fr
        B, T, n_mels = mel.shape
        assert n_mels == F_, f"expected {F_} mel bins, got {n_mels}"
        bn = self.batch_norm
        x = ((mel - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5)
             * bn.weight + bn.bias)
        assert T <= spec_width, \
            f"input longer than spec grid ({T} > {spec_width})"
        if T != spec_width:
            resize = torch.from_numpy(_bicubic_time_matrix(T, spec_width)).to(
                x.device, x.dtype)
            x = torch.einsum("ot,btf->bof", resize, x)
        x = x.reshape(B, fr, spec_width // fr, F_).transpose(2, 3)
        x = x.reshape(B, 1, fr * F_, spec_width // fr)
        x = self.patch_embed.proj(x)                      # [B, C, H, W]
        _, C, H, W = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        ws = cfg.window_size
        for stage in self.layers:
            blk_ws, can_shift = ((min(H, W), False) if min(H, W) <= ws
                                 else (ws, True))
            for j, block in enumerate(stage.blocks):
                shift = blk_ws // 2 if (can_shift and j % 2 == 1) else 0
                x = block(x, H, W, blk_ws, shift)
            if stage.downsample is not None:
                x = stage.downsample(x, H, W)
                H, W = (H + 1) // 2, (W + 1) // 2
        return self.norm(x).mean(dim=1)


class _AudioModel(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.audio_encoder = HTSATEncoder(cfg, device)


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        d = cfg.text_hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d,
                                                  device=device)
        self.LayerNorm = nn.LayerNorm(d, eps=1e-12, device=device)


class _TextLayer(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        d, i = cfg.text_hidden_size, cfg.text_intermediate_size
        self.attention = nn.ModuleDict({
            "self": _QKV(d, device=device),
            "output": _Dense(d, d, 1e-12, device)})
        self.intermediate = _Dense(d, i, device=device)
        self.output = _Dense(i, d, 1e-12, device)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList([_TextLayer(cfg, device)
                                    for _ in range(cfg.text_num_layers)])


class RobertaEncoder(nn.Module):
    """The text tower up to its pooled feature: token ids [B, L] and mask
    -> [B, hidden]."""

    def __init__(self, cfg: CLAPConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _TextEmbeddings(cfg, device)
        self.encoder = _TextEncoder(cfg, device)
        self.pooler = _Dense(cfg.text_hidden_size, cfg.text_hidden_size,
                             device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        pad_id = self.cfg.pad_token_id
        emb = self.embeddings
        nonpad = (input_ids != pad_id).long()
        position_ids = nonpad.cumsum(dim=1) * nonpad + pad_id
        x = (emb.word_embeddings(input_ids)
             + emb.position_embeddings(position_ids)
             + emb.token_type_embeddings(torch.zeros_like(input_ids)))
        x = emb.LayerNorm(x)
        n_heads = self.cfg.text_num_heads
        bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * -1e9
        B, L, D = x.shape
        hd = D // n_heads
        for layer in self.encoder.layer:
            qkv = layer.attention["self"]

            def heads(t):
                return t.reshape(B, L, n_heads, hd).transpose(1, 2)
            q, k, v = heads(qkv.query(x)), heads(qkv.key(x)), heads(qkv.value(x))
            attn = (q @ k.transpose(-1, -2) / math.sqrt(hd) + bias).softmax(-1)
            ctx = (attn @ v).transpose(1, 2).reshape(B, L, D)
            out = layer.attention["output"]
            x = out.LayerNorm(x + out.dense(ctx))
            h = F.gelu(layer.intermediate.dense(x))
            x = layer.output.LayerNorm(x + layer.output.dense(h))
        return torch.tanh(self.pooler.dense(x[:, 0]))


class ClapModel(nn.Module):
    """Both towers with their projections (the Hugging Face `ClapModel`'s
    names, without its logit scales)."""

    def __init__(self, cfg: tp.Optional[CLAPConfig] = None, device=None):
        super().__init__()
        cfg = cfg or CLAPConfig()
        self.cfg = cfg
        self.text_model = RobertaEncoder(cfg, device)
        self.text_projection = _Projection(cfg.text_hidden_size,
                                           cfg.projection_dim, device)
        self.audio_model = _AudioModel(cfg, device)
        self.audio_projection = _Projection(cfg.audio_hidden_size,
                                            cfg.projection_dim, device)

    def get_audio_features(self, mel: torch.Tensor) -> torch.Tensor:
        """dB log-mel [B, T, n_mels] -> [B, projection_dim], L2-normalised."""
        return self.audio_projection(self.audio_model.audio_encoder(mel))

    def get_text_features(self, input_ids: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
        """Token ids [B, L] and mask -> [B, projection_dim], L2-normalised."""
        return self.text_projection(self.text_model(input_ids, attention_mask))


# ------------------------------------------------------------ weight loading
_LAION_SWAPS = [
    ("text_branch.", "text_model."),
    ("audio_branch.bn0.", "audio_model.audio_encoder.batch_norm."),
    ("audio_branch.patch_embed.", "audio_model.audio_encoder.patch_embed."),
    ("audio_branch.norm.", "audio_model.audio_encoder.norm."),
    ("audio_branch.layers.", "audio_model.audio_encoder.layers."),
    (".attn.relative_position_bias_table",
     ".attention.self.relative_position_bias_table"),
    (".attn.relative_position_index",
     ".attention.self.relative_position_index"),
    (".attn.proj.", ".attention.output.dense."),
    (".norm1.", ".layernorm_before."),
    (".norm2.", ".layernorm_after."),
    (".mlp.fc1.", ".intermediate.dense."),
    (".mlp.fc2.", ".output.dense."),
    ("text_projection.0.", "text_projection.linear1."),
    ("text_projection.2.", "text_projection.linear2."),
    ("audio_projection.0.", "audio_projection.linear1."),
    ("audio_projection.2.", "audio_projection.linear2."),
]


def _laion_to_hf(src: tp.Dict[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
    """A raw laion_clap state dict in the Hugging Face layout (the renames
    of its conversion script), the fused qkv split."""
    out: tp.Dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(("audio_branch.head", "audio_branch.tscam_conv",
                         "audio_branch.spec", "text_transform")):
            continue  # HTSAT's classification head and unused towers
        for old, new in _LAION_SWAPS:
            k = k.replace(old, new)
        if ".attn.qkv." in k:
            stem, leaf = k.split(".attn.qkv.")
            for name, part in zip(("query", "key", "value"), v.chunk(3, 0)):
                out[f"{stem}.attention.self.{name}.{leaf}"] = part
            continue
        out[k] = v
    return out


def read_clap_state(path: tp.Union[str, Path]) -> tp.Dict[str, torch.Tensor]:
    """The checkpoint's tensors in the Hugging Face layout (f32): `.pt`,
    `.bin` and `.pth` through `torch.load` (a {'state_dict': ...} wrapper
    unwrapped), `.safetensors` through the port's reader, `.npz`."""
    path = Path(path)
    if path.suffix == ".npz":
        src = {k: torch.from_numpy(np.array(v)) for k, v in np.load(path).items()}
    elif path.suffix == ".safetensors":
        from ..utils.safetensors import load_file
        src = load_file(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        src = dict(state)
    src = {k: v.float() if v.is_floating_point() else v
           for k, v in src.items()}
    if any("audio_branch" in k or "text_branch" in k for k in src):
        src = _laion_to_hf(src)
    if not any(k.startswith("audio_model.audio_encoder.") for k in src):
        raise ValueError(f"unrecognized CLAP checkpoint layout: {path}")
    return src


def clap_config_from_state(src: tp.Dict[str, torch.Tensor],
                           text_num_heads: tp.Optional[int] = None
                           ) -> CLAPConfig:
    """The architecture the weights' shapes give (the freq ratio of the
    released HTSAT family, 4, and a grid of 4 x n_mels)."""
    prefix = "audio_model.audio_encoder."

    def count(pattern: str) -> int:
        return 1 + max(int(m.group(1)) for k in src
                       for m in [re.match(pattern, k)] if m)
    n_stages = count(re.escape(prefix) + r"layers\.(\d+)\.")
    depths, heads = [], []
    for i in range(n_stages):
        sp = f"{prefix}layers.{i}."
        depths.append(count(re.escape(sp) + r"blocks\.(\d+)\."))
        table = src[sp + "blocks.0.attention.self.relative_position_bias_table"]
        heads.append(int(table.shape[1]))
    table0 = src[prefix + "layers.0.blocks.0.attention.self."
                 "relative_position_bias_table"]
    pw = src[prefix + "patch_embed.proj.weight"]          # [C, 1, k, k]
    n_mels = int(src[prefix + "batch_norm.weight"].shape[0])
    tp_ = "text_model."
    q0 = src[tp_ + "encoder.layer.0.attention.self.query.weight"]
    d_model = int(q0.shape[0])
    return CLAPConfig(
        num_mel_bins=n_mels, spec_size=4 * n_mels, freq_ratio=4,
        patch_size=int(pw.shape[-1]),
        patch_embeds_hidden_size=int(pw.shape[0]),
        window_size=(int(math.isqrt(int(table0.shape[0]))) + 1) // 2,
        depths=depths, num_heads=heads,
        mlp_ratio=int(src[prefix + "layers.0.blocks.0.intermediate.dense."
                          "weight"].shape[0]) // int(pw.shape[0]),
        vocab_size=int(src[tp_ + "embeddings.word_embeddings.weight"].shape[0]),
        text_hidden_size=d_model,
        text_num_layers=count(re.escape(tp_) + r"encoder\.layer\.(\d+)\."),
        text_num_heads=text_num_heads or max(d_model // 64, 1),
        text_intermediate_size=int(src[tp_ + "encoder.layer.0.intermediate."
                                       "dense.weight"].shape[0]),
        max_position_embeddings=int(
            src[tp_ + "embeddings.position_embeddings.weight"].shape[0]),
        type_vocab_size=int(
            src[tp_ + "embeddings.token_type_embeddings.weight"].shape[0]),
        projection_dim=int(src["text_projection.linear2.weight"].shape[0]))


def load_clap_model(path: tp.Union[str, Path], device=None,
                    text_num_heads: tp.Optional[int] = None) -> ClapModel:
    """A `ClapModel` (evaluation mode, no gradients) with the weights of a
    local checkpoint in the Hugging Face or the laion_clap layout. Every
    weight of the model must be there; other keys (position ids, logit
    scales, HTSAT's head) are ignored."""
    from ..utils.utils import resolve_device
    src = read_clap_state(path)
    model = ClapModel(clap_config_from_state(src, text_num_heads),
                      device="meta")
    own = model.state_dict()
    src.setdefault("audio_model.audio_encoder.batch_norm.num_batches_tracked",
                   torch.zeros((), dtype=torch.long))
    missing = [k for k in own if k not in src]
    if missing:
        raise KeyError(f"CLAP checkpoint {path} lacks {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}")
    model = model.to_empty(device=resolve_device(device))
    model.load_state_dict({k: src[k] for k in own})
    return model.eval().requires_grad_(False)


def find_clap_checkpoint() -> tp.Optional[Path]:
    """A local CLAP checkpoint: $CLAP_CHECKPOINT, then
    AUDIOCRAFT_CACHE_DIR/clap.{pt,pth,bin,safetensors,npz}."""
    from ..utils.utils import find_local_checkpoint
    return find_local_checkpoint(
        "CLAP_CHECKPOINT", ("clap.pt", "clap.pth", "clap.bin",
                            "clap.safetensors", "clap.npz", "clap/clap.pt"))


def _find_tokenizer_dir(ckpt: Path) -> tp.Optional[Path]:
    """The RoBERTa tokenizer files (vocab.json + merges.txt): in
    $CLAP_TOKENIZER, next to the checkpoint, in its `tokenizer/`, or in
    AUDIOCRAFT_CACHE_DIR/roberta."""
    cands = ([Path(os.environ["CLAP_TOKENIZER"])]
             if os.environ.get("CLAP_TOKENIZER") else [])
    cands += [ckpt.parent, ckpt.parent / "tokenizer"]
    if os.environ.get("AUDIOCRAFT_CACHE_DIR"):
        cands.append(Path(os.environ["AUDIOCRAFT_CACHE_DIR"]) / "roberta")
    for d in cands:
        if (d / "vocab.json").exists() and (d / "merges.txt").exists():
            return d
    return None


# ------------------------------------------------------------------ tokenizer
@lru_cache(maxsize=1)
def _bytes_to_unicode() -> tp.Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# GPT-2's pattern with \p{L} as [^\W\d_] and \p{N} as \d
_PRETOKENIZE = re.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+"""
                          r"""| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""")


class RobertaBPETokenizer:
    """RoBERTa's byte-level BPE over `vocab.json` and `merges.txt`:
    `__call__(texts)` -> (input_ids, attention_mask), int64 numpy arrays
    [B, L]: `<s> tokens </s>` cut to `max_length` and padded with `<pad>` to
    the longest row."""

    def __init__(self, vocab_file: tp.Union[str, Path],
                 merges_file: tp.Union[str, Path]):
        self.encoder: tp.Dict[str, int] = json.loads(
            Path(vocab_file).read_text(encoding="utf-8"))
        merges = Path(merges_file).read_text(encoding="utf-8").split("\n")[1:-1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.cache: tp.Dict[str, tp.List[str]] = {}
        self.bos_id = self.encoder.get("<s>")
        self.eos_id = self.encoder.get("</s>")
        self.pad_id = self.encoder.get("<pad>")
        self.unk_id = self.encoder.get("<unk>")

    @classmethod
    def from_dir(cls, path: tp.Union[str, Path]) -> "RobertaBPETokenizer":
        return cls(Path(path) / "vocab.json", Path(path) / "merges.txt")

    def bpe(self, token: str) -> tp.List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, math.inf))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: tp.List[str] = []
            i = 0
            while i < len(word):
                if word[i] == first and i < len(word) - 1 \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return self.cache[token]

    def encode(self, text: str) -> tp.List[int]:
        """The ids of `text`'s BPE tokens, without special tokens."""
        ids = []
        for token in _PRETOKENIZE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.unk_id) for t in self.bpe(token))
        return ids

    def __call__(self, texts: tp.Sequence[str],
                 max_length: int = TEXT_MAX_TOKENS
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
        rows = [[self.bos_id] + self.encode(t)[:max_length - 2] + [self.eos_id]
                for t in texts]
        L = max(len(r) for r in rows)
        ids = np.full((len(rows), L), self.pad_id, np.int64)
        mask = np.zeros((len(rows), L), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask


# ------------------------------------------------------------------ embedder
class CLAPEmbedder:
    """Embeds audio and text into CLAP's joint space on the model's device.

    `embed_audio(wav [B, C, T] or [B, T], sample_rate) -> [B, D]`: each row
    mixed to mono and resampled to 48 kHz (on the CPU, in f32), repeated
    and zero-padded to 10 s when shorter ("repeatpad"), centre-cropped when
    longer, taken to its dB log-mel on the host, then through the audio
    tower. `embed_text(texts) -> [B, D]` through the tokenizer and the text
    tower; without tokenizer files it raises."""

    def __init__(self, model: ClapModel,
                 tokenizer: tp.Optional[RobertaBPETokenizer] = None):
        self.model = model
        self.tokenizer = tokenizer
        cfg = model.cfg
        spec_frames = cfg.spec_size * cfg.freq_ratio
        self.max_samples = min(int(MAX_LENGTH_S * SAMPLE_RATE),
                               (spec_frames - 1) * HOP_LENGTH)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_checkpoint(cls, path: tp.Union[str, Path],
                        device=None) -> "CLAPEmbedder":
        model = load_clap_model(path, device)
        tok_dir = _find_tokenizer_dir(Path(path))
        tokenizer = None
        if tok_dir is not None:
            tokenizer = RobertaBPETokenizer.from_dir(tok_dir)
        else:
            logger.warning("No RoBERTa tokenizer files near %s (need "
                           "vocab.json + merges.txt, or set CLAP_TOKENIZER); "
                           "embed_text disabled.", path)
        return cls(model, tokenizer)

    def mels(self, wav, sample_rate: int) -> np.ndarray:
        """The tower's input [B, frames, n_mels] (host numpy)."""
        from ..ops.resample import resample_frac
        wav = torch.as_tensor(wav, dtype=torch.float32).cpu()
        if wav.dim() == 2:
            wav = wav[:, None]
        max_len = self.max_samples
        mels = []
        for row in wav:
            mono = row.mean(dim=0)
            if sample_rate != SAMPLE_RATE:
                mono = resample_frac(mono, sample_rate, SAMPLE_RATE)
            mono = mono.numpy()
            if len(mono) < max_len:           # laion's "repeatpad"
                mono = np.tile(mono, max(max_len // max(len(mono), 1), 1))
                mono = np.pad(mono, (0, max_len - len(mono)))
            elif len(mono) > max_len:         # the centre crop
                start = (len(mono) - max_len) // 2
                mono = mono[start:start + max_len]
            mels.append(clap_mel(mono, n_mels=self.model.cfg.num_mel_bins))
        return np.stack(mels)

    @torch.no_grad()
    def embed_audio(self, wav, sample_rate: int) -> torch.Tensor:
        mel = torch.from_numpy(self.mels(wav, sample_rate)).to(self.device)
        return self.model.get_audio_features(mel)

    @torch.no_grad()
    def embed_text(self, texts: tp.Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise RuntimeError(
                "CLAP text embedding needs RoBERTa tokenizer files "
                "(vocab.json + merges.txt) next to the checkpoint or in "
                "$CLAP_TOKENIZER.")
        ids, mask = self.tokenizer(list(texts))
        return self.model.get_text_features(
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device))

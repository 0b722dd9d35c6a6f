"""MERT / HuBERT audio encoder (counterpart of
`audiocraft_tpu/modules/mert.py`): the feature extractor of MusicGen-Style's
`mert` path. MERT-v1-95M is a HuBERT-base encoder: a conv feature extractor
(group norm on the first conv only), a grouped conv positional embedding
and post-LN transformer layers, 75 frames per second of 24 kHz audio.

Module names are Hugging Face `HubertModel`'s, so a local
`m-a-p/MERT-v1-95M` snapshot loads by name (`load_mert`: its
`pytorch_model.bin`, or its `model.safetensors` when it has no `.bin`): the
`hubert.` prefix is stripped and the weight-normed positional conv becomes
its effective weight. Nothing is downloaded; `get_mert` finds a checkpoint
at `$MERT_CHECKPOINT` or under `$AUDIOCRAFT_CACHE_DIR/mert`.

Layout: wav [B, T] at `sample_rate` -> [B, frames, hidden].
"""
import math
import os
import typing as tp
from pathlib import Path

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import safetensors


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact (erf) GELU


class ConvLayer(nn.Module):
    """One conv of the feature extractor, with the group norm (one group
    per channel) on the first layer only."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 bias: bool, group_norm: bool, device=None):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias,
                              device=device)
        self.layer_norm = (nn.GroupNorm(c_out, c_out, eps=1e-5, affine=True,
                                        device=device)
                           if group_norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return _gelu(x)


class ConvFeatureExtractor(nn.Module):
    """HuBERT's conv feature encoder: [B, T] -> [B, conv_dim[-1], frames]."""

    def __init__(self, conv_dim: tp.Sequence[int] = (512,) * 7,
                 conv_kernel: tp.Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: tp.Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 conv_bias: bool = False, device=None):
        super().__init__()
        chans = [1] + list(conv_dim)
        self.conv_layers = nn.ModuleList([
            ConvLayer(chans[i], chans[i + 1], k, s, conv_bias, i == 0, device)
            for i, (k, s) in enumerate(zip(conv_kernel, conv_stride))])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class FeatureProjection(nn.Module):
    def __init__(self, c_in: int, hidden: int, eps: float, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_in, eps=eps, device=device)
        self.projection = nn.Linear(c_in, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class ConvPositionalEmbedding(nn.Module):
    """Grouped conv (kernel 128, 16 groups, padding 64), one trailing step
    dropped for an even kernel, GELU. The weight is the effective one of
    the checkpoint's weight norm."""

    def __init__(self, hidden: int = 768, kernel: int = 128, groups: int = 16,
                 device=None):
        super().__init__()
        self.kernel = kernel
        self.conv = nn.Conv1d(hidden, hidden, kernel, padding=kernel // 2,
                              groups=groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.transpose(1, 2))
        if self.kernel % 2 == 0:
            y = y[..., :-1]
        return _gelu(y).transpose(1, 2)


class Attention(nn.Module):
    """Non-causal multi-head self-attention, q scaled after its projection
    (HuBERT's `HubertAttention`)."""

    def __init__(self, hidden: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden, device=device)
        self.k_proj = nn.Linear(hidden, hidden, device=device)
        self.v_proj = nn.Linear(hidden, hidden, device=device)
        self.out_proj = nn.Linear(hidden, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        hd = C // self.heads
        q = (self.q_proj(x) / math.sqrt(hd)).reshape(B, T, self.heads, hd)
        k = self.k_proj(x).reshape(B, T, self.heads, hd)
        v = self.v_proj(x).reshape(B, T, self.heads, hd)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, T, C)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, hidden: int, ffn: int, device=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, ffn, device=device)
        self.output_dense = nn.Linear(ffn, hidden, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(_gelu(self.intermediate_dense(x)))


class PostLNLayer(nn.Module):
    """x = LN(x + attn(x)); x = LN(x + ff(x)) (HuBERT's encoder layer
    without `do_stable_layer_norm`)."""

    def __init__(self, hidden: int, heads: int, ffn: int, eps: float,
                 device=None):
        super().__init__()
        self.attention = Attention(hidden, heads, device)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps, device=device)
        self.feed_forward = FeedForward(hidden, ffn, device)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=eps, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class Encoder(nn.Module):
    def __init__(self, hidden: int, num_layers: int, heads: int, ffn: int,
                 pos_kernel: int, pos_groups: int, eps: float, device=None):
        super().__init__()
        self.pos_conv_embed = ConvPositionalEmbedding(hidden, pos_kernel,
                                                      pos_groups, device)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps, device=device)
        self.layers = nn.ModuleList([PostLNLayer(hidden, heads, ffn, eps,
                                                 device)
                                     for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class MERTModel(nn.Module):
    """HuBERT/MERT encoder returning the last hidden state. Defaults are
    HuBERT-base's (MERT-v1-95M): hidden 768, 12 layers, 12 heads, FFN 3072,
    24 kHz in, 75 Hz out. `layer_norm_eps` is HuBERT's 1e-5; the JAX
    package's encoder normalises with 1e-6 (flax's default), which its
    parity tests pass."""

    def __init__(self, hidden: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate: int = 3072,
                 conv_dim: tp.Sequence[int] = (512,) * 7,
                 conv_kernel: tp.Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: tp.Sequence[int] = (5, 2, 2, 2, 2, 2, 2),
                 conv_bias: bool = False, pos_kernel: int = 128,
                 pos_groups: int = 16, sample_rate: int = 24000,
                 frame_rate: float = 75.0, layer_norm_eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.hidden = hidden
        self.sample_rate = sample_rate
        self.frame_rate = frame_rate
        self.feature_extractor = ConvFeatureExtractor(
            conv_dim, conv_kernel, conv_stride, conv_bias, device)
        self.feature_projection = FeatureProjection(conv_dim[-1], hidden,
                                                    layer_norm_eps, device)
        self.encoder = Encoder(hidden, num_layers, num_heads, intermediate,
                               pos_kernel, pos_groups, layer_norm_eps, device)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, T] at `sample_rate` -> [B, frames, hidden]."""
        feats = self.feature_extractor(wav).transpose(1, 2)
        return self.encoder(self.feature_projection(feats))


# ------------------------------------------------------- checkpoint loading

def _read_state(path: Path) -> tp.Dict[str, torch.Tensor]:
    if path.is_dir():
        if (path / "model.safetensors").exists() and not \
                (path / "pytorch_model.bin").exists():
            path = path / "model.safetensors"
        else:
            found = sorted(path.glob("pytorch_model.bin")) + \
                sorted(path.glob("*.bin")) + sorted(path.glob("*.pt"))
            if not found:
                raise FileNotFoundError(f"no MERT checkpoint under {path}")
            path = found[0]
    if path.suffix == ".safetensors":
        return safetensors.load_file(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    return dict(state)


def convert_hubert_state(state: tp.Dict[str, torch.Tensor]
                         ) -> tp.Dict[str, torch.Tensor]:
    """A Hugging Face Hubert/MERT state dict -> `MERTModel`'s: the `hubert.`
    prefix stripped, the unused `masked_spec_embed` dropped, and the
    weight-normed positional conv turned into its effective weight under
    either naming (`weight_g`/`weight_v`, or
    `parametrizations.weight.original0/1`)."""
    src = {k[len("hubert."):] if k.startswith("hubert.") else k: v.float()
           for k, v in state.items()}
    src.pop("masked_spec_embed", None)
    pc = "encoder.pos_conv_embed.conv."
    if pc + "weight" not in src:
        if pc + "weight_g" in src:
            g, v = src.pop(pc + "weight_g"), src.pop(pc + "weight_v")
        else:
            g = src.pop(pc + "parametrizations.weight.original0")
            v = src.pop(pc + "parametrizations.weight.original1")
        # torch weight norm over dim 2: one norm per kernel tap
        norm = v.square().sum(dim=(0, 1), keepdim=True).sqrt()
        src[pc + "weight"] = g * v / norm.clamp_min(1e-12)
    return src


def load_mert(path, device=None, layer_norm_eps: float = 1e-5) -> MERTModel:
    """A `MERTModel` from a local HF snapshot directory or checkpoint file
    (`pytorch_model.bin`, or `model.safetensors` alone), sized from its
    weights and loaded strictly."""
    src = convert_hubert_state(_read_state(Path(path)))
    n_conv = 1 + max(int(k.split(".")[2]) for k in src
                     if k.startswith("feature_extractor.conv_layers."))
    convs = [src[f"feature_extractor.conv_layers.{i}.conv.weight"]
             for i in range(n_conv)]
    hidden = src["feature_projection.projection.weight"].shape[0]
    pos_w = src["encoder.pos_conv_embed.conv.weight"]
    model = MERTModel(
        hidden=hidden,
        num_layers=1 + max(int(k.split(".")[2]) for k in src
                           if k.startswith("encoder.layers.")),
        num_heads=max(1, hidden // 64),
        intermediate=src["encoder.layers.0.feed_forward.intermediate_dense."
                         "weight"].shape[0],
        conv_dim=tuple(w.shape[0] for w in convs),
        conv_kernel=tuple(w.shape[2] for w in convs),
        conv_stride=(5,) + (2,) * (n_conv - 1),
        conv_bias="feature_extractor.conv_layers.0.conv.bias" in src,
        pos_kernel=pos_w.shape[2], pos_groups=hidden // pos_w.shape[1],
        layer_norm_eps=layer_norm_eps, device=device)
    model.load_state_dict(src, strict=True)
    return model.eval()


_MERT_CACHE: tp.Dict[tp.Tuple[str, str], MERTModel] = {}


def find_mert_checkpoint() -> tp.Optional[Path]:
    """`$MERT_CHECKPOINT`, else `$AUDIOCRAFT_CACHE_DIR/mert`, if it exists."""
    path = os.environ.get("MERT_CHECKPOINT")
    if not path:
        cache = os.environ.get("AUDIOCRAFT_CACHE_DIR")
        path = str(Path(cache) / "mert") if cache else None
    return Path(path) if path and Path(path).exists() else None


def get_mert(device) -> tp.Optional[MERTModel]:
    """The local MERT checkpoint (`find_mert_checkpoint`) on `device`,
    loaded once per (path, device); None when there is none."""
    path = find_mert_checkpoint()
    if path is None:
        return None
    key = (str(path), str(device))
    if key not in _MERT_CACHE:
        _MERT_CACHE[key] = load_mert(path, device=device)
    return _MERT_CACHE[key]

"""T5 encoder for text conditioning (counterpart of
`audiocraft_tpu/modules/t5.py`).

Module attributes follow Hugging Face's `T5EncoderModel` keys (`shared`,
`encoder.block.{i}.layer.0.SelfAttention.q`, `...layer.1.DenseReluDense.wi`,
`encoder.final_layer_norm`), so a local T5 checkpoint loads without a map.
T5 v1.0: RMS norm without bias, attention without 1/sqrt(d) scaling, one
relative-position bias table held by block 0 and shared by all blocks,
ReLU FFN (gated GELU for flan/v1.1). Attention runs in f32.
"""
import dataclasses
import typing as tp

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    gated_ffn: bool = False

    _PRESETS: tp.ClassVar[dict] = {
        "t5-small": dict(d_model=512, d_kv=64, d_ff=2048, num_layers=6, num_heads=8),
        "t5-base": dict(d_model=768, d_kv=64, d_ff=3072, num_layers=12, num_heads=12),
        "t5-large": dict(d_model=1024, d_kv=64, d_ff=4096, num_layers=24, num_heads=16),
        "t5-3b": dict(d_model=1024, d_kv=128, d_ff=16384, num_layers=24, num_heads=32),
        "t5-11b": dict(d_model=1024, d_kv=128, d_ff=65536, num_layers=24, num_heads=128),
        "google/flan-t5-small": dict(d_model=512, d_kv=64, d_ff=1024, num_layers=8,
                                     num_heads=6, gated_ffn=True),
        "google/flan-t5-base": dict(d_model=768, d_kv=64, d_ff=2048, num_layers=12,
                                    num_heads=12, gated_ffn=True),
        "google/flan-t5-large": dict(d_model=1024, d_kv=64, d_ff=2816, num_layers=24,
                                     num_heads=16, gated_ffn=True),
    }

    @classmethod
    def for_model(cls, name: str) -> "T5EncoderConfig":
        if name not in cls._PRESETS:
            raise ValueError(f"Unknown T5 model {name!r}")
        return cls(**cls._PRESETS[name])


class T5LayerNorm(nn.Module):
    """RMS norm without bias or mean-centering, computed in f32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.weight.dtype)


def relative_position_bucket(relative_position: np.ndarray,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """T5 bidirectional relative-position bucketing (host-side numpy)."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool = False,
                 device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, **factory)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, **factory)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **factory)

    def position_bias(self, T: int) -> torch.Tensor:
        """[1, H, T, T] f32 bias from the relative-position table."""
        cfg = self.cfg
        rel_pos = np.arange(T)[None, :] - np.arange(T)[:, None]
        buckets = relative_position_bucket(
            rel_pos, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        table = self.relative_attention_bias.weight
        idx = torch.from_numpy(buckets).to(table.device)
        return table[idx].permute(2, 0, 1)[None].float()

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        split = lambda t: t.reshape(B, T, cfg.num_heads, cfg.d_kv)
        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = logits + position_bias
        logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                    torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
        return self.o(out.reshape(B, T, -1).to(x.dtype))


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self.gated = cfg.gated_ffn
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **factory)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **factory)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return self.wo(h)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg, has_relative_bias, device=None, dtype=None):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, device, dtype)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      device, dtype)


class T5LayerFF(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg, device, dtype)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      device, dtype)


class T5Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_relative_bias: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_relative_bias, device, dtype),
            T5LayerFF(cfg, device, dtype)])

    def forward(self, x, mask, position_bias):
        attn, ff = self.layer
        x = x + attn.SelfAttention(attn.layer_norm(x), mask, position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.block = nn.ModuleList([
            T5Block(cfg, has_relative_bias=(i == 0), device=device, dtype=dtype)
            for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                            device, dtype)


class T5Encoder(nn.Module):
    """T5 encoder stack: tokens [B, T], mask [B, T] -> [B, T, d_model]
    (not masked: callers apply the mask)."""

    def __init__(self, cfg: T5EncoderConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device,
                                   dtype=dtype)
        self.encoder = T5Stack(cfg, device, dtype)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.shared(tokens)
        blocks = self.encoder.block
        position_bias = blocks[0].layer[0].SelfAttention.position_bias(
            tokens.shape[1])
        for block in blocks:
            x = block(x, mask, position_bias)
        return self.encoder.final_layer_norm(x)

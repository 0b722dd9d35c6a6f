"""Streaming transformer with a static KV cache
(counterpart of `audiocraft_tpu/modules/transformer.py`).

Module attributes follow upstream audiocraft's state-dict keys
(`layers.{i}.self_attn.in_proj_weight`, `cross_attention`, `norm_cross`,
`layer_scale_1.scale`, `self_attn.q_layer_norm`, ...).
The KV cache is allocated once at full size and written in place at a
device offset (`KVCache.index`, an int32 tensor), so a decode step never
reads the device on the host and can be captured into a CUDA graph. A
single-step causal self-attention reads the cache through the
decode-attention kernel (`ops/decode_attention.py`), which takes the same
device length and visits only the valid prefix; with GQA (`kv_repeat > 1`)
it takes the masked plain attention, as the JAX package does. A
single-step cross-attention over precomputed K/V (stored once per request
as [B, H, Tc, D]) goes through the cross-attention step kernel
(`ops/cross_attention_step.py`) outside training. Full-sequence
causal self-attention without a cache (training, evaluation) goes through
the flash causal-attention kernel (`ops/flash_causal_attention.py`) under
the JAX package's conditions.

Positions: sinusoidal at the input (`positional_embedding` 'sin'), rotary in
every self-attention ('rope', with xPos decay when `xpos`), or both
('sin_rope'); keys are rotated once, when they are written to the cache.

The hot projections (fused qkv, the q-only and k/v-only slices of
cross-attention, `out_proj`, `linear1`, `linear2`) go through `ops.quant.qdot`,
so a weight replaced by a `QTensor` (W8A8 serving, `models/lm.py::quantize_lm_`)
runs the int8 product and a plain weight keeps F.linear's math.

Training mode (`module.train()`) applies residual dropout and
attention-probs dropout; both are the identity at p = 0. Their masks come
from a generator seeded per layer from `dropout_seed`, so that a layer
recomputed under `checkpointing` draws the same masks.
"""
import dataclasses
import functools
import typing as tp

import torch
import torch.nn as nn
import torch.utils.checkpoint

from ..ops.attention import (dot_product_attention, dropout,
                             flash_causal_eligible, make_causal_bias,
                             repeat_kv)
from ..ops.cross_attention_step import cross_attention_step, eligible_head_dim
from ..ops.decode_attention import decode_attention
from ..ops.flash_causal_attention import flash_causal_attention
from ..ops.quant import div_scalar, qdot
from .activations import get_activation_fn
from .rope import RopeConfig, rope_config, rope_rotate

MAX_PERIOD = 10000.0

_aten = torch.ops.aten
_FLASH_FWD = torch.ops.audiocraft_tpu_torch.flash_causal_fwd.default
# The ops whose outputs selective checkpointing saves, per policy (the JAX
# package's `DOTS_REMAT_POLICY` and `DOTS_NB_REMAT_POLICY`): every matrix
# product a Linear or an einsum dispatches to, or only the unbatched ones,
# and in both the causal flash-attention forward, whose (out, lse) its
# backward needs; recomputing it would run the kernel twice.
SAC_SAVED_OPS = {
    "dots": [_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _FLASH_FWD],
    "dots_nb": [_aten.mm.default, _aten.addmm.default, _FLASH_FWD],
}


def create_sin_embedding(positions: torch.Tensor, dim: int,
                         max_period: float = MAX_PERIOD,
                         dtype=torch.float32) -> torch.Tensor:
    """Sinusoidal positional embedding [B, T, C] from positions [B, T, 1]."""
    assert dim % 2 == 0
    half_dim = dim // 2
    positions = positions.to(dtype)
    adim = torch.arange(half_dim, dtype=dtype,
                        device=positions.device).reshape(1, 1, -1)
    phase = positions / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


@dataclasses.dataclass
class KVCache:
    """Static self-attention cache: buffers [B, S, H, D] and `index`, the
    count of written steps as an int32 tensor [1] on the buffers' device.
    With dtype int8 the buffers hold values quantized symmetrically per
    (step, head) and `k_scale`/`v_scale` [B, S, H] hold the bf16 dequant
    scales."""
    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor
    k_scale: tp.Optional[torch.Tensor] = None
    v_scale: tp.Optional[torch.Tensor] = None

    @classmethod
    def create(cls, batch: int, max_len: int, num_heads: int, head_dim: int,
               dtype=torch.float32, device=None) -> "KVCache":
        shape = (batch, max_len, num_heads, head_dim)
        k = torch.zeros(shape, dtype=dtype, device=device)
        v = torch.zeros(shape, dtype=dtype, device=device)
        index = torch.zeros(1, dtype=torch.int32, device=device)
        if dtype != torch.int8:
            return cls(k, v, index)
        scale_shape = (batch, max_len, num_heads)
        return cls(k, v, index,
                   k_scale=torch.zeros(scale_shape, dtype=torch.bfloat16,
                                       device=device),
                   v_scale=torch.zeros(scale_shape, dtype=torch.bfloat16,
                                       device=device))

    @staticmethod
    def _quantize(x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        # divided by a tensor: the quotient the CPU and the JAX package round
        scale = div_scalar(x.abs().amax(dim=-1, keepdim=True), 127.0)
        # the clamp only matters where rounding in a narrow dtype lands on 128
        q = torch.round(x / scale.clamp_min(1e-8)).clamp_(-127, 127)
        return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)

    def positions(self, steps: int) -> torch.Tensor:
        """The slots [index, index + steps) as an int64 tensor, on the
        device."""
        return self.index + torch.arange(steps, device=self.k.device)

    def write(self, k: torch.Tensor, v: torch.Tensor,
              positions: tp.Optional[torch.Tensor] = None) -> None:
        """Write a [B, T, H, D] chunk in place at the slots `positions` [T]
        (default: the T slots from `index`), quantizing if int8, and advance
        `index` by T. Every step is a device op: nothing waits for the
        device."""
        T = k.shape[1]
        if positions is None:
            positions = self.positions(T)
        if self.k.dtype == torch.int8:
            k_q, k_s = self._quantize(k)
            v_q, v_s = self._quantize(v)
            self.k.index_copy_(1, positions, k_q)
            self.v.index_copy_(1, positions, v_q)
            self.k_scale.index_copy_(1, positions, k_s)
            self.v_scale.index_copy_(1, positions, v_s)
        else:
            self.k.index_copy_(1, positions, k.to(self.k.dtype))
            self.v.index_copy_(1, positions, v.to(self.v.dtype))
        self.index.add_(T)

    def read(self, dtype) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Full dequantized buffers in `dtype` (dequantized in `dtype`)."""
        if self.k.dtype == torch.int8:
            return (self.k.to(dtype) * self.k_scale[..., None].to(dtype),
                    self.v.to(dtype) * self.v_scale[..., None].to(dtype))
        return self.k.to(dtype), self.v.to(dtype)


class LayerScale(nn.Module):
    """Diagonal rescaling of a residual branch: x * scale, with `scale`
    [channels] initialised to `init` (the JAX package's `LayerScale`)."""

    def __init__(self, channels: int, init: float = 1e-4, device=None,
                 dtype=None):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), init, device=device,
                                             dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class QLinear(nn.Linear):
    """`nn.Linear` whose weight may be replaced by a `QTensor` (counterpart
    of the JAX package's `QDense`); a plain weight keeps nn.Linear's math."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qdot(x, self.weight, self.bias)


@dataclasses.dataclass
class LayerCache:
    """Per-layer state: self-attention KV cache + precomputed cross K/V."""
    self_attn: KVCache
    cross_k: tp.Optional[torch.Tensor] = None  # [B, H, Tc, D], contiguous
    cross_v: tp.Optional[torch.Tensor] = None


class StreamingMultiheadAttention(nn.Module):
    """Multi-head attention with a fused qkv projection (torch layout
    `in_proj_weight` [E + 2 E / kv_repeat, E]), causal masking with an
    optional finite `past_context`, GQA (`kv_repeat` query heads per key and
    value head), optional layer norms of q and k over the embedding
    (`qk_layer_norm`), rotary positions (`rope`), cross-attention over
    precomputed K/V, a static cache, and attention-probs dropout `dropout`
    in training mode."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 causal: bool = False, past_context: tp.Optional[int] = None,
                 cross_attention: bool = False, dropout: float = 0.0,
                 attention_as_float32: bool = False,
                 rope: tp.Optional[RopeConfig] = None,
                 qk_layer_norm: bool = False, kv_repeat: int = 1,
                 device=None, dtype=None):
        super().__init__()
        assert embed_dim % num_heads == 0
        assert num_heads % kv_repeat == 0
        if cross_attention:
            assert not causal, "Causal cannot work with cross attention."
            assert rope is None, "Rope cannot work with cross attention."
            assert kv_repeat == 1
        if qk_layer_norm:
            assert kv_repeat == 1
        factory = dict(device=device, dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_heads // kv_repeat
        self.kv_repeat = kv_repeat
        self.causal = causal
        self.past_context = past_context
        self.cross_attention = cross_attention
        self.dropout = dropout
        self.attention_as_float32 = attention_as_float32
        self.rope = rope
        kv_dim = self.num_kv_heads * (embed_dim // num_heads)
        self.in_proj_weight = nn.Parameter(
            torch.empty(embed_dim + 2 * kv_dim, embed_dim, **factory))
        if bias:
            self.in_proj_bias = nn.Parameter(torch.zeros(embed_dim + 2 * kv_dim,
                                                         **factory))
        else:
            self.register_parameter("in_proj_bias", None)
        self.out_proj = QLinear(embed_dim, embed_dim, bias=bias, **factory)
        self.qk_layer_norm = qk_layer_norm
        if qk_layer_norm:
            self.q_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5, **factory)
            self.k_layer_norm = nn.LayerNorm(embed_dim, eps=1e-5, **factory)
        bound = 1.0 / embed_dim ** 0.5
        nn.init.uniform_(self.in_proj_weight, -bound, bound)

    @staticmethod
    def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
        B, T, _ = x.shape
        return x.reshape(B, T, heads, -1)

    def project_kv(self, src: torch.Tensor
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """Keys/values only, [B, Tk, H, D] each (cross-attention precompute)."""
        E = self.embed_dim
        bias = None if self.in_proj_bias is None else self.in_proj_bias[E:]
        kv = qdot(src.to(self.in_proj_weight.dtype), self.in_proj_weight[E:],
                  bias)
        k, v = kv.chunk(2, dim=-1)
        if self.qk_layer_norm:
            k = self.k_layer_norm(k)
        return (self._split_heads(k, self.num_kv_heads),
                self._split_heads(v, self.num_kv_heads))

    def forward(self, query: torch.Tensor,
                key: tp.Optional[torch.Tensor] = None, *,
                cache: tp.Optional[KVCache] = None,
                cross_kv: tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor]] = None,
                positions: tp.Optional[torch.Tensor] = None,
                attn_bias: tp.Optional[torch.Tensor] = None,
                generator: tp.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """query [B, T, E] -> [B, T, E]. Self-attention writes `cache` in
        place at `positions` (an int64 tensor [T]; default: the cache's
        next T slots) and advances its index, and adds `attn_bias` (f32,
        broadcasting against [B, H, T, Tk]) to its logits: a biased
        self-attention takes the plain attention, as in the JAX package;
        cross-attention attends `cross_kv` (or projects `key`)."""
        B, T, E = query.shape
        dtype = self.in_proj_weight.dtype
        query = query.to(dtype)
        attn = dict(as_float32=self.attention_as_float32,
                    dropout_rate=self.dropout if self.training else 0.0,
                    generator=generator)

        if self.cross_attention:
            bias = None if self.in_proj_bias is None else self.in_proj_bias[:E]
            q = qdot(query, self.in_proj_weight[:E], bias)
            if self.qk_layer_norm:
                q = self.q_layer_norm(q)
            q = self._split_heads(q, self.num_heads)
            # no mask: the null condition of CFG is zeros of length 1
            if (cross_kv is not None and T == 1 and not self.training
                    and eligible_head_dim(E // self.num_heads)
                    and q.dtype == cross_kv[0].dtype):
                # a decode step over the request's constant text keys and
                # values, stored [B, H, Tc, D] by `precompute_cross_kv`
                x = cross_attention_step(q[:, 0].contiguous(), *cross_kv)
                return self.out_proj(x.reshape(B, T, E))
            if cross_kv is not None:
                k, v = (t.transpose(1, 2) for t in cross_kv)
            else:
                k, v = self.project_kv(key)
            x = dot_product_attention(q, k, v, **attn)
            return self.out_proj(x.reshape(B, T, E))

        projected = qdot(query, self.in_proj_weight, self.in_proj_bias)
        kv_dim = (projected.shape[-1] - E) // 2
        q, k, v = projected.split([E, kv_dim, kv_dim], dim=-1)
        if self.qk_layer_norm:
            q, k = self.q_layer_norm(q), self.k_layer_norm(k)
        q = self._split_heads(q, self.num_heads)
        k = self._split_heads(k, self.num_kv_heads)
        v = self._split_heads(v, self.num_kv_heads)
        if cache is None:
            if self.rope is not None:
                pos = torch.arange(T, device=query.device)
                q = rope_rotate(self.rope, q, pos)
                k = rope_rotate(self.rope, k, pos, invert_decay=True)
            if (self.causal and self.past_context is None
                    and attn_bias is None
                    and not self.attention_as_float32
                    and attn["dropout_rate"] <= 0.0
                    and flash_causal_eligible(T, T, E // self.num_heads)):
                # q, k, v go in as strided views of `projected`
                x = flash_causal_attention(q, repeat_kv(k, self.kv_repeat),
                                           repeat_kv(v, self.kv_repeat))
                return self.out_proj(x.reshape(B, T, E))
            bias = None
            if self.causal:
                pos = torch.arange(T, device=query.device)
                bias = make_causal_bias(pos, pos, self.past_context)
            k_all, v_all = k, v
        else:
            assert self.causal, "a KV cache needs causal self-attention"
            if positions is None:
                positions = cache.positions(T)
            if self.rope is not None:
                q = rope_rotate(self.rope, q, positions)
                k = rope_rotate(self.rope, k, positions, invert_decay=True)
            cache.write(k, v, positions)
            if T == 1 and self.kv_repeat == 1 and attn_bias is None:
                k_c, v_c = cache.k, cache.v
                if k_c.dtype not in (torch.int8, dtype):
                    k_c, v_c = k_c.to(dtype), v_c.to(dtype)
                # the length is the cache's device index, after the write
                x = decode_attention(q[:, 0].contiguous(), k_c, v_c,
                                     cache.index,
                                     past_context=self.past_context,
                                     k_scale=cache.k_scale,
                                     v_scale=cache.v_scale)
                return self.out_proj(x.reshape(B, T, E))
            k_pos = torch.arange(cache.k.shape[1], device=query.device)
            bias = make_causal_bias(positions, k_pos, self.past_context,
                                    k_valid=k_pos < cache.index)
            k_all, v_all = cache.read(dtype)
        if attn_bias is not None:
            bias = attn_bias if bias is None else bias + attn_bias
        x = dot_product_attention(q, repeat_kv(k_all, self.kv_repeat),
                                  repeat_kv(v_all, self.kv_repeat), bias=bias,
                                  **attn)
        return self.out_proj(x.reshape(B, T, E))


class StreamingTransformerLayer(nn.Module):
    """Pre- or post-norm layer: self-attention, optional cross-attention, FFN,
    with residual dropout `dropout` (after each block and inside the FFN),
    attention-probs dropout `attention_dropout` (default: `dropout`), and
    with `layer_scale` each residual branch rescaled by a `LayerScale`."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.0,
                 attention_dropout: tp.Optional[float] = None,
                 bias_ff: bool = True, bias_attn: bool = True,
                 causal: bool = False, past_context: tp.Optional[int] = None,
                 attention_as_float32: bool = False,
                 qk_layer_norm: bool = False, qk_layer_norm_cross: bool = False,
                 cross_attention: bool = False,
                 layer_scale: tp.Optional[float] = None,
                 rope: tp.Optional[RopeConfig] = None, kv_repeat: int = 1,
                 norm_first: bool = True,
                 activation: str = "gelu", device=None, dtype=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        common = dict(embed_dim=d_model, num_heads=num_heads, bias=bias_attn,
                      dropout=dropout if attention_dropout is None
                      else attention_dropout,
                      attention_as_float32=attention_as_float32, **factory)
        self.self_attn = StreamingMultiheadAttention(
            causal=causal, past_context=past_context, rope=rope,
            qk_layer_norm=qk_layer_norm, kv_repeat=kv_repeat, **common)
        self.linear1 = QLinear(d_model, dim_feedforward, bias=bias_ff,
                               **factory)
        self.linear2 = QLinear(dim_feedforward, d_model, bias=bias_ff,
                               **factory)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, **factory)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, **factory)
        self.layer_scale_1 = self.layer_scale_2 = nn.Identity()
        if layer_scale is not None:
            self.layer_scale_1 = LayerScale(d_model, layer_scale, **factory)
            self.layer_scale_2 = LayerScale(d_model, layer_scale, **factory)
        self.cross_attention: tp.Optional[StreamingMultiheadAttention] = None
        if cross_attention:
            self.cross_attention = StreamingMultiheadAttention(
                cross_attention=True, qk_layer_norm=qk_layer_norm_cross,
                **common)
            self.norm_cross = nn.LayerNorm(d_model, eps=1e-5, **factory)
            self.layer_scale_cross = (
                nn.Identity() if layer_scale is None
                else LayerScale(d_model, layer_scale, **factory))
        self.norm_first = norm_first
        self.activation = get_activation_fn(activation)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, *,
                cross_attention_src: tp.Optional[torch.Tensor] = None,
                cache: tp.Optional[LayerCache] = None,
                positions: tp.Optional[torch.Tensor] = None,
                attn_bias: tp.Optional[torch.Tensor] = None,
                dropout_seed: tp.Optional[int] = None) -> torch.Tensor:
        """`positions` [T] are the cache slots of x's steps (with `cache`);
        `attn_bias` is added to the self-attention's logits;
        `dropout_seed` seeds this layer's dropout masks in training mode
        (the default generator draws them when it is None)."""
        generator = None
        p = self.dropout if self.training else 0.0
        if dropout_seed is not None and self.training and (
                p > 0.0 or self.self_attn.dropout > 0.0):
            generator = torch.Generator(x.device).manual_seed(dropout_seed)

        def drop(y):
            return dropout(y, p, generator)

        def ff_block(h):
            return self.layer_scale_2(
                drop(self.linear2(drop(self.activation(self.linear1(h))))))

        self_cache = cache.self_attn if cache is not None else None
        cross_kv = None
        if cache is not None and cache.cross_k is not None:
            cross_kv = (cache.cross_k, cache.cross_v)
        has_cross = cross_attention_src is not None or cross_kv is not None
        assert has_cross == (self.cross_attention is not None)

        def self_attn(h):
            return self.layer_scale_1(drop(self.self_attn(
                h, cache=self_cache, positions=positions,
                attn_bias=attn_bias, generator=generator)))

        def cross(h):
            return self.layer_scale_cross(drop(self.cross_attention(
                h, cross_attention_src, cross_kv=cross_kv,
                generator=generator)))

        x = x.to(self.norm1.weight.dtype)
        if self.norm_first:
            x = x + self_attn(self.norm1(x))
            if has_cross:
                x = x + cross(self.norm_cross(x))
            return x + ff_block(self.norm2(x))
        x = self.norm1(x + self_attn(x))
        if has_cross:
            x = self.norm_cross(x + cross(x))
        return self.norm2(x + ff_block(x))


class StreamingTransformer(nn.Module):
    """Stack of layers with sinusoidal positions added at the input
    (`positional_embedding` 'sin' or 'sin_rope', scaled by
    `positional_scale`) and/or rotary positions in every self-attention
    ('rope' or 'sin_rope', with xPos decay when `xpos`).

    `checkpointing='torch'` recomputes each layer in the backward
    (`torch.utils.checkpoint`, non-reentrant), saving only the layer inputs,
    as the JAX package's `jax.checkpoint` of each layer does. 'dots' and
    'dots_nb' checkpoint each layer selectively (`SAC_SAVED_OPS`): the
    outputs of its matrix products and of the causal flash-attention
    forward are saved, everything else (norms, activations, casts, softmax,
    dropout) is recomputed; 'dots_nb' saves only the unbatched products
    (the projections and the feed-forward), so the batched products of the
    plain and cross attention are recomputed too, as the JAX package's
    `DOTS_NB_REMAT_POLICY`."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, dropout: float = 0.0,
                 attention_dropout: tp.Optional[float] = None,
                 bias_ff: bool = True, bias_attn: bool = True,
                 causal: bool = False, past_context: tp.Optional[int] = None,
                 attention_as_float32: bool = False,
                 cross_attention: bool = False,
                 layer_scale: tp.Optional[float] = None,
                 positional_embedding: str = "sin",
                 max_period: float = MAX_PERIOD, positional_scale: float = 1.0,
                 xpos: bool = False, qk_layer_norm: bool = False,
                 qk_layer_norm_cross: bool = False, kv_repeat: int = 1,
                 norm_first: bool = True,
                 activation: str = "gelu", checkpointing: str = "none",
                 device=None, dtype=None):
        super().__init__()
        assert d_model % num_heads == 0
        if checkpointing not in ("none", "torch", *SAC_SAVED_OPS):
            raise ValueError(f"unknown checkpointing {checkpointing!r}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.kv_repeat = kv_repeat
        self.checkpointing = checkpointing
        self.positional_embedding = positional_embedding
        self.max_period = max_period
        self.positional_scale = positional_scale
        rope = rope_config(positional_embedding, d_model // num_heads,
                           max_period, xpos, positional_scale)
        self.layers = nn.ModuleList([
            StreamingTransformerLayer(
                d_model, num_heads, dim_feedforward, dropout=dropout,
                attention_dropout=attention_dropout, bias_ff=bias_ff,
                bias_attn=bias_attn, causal=causal, past_context=past_context,
                attention_as_float32=attention_as_float32,
                qk_layer_norm=qk_layer_norm,
                qk_layer_norm_cross=qk_layer_norm_cross,
                cross_attention=cross_attention, layer_scale=layer_scale,
                rope=rope, kv_repeat=kv_repeat, norm_first=norm_first,
                activation=activation, device=device, dtype=dtype)
            for _ in range(num_layers)])

    def init_cache(self, batch: int, max_len: int, dtype=None,
                   device=None) -> tp.List[LayerCache]:
        """Fresh empty caches for all layers, allocated once at `max_len`
        (each with its own device index)."""
        p = self.layers[0].norm1.weight
        dtype = dtype or p.dtype
        device = device or p.device
        head_dim = self.d_model // self.num_heads
        return [LayerCache(KVCache.create(batch, max_len,
                                          self.num_heads // self.kv_repeat,
                                          head_dim, dtype, device))
                for _ in self.layers]

    def precompute_cross_kv(self, src: torch.Tensor,
                            caches: tp.List[LayerCache]) -> None:
        """Fill each layer cache with its projected cross-attention K/V,
        each stored contiguous as [B, H, Tc, D] (the layout that the decode
        step's `cross_attention_step` reads)."""
        for layer, cache in zip(self.layers, caches):
            cache.cross_k, cache.cross_v = (
                t.transpose(1, 2).contiguous()
                for t in layer.cross_attention.project_kv(src))

    def forward(self, x: torch.Tensor, *,
                cross_attention_src: tp.Optional[torch.Tensor] = None,
                caches: tp.Optional[tp.List[LayerCache]] = None,
                attn_bias: tp.Optional[torch.Tensor] = None,
                dropout_seed: tp.Optional[int] = None) -> torch.Tensor:
        """Layer i seeds its dropout masks with `dropout_seed + i`. With
        `caches`, x's steps take the cache slots from its device index.
        `attn_bias` reaches every self-attention."""
        B, T, C = x.shape
        x = x.to(self.layers[0].norm1.weight.dtype)
        positions = None
        if caches is not None:
            positions = caches[0].self_attn.positions(T)
        if self.positional_embedding in ("sin", "sin_rope"):
            pos = (positions if positions is not None
                   else torch.arange(T, device=x.device))
            emb = create_sin_embedding(pos.reshape(1, -1, 1), C,
                                       max_period=self.max_period).to(x.dtype)
            if self.positional_scale != 1.0:
                emb = self.positional_scale * emb
            x = x + emb
        remat = (self.checkpointing != "none" and caches is None
                 and torch.is_grad_enabled())
        context_fn = torch.utils.checkpoint.noop_context_fn
        if self.checkpointing in SAC_SAVED_OPS:
            context_fn = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts,
                SAC_SAVED_OPS[self.checkpointing])
        for i, layer in enumerate(self.layers):
            seed = None if dropout_seed is None else dropout_seed + i
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._layer_call, layer, x, cross_attention_src,
                    attn_bias, seed, use_reentrant=False,
                    context_fn=context_fn)
            else:
                x = layer(x, cross_attention_src=cross_attention_src,
                          cache=caches[i] if caches is not None else None,
                          positions=positions, attn_bias=attn_bias,
                          dropout_seed=seed)
        return x

    @staticmethod
    def _layer_call(layer: StreamingTransformerLayer, x: torch.Tensor,
                    cross_attention_src: tp.Optional[torch.Tensor],
                    attn_bias: tp.Optional[torch.Tensor],
                    seed: tp.Optional[int]) -> torch.Tensor:
        return layer(x, cross_attention_src=cross_attention_src,
                     attn_bias=attn_bias, dropout_seed=seed)

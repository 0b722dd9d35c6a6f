"""Transformer with U-Net skip connections, JASCO's backbone (counterpart of
`audiocraft_tpu/modules/unet_transformer.py`): the outputs of the first
half's layers are concatenated to the inputs of the mirrored second-half
layers and projected back to `d_model` (`skip_projections.{i}`). Layer
dropout of the skips is training only and is not ported."""
import typing as tp

import torch
import torch.nn as nn

from .transformer import StreamingTransformer, create_sin_embedding


class UnetTransformer(StreamingTransformer):

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 skip_connections: bool = False, device=None, dtype=None,
                 **kwargs):
        super().__init__(d_model, num_heads, num_layers, device=device,
                         dtype=dtype, **kwargs)
        self.skip_connections = skip_connections
        if skip_connections:
            self.skip_projections = nn.ModuleList([
                nn.Linear(2 * d_model, d_model, device=device, dtype=dtype)
                for _ in range(num_layers // 2)])

    def forward(self, x: torch.Tensor, *,
                cross_attention_src: tp.Optional[torch.Tensor] = None,
                attn_bias: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        x = x.to(self.layers[0].norm1.weight.dtype)
        if self.positional_embedding in ("sin", "sin_rope"):
            positions = torch.arange(T, device=x.device).reshape(1, -1, 1)
            emb = create_sin_embedding(positions, C,
                                       max_period=self.max_period).to(x.dtype)
            x = x + self.positional_scale * emb
        half = len(self.layers) // 2
        skips: tp.List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            if self.skip_connections and i >= half:
                x = torch.cat([x, skips.pop()], dim=-1)
                x = self.skip_projections[i % len(self.skip_projections)](x)
            x = layer(x, cross_attention_src=cross_attention_src,
                      attn_bias=attn_bias)
            if self.skip_connections and i < half:
                skips.append(x)
        return x

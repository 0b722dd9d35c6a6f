"""Residual vector quantization for inference (counterpart of
`audiocraft_tpu/quantization/core_vq.py`: nearest-code search, residual
encode, `rvq_decode`).

Codebook state lives in buffers named as upstream audiocraft's EMA codebooks
(`layers.{q}._codebook.embed`, `embed_avg`, `cluster_size`, `inited`); the
EMA training updates are not ported.
"""
import typing as tp

import torch
import torch.nn as nn


def quantize_codes(embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest code indices for x [..., D] against embed [C, D]; the |x|^2
    term is constant in the argmin and dropped."""
    flat = x.reshape(-1, x.shape[-1])
    dists = flat @ embed.t().to(flat.dtype) * 2 - embed.square().sum(-1).to(flat.dtype)
    return dists.argmax(dim=-1).reshape(x.shape[:-1])


def rvq_decode(embeds: tp.Sequence[torch.Tensor], codes: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """codes [B, K, T] -> sum over levels of embeds[k][codes[:, k]], [B, T, D]."""
    B, K, T = codes.shape
    out = torch.zeros(B, T, embeds[0].shape[-1], dtype=dtype,
                      device=codes.device)
    for k in range(K):
        out = out + embeds[k].to(dtype)[codes[:, k]]
    return out


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.register_buffer("inited", torch.ones(1, device=device))
        self.register_buffer("cluster_size",
                             torch.zeros(codebook_size, device=device))
        self.register_buffer("embed", torch.zeros(codebook_size, dim,
                                                  device=device))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim,
                                                      device=device))


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size, device)


class ResidualVectorQuantization(nn.Module):
    """Cascade of `num_quantizers` codebooks over residuals."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int,
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList([
            VectorQuantization(dim, codebook_size, device)
            for _ in range(num_quantizers)])

    def embeds(self, n_q: int) -> tp.List[torch.Tensor]:
        return [layer._codebook.embed for layer in self.layers[:n_q]]

    def encode(self, x: torch.Tensor, n_q: int) -> torch.Tensor:
        """x [B, T, D] -> codes [B, K, T]."""
        residual = x
        codes = []
        for embed in self.embeds(n_q):
            embed = embed.to(x.dtype)
            c = quantize_codes(embed, residual)
            residual = residual - embed[c]
            codes.append(c)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """codes [B, K, T] -> [B, T, D]."""
        return rvq_decode(self.embeds(codes.shape[1]), codes, dtype)

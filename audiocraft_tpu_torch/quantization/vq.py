"""Residual vector quantizer (counterpart of `audiocraft_tpu/quantization/vq.py`)
for inference. Channels-first like the rest of the port: latents [B, D, T],
codes [B, K, T]."""
import torch
import torch.nn as nn

from .core_vq import ResidualVectorQuantization


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024,
                 device=None):
        super().__init__()
        self.dimension = dimension
        self.n_q = n_q
        self.bins = bins
        self.vq = ResidualVectorQuantization(n_q, dimension, bins, device)

    @property
    def total_codebooks(self) -> int:
        return len(self.vq.layers)

    @property
    def num_codebooks(self) -> int:
        return self.n_q

    def set_num_codebooks(self, n: int) -> None:
        """Use the first `n` codebooks (1 <= n <= total_codebooks)."""
        assert 0 < n <= self.total_codebooks
        self.n_q = n

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, T] -> codes [B, K, T] with K = the active n_q."""
        return self.vq.encode(x.transpose(1, 2), self.n_q)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """codes [B, K, T] -> [B, D, T]."""
        return self.vq.decode(codes, dtype).transpose(1, 2)

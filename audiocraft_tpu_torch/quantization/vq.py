"""Residual vector quantizer (counterpart of `audiocraft_tpu/quantization/vq.py`).
Channels-first like the rest of the port: latents [B, D, T], codes [B, K, T].

`forward` is the training forward: the residual cascade with its
commitment penalty, EMA codebook updates in training mode, and quantizer
dropout (`q_dropout`: in training, a random number of levels in [1, n_q],
drawn from the caller's generator unless `n_q` is given). The same
generator draws k-means' initial means and the dead codes' replacements.

`kmeans_iters` and the orthogonal regularisation settings are accepted and
not used, as in the JAX package: its k-means always runs 10 iterations, and
it never applies `orthogonal_reg_weight` (ROADMAP §3; every shipped config
sets the weight to 0).
"""
import math
import typing as tp

import torch

from .base import BaseQuantizer, QuantizedResult
from .core_vq import ResidualVectorQuantization

__all__ = ["QuantizedResult", "ResidualVectorQuantizer"]


class ResidualVectorQuantizer(BaseQuantizer):
    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024,
                 q_dropout: bool = False, decay: float = 0.99,
                 threshold_ema_dead_code: float = 2.0, device=None,
                 kmeans_init: bool = False, kmeans_iters: int = 10,
                 orthogonal_reg_weight: float = 0.0,
                 orthogonal_reg_active_codes_only: bool = False,
                 orthogonal_reg_max_codes: tp.Optional[int] = None):
        super().__init__()
        self.dimension = dimension
        self.n_q = n_q
        self.bins = bins
        self.q_dropout = q_dropout
        self.decay = decay
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.kmeans_init = kmeans_init
        self.vq = ResidualVectorQuantization(n_q, dimension, bins, device,
                                             kmeans_init)

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

    def forward(self, x: torch.Tensor, frame_rate: int,
                n_q: tp.Optional[int] = None,
                generator: tp.Optional[torch.Generator] = None,
                mesh=None) -> QuantizedResult:
        """x [B, D, T] through the first `n_q` levels (default: `self.n_q`,
        or with `q_dropout` in training mode a draw from `generator`); in
        training mode the active codebooks take their EMA step (over the
        data ranks of `mesh`, whose slices x is one of)."""
        if n_q is None:
            n_q = self.n_q
            if self.training and self.q_dropout:
                n_q = int(torch.randint(1, self.n_q + 1, (1,),
                                        generator=generator))
        quantized, codes, commits = self.vq(
            x.transpose(1, 2), n_q, self.training, generator,
            decay=self.decay,
            threshold_ema_dead_code=self.threshold_ema_dead_code, mesh=mesh)
        bandwidth = torch.tensor(n_q * math.log2(self.bins) * frame_rate / 1000,
                                 device=x.device)
        return QuantizedResult(quantized.transpose(1, 2), codes, bandwidth,
                               penalty=commits.sum() / max(n_q, 1))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, T] -> codes [B, K, T] with K = the active n_q."""
        return self.vq.encode(x.transpose(1, 2), self.n_q)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """codes [B, K, T] -> [B, D, T]."""
        return self.vq.decode(codes, dtype).transpose(1, 2)

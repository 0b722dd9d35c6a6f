"""Quantizer base types (counterpart of `audiocraft_tpu/quantization/base.py`):
`QuantizedResult`, `BaseQuantizer`, and the pass-through `DummyQuantizer`
of the `no_quant` quantizer. Latents are channels-first [B, D, T]."""
import dataclasses
import typing as tp

import torch
import torch.nn as nn


@dataclasses.dataclass
class QuantizedResult:
    """x [B, D, T] (the quantized latents; the decoded audio in a codec's
    training forward), codes, the bandwidth in kb/s, and the commitment
    penalty (mean over the active levels; None without one)."""
    x: torch.Tensor
    codes: torch.Tensor
    bandwidth: torch.Tensor
    penalty: tp.Optional[torch.Tensor] = None


class BaseQuantizer(nn.Module):
    @property
    def total_codebooks(self) -> int:
        raise NotImplementedError()

    @property
    def num_codebooks(self) -> int:
        raise NotImplementedError()

    def set_num_codebooks(self, n: int) -> None:
        raise NotImplementedError()


class DummyQuantizer(BaseQuantizer):
    """No quantization: the codes are the latents themselves, [B, 1, D, T],
    at 32 bits a value."""

    def forward(self, x: torch.Tensor, frame_rate: int,
                **kwargs) -> QuantizedResult:
        q = x.unsqueeze(1)
        bandwidth = torch.tensor(q.numel() * 32 * frame_rate / 1000 / len(x),
                                 dtype=x.dtype, device=x.device)
        return QuantizedResult(x, q, bandwidth)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(1)

    def decode(self, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return codes[:, 0].to(dtype)

    @property
    def total_codebooks(self) -> int:
        return 1

    @property
    def num_codebooks(self) -> int:
        return 1

    def set_num_codebooks(self, n: int) -> None:
        raise AttributeError("Cannot override the number of codebooks for "
                             "the dummy quantizer")

"""Streamable LSTM with a skip connection (counterpart of
`audiocraft_tpu/modules/lstm.py`), on `torch.nn.LSTM` (gate order i, f, g, o).
Input and output are channels-first [B, C, T]."""
import torch
import torch.nn as nn


class StreamableLSTM(nn.Module):
    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.skip = skip
        self.lstm = nn.LSTM(dimension, dimension, num_layers, device=device,
                            dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(2, 0, 1)  # [T, B, C]
        y, _ = self.lstm(x)
        if self.skip:
            y = y + x
        return y.permute(1, 2, 0)

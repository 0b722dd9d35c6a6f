"""Windowed scale-invariant SNR (counterpart of
`audiocraft_tpu/losses/sisnr.py`). Returns the *negative* SI-SNR, so that
it can be minimised."""
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

_EPS = float(np.finfo(np.float32).eps)


def _unfold(a: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """[*, T] -> [*, F, K] frames, zero-padded on the right so that
    F = ceil(T / stride)."""
    length = a.shape[-1]
    n_frames = math.ceil(length / stride)
    tgt_length = (n_frames - 1) * stride + kernel_size
    a = F.pad(a, (0, tgt_length - length))
    return a.unfold(-1, kernel_size, stride)


def _center(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(-1, keepdim=True)


def _norm2(x: torch.Tensor) -> torch.Tensor:
    return x.square().sum(-1, keepdim=True)


class SISNR:
    """-SI-SNR of [B, C, T] signals over segments of `segment` seconds
    (None: the whole signal) overlapping by `overlap`, averaged."""

    def __init__(self, sample_rate: int = 16000,
                 segment: tp.Optional[float] = 20, overlap: float = 0.5,
                 epsilon: float = _EPS):
        self.sample_rate = sample_rate
        self.segment = segment
        self.overlap = overlap
        self.epsilon = epsilon

    def __call__(self, out_sig: torch.Tensor,
                 ref_sig: torch.Tensor) -> torch.Tensor:
        assert ref_sig.shape == out_sig.shape
        T = ref_sig.shape[-1]
        if self.segment is None:
            frame = stride = T
        else:
            frame = int(self.segment * self.sample_rate)
            stride = int(frame * (1 - self.overlap))
        epsilon = self.epsilon * frame
        gt = _center(_unfold(ref_sig, frame, stride))
        est = _center(_unfold(out_sig, frame, stride))
        dot = (gt * est).sum(-1, keepdim=True)
        proj = dot * gt / (epsilon + _norm2(gt))
        noise = est - proj
        sisnr = 10 * (torch.log10(epsilon + _norm2(proj))
                      - torch.log10(epsilon + _norm2(noise)))
        return -1 * sisnr[..., 0].mean()

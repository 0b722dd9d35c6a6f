"""Watermark losses: sample-level detection and message decoding
(counterpart of `audiocraft_tpu/losses/wmloss.py`).

The detector's output is [B, 2 + nbits, T]: two softmaxed detection
channels (not watermarked, watermarked), then the message logits. The mask
[B, 1, T] is 1 where the watermark is present. The detection loss takes
its masked branch unless every mask value is 1; the JAX package decides
this with `lax.cond` on the device, the port on the host: the solver
passes `full` from the numpy mask it built, and without it the loss reads
the mask (a device sync).
"""
import typing as tp

import torch
import torch.nn.functional as F


def _nll(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NLL of 2-class probabilities [B, 2, T] at integer targets [B, T]."""
    logp = probs.clamp_min(1e-12).log()
    return -logp.gather(1, target[:, None, :]).mean()


class WMDetectionLoss:
    """With a full mask: p_weight x NLL(positive, 1) + n_weight x
    NLL(negative, 0); else p_weight x NLL(positive, mask)."""

    def __init__(self, p_weight: float = 1.0, n_weight: float = 1.0) -> None:
        self.p_weight = p_weight
        self.n_weight = n_weight

    def __call__(self, positive: torch.Tensor, negative: torch.Tensor,
                 mask: torch.Tensor, message=None,
                 full: tp.Optional[bool] = None) -> torch.Tensor:
        positive = positive[:, :2, :]
        negative = negative[:, :2, :]
        if full is None:
            full = bool((mask == 1).all())
        ones = torch.ones(positive.shape[0], positive.shape[-1],
                          dtype=torch.long, device=positive.device)
        if not full:
            return self.p_weight * _nll(positive, ones * mask[:, 0, :].long())
        return (self.p_weight * _nll(positive, ones)
                + self.n_weight * _nll(negative, torch.zeros_like(ones)))


class WMMbLoss:
    """Message decoding: BCE with logits (or MSE) of the message logits
    over `temperature` against the bits, averaged over the watermarked
    positions only."""

    def __init__(self, temperature: float, loss_type: str = "bce") -> None:
        assert loss_type in ("bce", "mse")
        self.loss_type = loss_type
        self.temperature = temperature

    def __call__(self, positive: torch.Tensor, negative: torch.Tensor,
                 mask: torch.Tensor, message: torch.Tensor) -> torch.Tensor:
        if message.shape[0] == 0:
            return torch.zeros((), device=positive.device)
        positive = positive[:, 2:, :]                     # [B, nbits, T]
        assert positive.shape[-2] == message.shape[1], \
            "in decoding loss: enc and dec don't share nbits"
        msg = message[..., None].to(positive.dtype).expand(positive.shape)
        logits = positive / self.temperature
        if self.loss_type == "bce":
            per = F.binary_cross_entropy_with_logits(logits, msg,
                                                     reduction="none")
        else:
            per = (logits - msg).square()
        w = mask.to(positive.dtype).expand(positive.shape)
        return (per * w).sum() / w.sum().clamp_min(1.0)

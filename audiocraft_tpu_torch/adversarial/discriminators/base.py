"""The interface of the multi-discriminators: a forward of audio [B, C, T]
returns (logits, feature maps), one entry per sub-discriminator, each
sub-discriminator's feature maps a list (NCHW, or [B, C, T] for MSD)."""
import typing as tp

import torch
import torch.nn as nn

MultiDiscriminatorOutputType = tp.Tuple[tp.List[torch.Tensor],
                                        tp.List[tp.List[torch.Tensor]]]


class MultiDiscriminator(nn.Module):
    @property
    def num_discriminators(self) -> int:
        raise NotImplementedError()

    def forward(self, x: torch.Tensor) -> MultiDiscriminatorOutputType:
        raise NotImplementedError()

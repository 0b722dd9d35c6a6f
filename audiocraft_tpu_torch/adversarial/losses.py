"""Adversarial losses (counterpart of `audiocraft_tpu/adversarial/losses.py`).

`AdversarialLoss` holds an adversary and the adversary's own optimizer:
`train_adv(fake, real)` takes one discriminator step on the detached fake
and real audio, and `forward(fake, real)` gives the generator's adversarial
and feature-matching losses, whose gradients reach the fake only.
"""
import typing as tp

import torch
import torch.nn as nn

from .discriminators.base import MultiDiscriminator

ADVERSARIAL_LOSSES = frozenset(["mse", "hinge", "hinge2"])
AdvLossType = tp.Callable[[torch.Tensor], torch.Tensor]


def mse_real_loss(x: torch.Tensor) -> torch.Tensor:
    return (x - 1.0).square().mean()


def mse_fake_loss(x: torch.Tensor) -> torch.Tensor:
    return x.square().mean()


def hinge_real_loss(x: torch.Tensor) -> torch.Tensor:
    return -torch.clamp_max(x - 1.0, 0.0).mean()


def hinge_fake_loss(x: torch.Tensor) -> torch.Tensor:
    return -torch.clamp_max(-x - 1.0, 0.0).mean()


def mse_loss(x: torch.Tensor) -> torch.Tensor:
    return (x - 1.0).square().mean()


def hinge_loss(x: torch.Tensor) -> torch.Tensor:
    return -x.mean()


def hinge2_loss(x: torch.Tensor) -> torch.Tensor:
    return -torch.clamp_max(x - 1.0, 0.0).mean()


def get_adv_criterion(loss_type: str) -> AdvLossType:
    assert loss_type in ADVERSARIAL_LOSSES
    return {"mse": mse_loss, "hinge": hinge_loss,
            "hinge2": hinge2_loss}[loss_type]


def get_fake_criterion(loss_type: str) -> AdvLossType:
    assert loss_type in ADVERSARIAL_LOSSES
    return {"mse": mse_fake_loss, "hinge": hinge_fake_loss,
            "hinge2": hinge_fake_loss}[loss_type]


def get_real_criterion(loss_type: str) -> AdvLossType:
    assert loss_type in ADVERSARIAL_LOSSES
    return {"mse": mse_real_loss, "hinge": hinge_real_loss,
            "hinge2": hinge_real_loss}[loss_type]


class FeatureMatchingLoss:
    """Sum over feature maps of the mean |fake - real|, divided by their
    number when `normalize`."""

    def __init__(self, normalize: bool = True):
        self.normalize = normalize

    def __call__(self, fmap_fake: tp.List[torch.Tensor],
                 fmap_real: tp.List[torch.Tensor]) -> torch.Tensor:
        assert len(fmap_fake) == len(fmap_real) and len(fmap_fake) > 0
        feat_loss = 0.0
        for feat_fake, feat_real in zip(fmap_fake, fmap_real):
            assert feat_fake.shape == feat_real.shape
            feat_loss = feat_loss + (feat_fake - feat_real).abs().mean()
        if self.normalize:
            feat_loss = feat_loss / len(fmap_fake)
        return feat_loss


class AdversarialLoss(nn.Module):
    """The generator's and the discriminator's losses over `adversary`,
    which `optimizer` (built over the adversary's parameters) steps. With
    `normalize`, each sum over sub-discriminators is divided by their
    number."""

    def __init__(self, adversary: MultiDiscriminator,
                 optimizer: torch.optim.Optimizer,
                 loss: AdvLossType, loss_real: AdvLossType,
                 loss_fake: AdvLossType,
                 loss_feat: tp.Optional[FeatureMatchingLoss] = None,
                 normalize: bool = True):
        super().__init__()
        self.adversary = adversary
        self.optimizer = optimizer
        self.loss = loss
        self.loss_real = loss_real
        self.loss_fake = loss_fake
        self.loss_feat = loss_feat
        self.normalize = normalize

    def train_adv(self, fake: torch.Tensor, real: torch.Tensor,
                  mesh=None) -> torch.Tensor:
        """One optimizer step of the adversary on its loss over the
        detached fake and real; returns the loss (detached). With a `mesh`
        fake and real are this rank's slice of the batch, and the
        gradients are averaged over the data ranks before the step."""
        all_logits_fake, _ = self.adversary(fake.detach())
        all_logits_real, _ = self.adversary(real.detach())
        loss = 0.0
        for lf, lr in zip(all_logits_fake, all_logits_real):
            loss = loss + self.loss_fake(lf) + self.loss_real(lr)
        if self.normalize:
            loss = loss / len(all_logits_fake)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            from ..parallel.mesh import data_average_grads
            data_average_grads(self.adversary.parameters(), mesh)
        self.optimizer.step()
        return loss.detach()

    def forward(self, fake: torch.Tensor, real: torch.Tensor
                ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(adversarial loss, feature-matching loss) of the generator: the
        adversary's verdict on `fake`, and its feature maps on `fake`
        against those on the detached `real` (0 without `loss_feat`)."""
        all_logits_fake, all_fmap_fake = self.adversary(fake)
        with torch.no_grad():
            _, all_fmap_real = self.adversary(real.detach())
        adv = sum(self.loss(logit) for logit in all_logits_fake)
        feat = torch.zeros((), device=fake.device)
        if self.loss_feat:
            for fmap_fake, fmap_real in zip(all_fmap_fake, all_fmap_real):
                feat = feat + self.loss_feat(fmap_fake, fmap_real)
        if self.normalize:
            n = len(all_logits_fake)
            adv = adv / n
            feat = feat / n
        return adv, feat

"""Adversarial networks and losses of codec training (counterpart of
`audiocraft_tpu/adversarial/`)."""
# flake8: noqa
from .discriminators.base import MultiDiscriminator
from .discriminators.mpd import MultiPeriodDiscriminator
from .discriminators.msd import MultiScaleDiscriminator
from .discriminators.msstftd import MultiScaleSTFTDiscriminator
from .losses import (ADVERSARIAL_LOSSES, AdversarialLoss, FeatureMatchingLoss,
                     get_adv_criterion, get_fake_criterion,
                     get_real_criterion)

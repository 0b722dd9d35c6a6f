"""Losses of codec and watermark training (counterpart of
`audiocraft_tpu/losses/`): the gradient-norm balancer, SI-SNR, STFT and
mel-spectrogram losses, the loudness ratios (`loudnessloss`) and the
watermark detection and decoding losses (`wmloss`)."""
# flake8: noqa
from .balancer import Balancer
from .sisnr import SISNR
from .specloss import (MelSpectrogramL1Loss, MelSpectrogramWrapper,
                       MultiScaleMelSpectrogramLoss)
from .stftloss import (MRSTFTLoss, STFTLoss, STFTLosses, log_stft_magnitude,
                       spectral_convergence)

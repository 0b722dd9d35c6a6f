"""Losses of codec training (counterpart of `audiocraft_tpu/losses/`): the
gradient-norm balancer, SI-SNR, STFT and mel-spectrogram losses. The
loudness and watermark losses of AudioSeal training are not ported
(ROADMAP, slice G part 2)."""
# flake8: noqa
from .balancer import Balancer
from .sisnr import SISNR
from .specloss import (MelSpectrogramL1Loss, MelSpectrogramWrapper,
                       MultiScaleMelSpectrogramLoss)
from .stftloss import (MRSTFTLoss, STFTLoss, STFTLosses, log_stft_magnitude,
                       spectral_convergence)

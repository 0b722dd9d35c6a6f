"""Relative Volume Mel (counterpart of `audiocraft_tpu/metrics/rvm.py`): the
distortion of an estimate's mel magnitudes relative to the ground truth's,
in dB, clipped, averaged per mel band and over `num_aggregated_bands`
groups of bands. Lower is better."""
import typing as tp

import torch

from ..ops.stft import mel_spectrogram


def db_to_scale(volume: float) -> float:
    return 10 ** (volume / 20)


def scale_to_db(scale: torch.Tensor, min_volume: float = -120.0) -> torch.Tensor:
    return 20 * torch.log10(scale.clamp_min(db_to_scale(min_volume)))


class RelativeVolumeMel:
    def __init__(self, sample_rate: int = 24000, n_mels: int = 80,
                 n_fft: int = 512, hop_length: int = 128,
                 min_relative_volume: float = -25,
                 max_relative_volume: float = 25,
                 max_initial_gain: float = 25,
                 min_activity_volume: float = -25,
                 num_aggregated_bands: int = 4) -> None:
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.min_relative_volume = min_relative_volume
        self.max_relative_volume = max_relative_volume
        self.max_initial_gain = max_initial_gain
        self.min_activity_volume = min_activity_volume
        self.num_aggregated_bands = num_aggregated_bands

    def _melspec(self, x: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram(x, self.sample_rate, self.n_fft,
                               self.hop_length, n_mels=self.n_mels,
                               power=2.0, normalized=True)

    def __call__(self, estimate: torch.Tensor,
                 ground_truth: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        """estimate, ground_truth [*, T] -> {'rvm', 'rvm_0', ...}."""
        min_scale = db_to_scale(-self.max_initial_gain)
        std = ground_truth.square().mean().sqrt().clamp_min(min_scale)
        z_gt = self._melspec(ground_truth / std).sqrt()
        z_est = self._melspec(estimate / std).sqrt()
        delta = z_gt - z_est
        ref_db = scale_to_db(z_gt, self.min_activity_volume)
        delta_db = scale_to_db(delta.abs(), min_volume=-120)
        relative_db = (delta_db - ref_db).clamp(self.min_relative_volume,
                                                self.max_relative_volume)
        dims = tuple(d for d in range(relative_db.dim())
                     if d != relative_db.dim() - 2)
        losses_per_band = relative_db.mean(dim=dims)
        chunks = torch.tensor_split(losses_per_band, self.num_aggregated_bands)
        metrics = {f"rvm_{i}": chunk.mean() for i, chunk in enumerate(chunks)}
        metrics["rvm"] = losses_per_band.mean()
        return metrics

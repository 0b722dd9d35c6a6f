"""Diffusion noise schedule and sample processors for serving (counterpart
of `audiocraft_tpu/modules/diffusion_schedule.py`): the power-law beta
schedule, the full and subsampled DDPM reverse processes, and the
`MultiBandProcessor` per-band normalisation with its statistics held as
buffers under upstream's names (`counts`, `sum_x`, `sum_x2`,
`sum_target_x2`).

The schedule's scalars stay float64 numpy, as in the JAX package. Gaussian
draws go through this module's `randn` (of shape, generator and device),
so a test can replace it with the JAX package's draws. Training
(`get_training_item`, `MultiBandProcessor.update`) waits for the diffusion
solver (ROADMAP, slice G).
"""
import typing as tp

import numpy as np
import torch
import torch.nn as nn

from ..ops.filters import SplitBands
from ..utils.utils import randn


def betas_from_alpha_bar(alpha_bar: np.ndarray) -> np.ndarray:
    alphas = np.concatenate([alpha_bar[:1], alpha_bar[1:] / alpha_bar[:-1]])
    return 1 - alphas


class SampleProcessor(nn.Module):
    """The identity projection."""

    def project_sample(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def return_sample(self, z: torch.Tensor) -> torch.Tensor:
        return z


class MultiBandProcessor(SampleProcessor):
    """Matches each of `n_bands` mel bands to the energy of Gaussian noise,
    from statistics gathered over the first `num_samples` training
    samples; `power_std` (one value or one per band) scales the
    rescaling's exponent."""

    def __init__(self, n_bands: int = 8, sample_rate: float = 24_000,
                 num_samples: int = 10_000,
                 power_std: tp.Union[float, tp.List[float]] = 1.0,
                 device=None):
        super().__init__()
        self.n_bands = n_bands
        self.split_bands = SplitBands(sample_rate, n_bands=n_bands)
        self.num_samples = num_samples
        if isinstance(power_std, list):
            assert len(power_std) == n_bands
        self.power_std = power_std
        self.register_buffer("counts", torch.zeros(1, device=device))
        for name in ("sum_x", "sum_x2", "sum_target_x2"):
            self.register_buffer(name, torch.zeros(n_bands, device=device))

    def _stats(self):
        counts = self.counts.clamp_min(1.0)
        mean = self.sum_x / counts
        std = (self.sum_x2 / counts - mean ** 2).clamp_min(0.0).sqrt()
        target_std = self.sum_target_x2 / counts
        power = torch.as_tensor(self.power_std, dtype=torch.float32,
                                device=counts.device).reshape(-1, 1, 1, 1)
        return (mean.reshape(-1, 1, 1, 1), std.reshape(-1, 1, 1, 1),
                target_std.reshape(-1, 1, 1, 1), power)

    def project_sample(self, x: torch.Tensor) -> torch.Tensor:
        assert x.dim() == 3
        mean, std, target_std, power = self._stats()
        rescale = (target_std / std.clamp_min(1e-12)) ** power
        return ((self.split_bands(x) - mean) * rescale).sum(dim=0)

    def return_sample(self, x: torch.Tensor) -> torch.Tensor:
        assert x.dim() == 3
        mean, std, target_std, power = self._stats()
        rescale = (std / target_std.clamp_min(1e-12)) ** power
        return (self.split_bands(x) * rescale + mean).sum(dim=0)


class NoiseSchedule:
    """Power-law beta schedule and the DDPM reverse process.
    `model_fn(x, step: int, condition)` gives the noise estimate."""

    def __init__(self, beta_t0: float = 1e-4, beta_t1: float = 0.02,
                 num_steps: int = 1000, variance: str = "beta",
                 clip: float = 5.0, rescale: float = 1.0, beta_exp: float = 1,
                 repartition: str = "power", alpha_sigmoid: dict = {},
                 n_bands: tp.Optional[int] = None,
                 sample_processor: tp.Optional[SampleProcessor] = None,
                 noise_scale: float = 1.0, **kwargs):
        self.beta_t0 = beta_t0
        self.beta_t1 = beta_t1
        self.variance = variance
        self.num_steps = num_steps
        self.clip = clip
        self.sample_processor = sample_processor or SampleProcessor()
        self.rescale = rescale
        self.n_bands = n_bands
        self.noise_scale = noise_scale
        assert n_bands is None
        if repartition != "power":
            raise RuntimeError("Not implemented")
        self.betas = np.linspace(beta_t0 ** (1 / beta_exp),
                                 beta_t1 ** (1 / beta_exp), num_steps,
                                 dtype=np.float64) ** beta_exp

    def get_beta(self, step):
        return self.betas[step]

    def get_initial_noise(self, x: torch.Tensor,
                          generator: tp.Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        return randn(x.shape, generator, x.device)

    def get_alpha_bar(self, step=None):
        if step is None:
            return np.cumprod(1 - self.betas, axis=-1)
        if isinstance(step, int):
            return float(np.prod(1 - self.betas[:step + 1]))
        return np.cumprod(1 - self.betas)[step]

    @torch.no_grad()
    def _reverse(self, model_fn, initial: torch.Tensor, condition,
                 step_list: tp.List[int],
                 generator: tp.Optional[torch.Generator]) -> torch.Tensor:
        """One model evaluation per step of `step_list` (all but its last
        when subsampled) and scalar algebra in float64."""
        betas_sub = None
        if step_list[0] != self.num_steps - 1 or len(step_list) != self.num_steps:
            alpha_bars_sub = np.cumprod(1 - self.betas)[list(reversed(step_list))]
            betas_sub = betas_from_alpha_bar(alpha_bars_sub)
        alpha_bar = self.get_alpha_bar(self.num_steps - 1)
        current = initial if betas_sub is None else initial * self.noise_scale
        steps = step_list[:-1] if betas_sub is not None else step_list
        for idx, step in enumerate(steps):
            estimate = model_fn(current, step, condition)
            if betas_sub is not None:
                estimate = estimate * self.noise_scale
                alpha = 1 - betas_sub[-1 - idx]
            else:
                alpha = 1 - self.betas[step]
            previous = (current - (1 - alpha) / np.sqrt(1 - alpha_bar)
                        * estimate) / np.sqrt(alpha)
            if betas_sub is not None:
                previous_alpha_bar = self.get_alpha_bar(step_list[idx + 1])
                if step == step_list[-2]:
                    sigma2 = 0.0
                    previous_alpha_bar = 1.0
                else:
                    sigma2 = ((1 - previous_alpha_bar) / (1 - alpha_bar)
                              * (1 - alpha))
            else:
                previous_alpha_bar = (self.get_alpha_bar(step - 1) if step > 0
                                      else 1.0)
                if step == 0 or self.variance == "none":
                    sigma2 = 0.0
                elif self.variance == "beta":
                    sigma2 = 1 - alpha
                elif self.variance == "beta_tilde":
                    sigma2 = ((1 - previous_alpha_bar) / (1 - alpha_bar)
                              * (1 - alpha))
                else:
                    raise ValueError(f"Invalid variance type {self.variance}")
            if sigma2 > 0:
                previous = previous + (sigma2 ** 0.5) * randn(
                    previous.shape, generator, previous.device) * self.noise_scale
            if self.clip:
                previous = previous.clamp(-self.clip, self.clip)
            current = previous
            alpha_bar = previous_alpha_bar
            if step == 0:
                previous = previous * self.rescale
        return self.sample_processor.return_sample(previous)

    def generate(self, model_fn, initial: torch.Tensor, condition=None,
                 generator: tp.Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """The full reverse process over every step."""
        return self._reverse(model_fn, initial, condition,
                             list(range(self.num_steps))[::-1], generator)

    def generate_subsampled(self, model_fn, initial: torch.Tensor,
                            step_list: tp.Optional[tp.List[int]] = None,
                            condition=None,
                            generator: tp.Optional[torch.Generator] = None
                            ) -> torch.Tensor:
        """The reverse process over `step_list`, by default
        `range(1000)[::-50] + [0]`: 20 model evaluations."""
        if step_list is None:
            step_list = list(range(1000))[::-50] + [0]
        return self._reverse(model_fn, initial, condition, step_list,
                             generator)

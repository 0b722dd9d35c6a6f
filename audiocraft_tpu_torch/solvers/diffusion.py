"""Multi-Band Diffusion training: the noise-prediction MSE of one band's
U-Net (counterpart of `audiocraft_tpu/solvers/diffusion.py`).

A step encodes the batch [B, C, T] with the frozen codec and decodes the
codes back to latents (the condition), processes the batch (boost, band
filter, resampling: `DataProcess`), adds it to the band processor's
statistics while they warm up, noises it at a step per row
(`NoiseSchedule.get_training_item`), and takes an Adam step on the mean
over rows of each row's MSE between the noise and the U-Net's estimate.
Every draw comes from the solver's generator, in that order: the
processor's reference noise, the steps, the noise. The U-Net runs in
training mode while gradients are on (cuDNN's BiLSTM backward needs it);
its dropout is 0 in every config, so the step is deterministic, as the JAX
step's call without a dropout key. A stage other than 'train' gives the loss without an
update and leaves the statistics as they are, where the JAX solver's
'valid' stage trains (ROADMAP §3). The checkpoint holds the U-Net, Adam's
state, the processor's statistics and the generator's state.
"""
import typing as tp

import numpy as np
import torch

from ..models import builders as model_builders
from ..modules.diffusion_schedule import NoiseSchedule
from ..ops.filters import SplitBands
from ..ops.resample import resample_frac
from ..utils import jax_weights
from ..utils.utils import resolve_device
from . import builders
from .base import SolverRunMixin


class PerStageMetrics:
    """Losses per bucket of diffusion steps: `num_stages` equal buckets of
    [0, num_steps); a per-row loss goes to its row's bucket, averaged over
    the rows there (buckets without a row are left out)."""

    def __init__(self, num_steps: int, num_stages: int = 4):
        self.num_steps = num_steps
        self.num_stages = num_stages

    def __call__(self, losses: tp.Dict[str, tp.Any], step) -> dict:
        if isinstance(step, int):
            stage = int((step / self.num_steps) * self.num_stages)
            return {f"{name}_{stage}": loss for name, loss in losses.items()}
        step = np.asarray(torch.as_tensor(step).cpu())
        stages = ((step / self.num_steps) * self.num_stages).astype(np.int64)
        out: tp.Dict[str, float] = {}
        for stage in range(self.num_stages):
            mask = stages == stage
            count = mask.sum()
            if count > 0:
                for name, loss in losses.items():
                    loss = np.asarray(torch.as_tensor(loss).detach().cpu())
                    out[f"{name}_{stage}"] = float((mask * loss).sum() / count)
        return out


class DataProcess:
    """The training audio of one band: `boost` rescales each row to a
    standard deviation of 0.22 (floored at 1e-4 before), `use_filter`
    keeps band `idx_band` of `n_bands` mel bands (not for metrics), and
    `use_resampling` takes it from `initial_sr` to `target_sr`."""

    def __init__(self, initial_sr: int = 24000, target_sr: int = 16000,
                 use_resampling: bool = False, use_filter: bool = False,
                 n_bands: int = 4, idx_band: int = 0, cutoffs=None,
                 boost: bool = False):
        assert idx_band < n_bands
        if use_filter and cutoffs is not None:
            raise NotImplementedError("custom band cutoffs are not supported, "
                                      "as in the JAX package")
        self.idx_band = idx_band
        self.filter = SplitBands(initial_sr, n_bands) if use_filter else None
        self.use_resampling = use_resampling
        self.initial_sr = initial_sr
        self.target_sr = target_sr
        self.boost = boost

    def process_data(self, x: tp.Optional[torch.Tensor],
                     metric: bool = False) -> tp.Optional[torch.Tensor]:
        if x is None:
            return None
        if self.boost:
            std = x.std(dim=(1, 2), keepdim=True, correction=0)
            x = x / std.clamp_min(1e-4) * 0.22
        if self.filter is not None and not metric:
            x = self.filter(x)[self.idx_band]
        if self.use_resampling:
            x = resample_frac(x, self.initial_sr, self.target_sr)
        return x

    def inverse_process(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_resampling:
            x = resample_frac(x, self.target_sr, self.initial_sr)
        return x


def diffusion_loss(model: torch.nn.Module, schedule: NoiseSchedule,
                   x: torch.Tensor, condition: tp.Optional[torch.Tensor],
                   generator: tp.Optional[torch.Generator] = None,
                   update_processor: bool = True,
                   ref_noise: tp.Optional[torch.Tensor] = None,
                   step: tp.Optional[torch.Tensor] = None,
                   noise: tp.Optional[torch.Tensor] = None
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, per-row MSE [B], steps [B]) of a processed batch x [B, C, T]
    and its condition [B, D, T'], after the processor's statistics take the
    batch (`update_processor`). The processor's reference noise, the steps
    and the noise are drawn from `generator` unless given."""
    if update_processor:
        schedule.sample_processor.update(x, generator, noise=ref_noise)
    item = schedule.get_training_item(x, generator, step=step, noise=noise)
    # cuDNN's RNN backward needs training mode; the U-Net's dropout is 0
    model.train(torch.is_grad_enabled())
    estimate = model(item.noisy, item.step, condition)
    per_item = (item.noise - estimate).square().mean(dim=(1, 2))
    return per_item.mean(), per_item, item.step


class DiffusionSolver(SolverRunMixin):
    """Multi-Band Diffusion training of one band from a solver config
    (`solver/diffusion/default`): the `DiffusionUnet` of `diffusion_unet`
    (its `transformer` key is upstream's), seeded from `seed`, over
    `channels`; the `NoiseSchedule` of `schedule` with the
    `MultiBandProcessor` of `processor` when its `use` is set (the
    processor is on by default, as in the JAX solver); the band filter and
    resampling of `filter` and `resampling`; the frozen codec of
    `compression_model_checkpoint` (a package path, or the 32 kHz debug
    codec for 'debug' or None); Adam at `optim.lr` (2e-4). Runs on CUDA
    unless `device` names another. Batches are `(wav, ...)` or `wav`,
    [B, C, T] at `sample_rate`, placed in `self.dataloaders` or built from
    `datasource`. `run_step` fills `loss` and `loss_{stage}` per
    bucket of steps (`metrics.num_stage`)."""

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataloaders: tp.Dict[str, tp.Iterable] = (
            builders.get_audio_datasets(cfg, builders.DatasetType.AUDIO,
                                        self.device)
            if cfg.get("datasource") else {})
        self.epoch = 1
        seed = cfg.get("seed", 2036)
        self.sample_rate: int = cfg.get("sample_rate", 24000)
        processor = dict(cfg.get("processor")
                         or {"name": "multi_band_processor", "use": True})
        if processor.get("name") != "multi_band_processor":
            processor["use"] = False
        self.model, self.schedule = model_builders.get_diffusion_band(
            {**cfg, "processor": processor}, self.sample_rate, self.device,
            seed)
        self.num_steps = self.schedule.num_steps
        self.sample_processor = self.schedule.sample_processor
        filter_cfg = dict(cfg.get("filter") or {})
        resample_cfg = dict(cfg.get("resampling") or {})
        self.data_processor = DataProcess(
            initial_sr=self.sample_rate,
            target_sr=resample_cfg.get("target_sr", 16000),
            use_resampling=resample_cfg.get("use", False),
            use_filter=filter_cfg.get("use", False),
            n_bands=filter_cfg.get("n_bands", 4),
            idx_band=filter_cfg.get("idx_band", 0))
        self.codec = builders.compression_model_from_checkpoint(
            cfg.get("compression_model_checkpoint"), self.device)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(),
            lr=float((cfg.get("optim") or {}).get("lr", 2e-4)))
        self.per_stage = PerStageMetrics(
            self.num_steps, (cfg.get("metrics") or {}).get("num_stage", 4))
        self._rng = torch.Generator(self.device).manual_seed(seed)

    @torch.no_grad()
    def get_condition(self, wav: torch.Tensor) -> torch.Tensor:
        """The codec's latents of its own codes for wav [B, C, T]:
        [B, D, frames]."""
        codes, scale = self.codec.encode(wav, device=self.device)
        assert scale is None, "a scaled codec is not supported"
        return self.codec.decode_latent(codes).transpose(1, 2)

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        wav = batch[0] if isinstance(batch, (tuple, list)) else batch
        x = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        condition = self.get_condition(x)
        x = self.data_processor.process_data(x)
        training = self.current_stage == "train"
        with torch.set_grad_enabled(training):
            loss, per_item, steps = diffusion_loss(
                self.model, self.schedule, x, condition, self._rng,
                update_processor=training)
        if training:
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            builders.fill_missing_grads(self.optimizer)
            self.optimizer.step()
        metrics["loss"] = loss.detach()
        metrics.update(self.per_stage({"loss": per_item.detach()}, steps))
        return metrics

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "processor": self.sample_processor.state_dict(),
                "rng": self._rng.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.sample_processor.load_state_dict(state["processor"])
        self._rng.set_state(state["rng"])

    def load_model_weights(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])

    def load_jax_params(self, tree) -> None:
        jax_weights.load_diffusion_unet(self.model, tree)

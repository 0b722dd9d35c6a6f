"""AudioSeal training: a watermark generator and detector trained together
(counterpart of `audiocraft_tpu/solvers/watermark.py`).

A step (`train_step`) follows the JAX package's step:

1. the generator watermarks the batch, y_wm = x + watermark(x, message);
2. the balanced perceptual losses (l1, msspec, the time-frequency
   loudness ratio, SI-SNR where its weight is above 0) give their
   gradient with respect to y_wm through the `Balancer`;
3. the watermark is kept where the mask is 1 (`pad`, `mix` or all), the
   drawn effect attacks it, and the detector's outputs on the attacked
   audio and on the clean audio give the detection and decoding losses;
4. one backward takes both gradients through the generator and the
   detector's gradient from the detection and decoding losses, and Adam
   takes a step.

The JAX step runs the generator twice (once under `jax.vjp`, once inside
the detection loss); the port runs it once and adds both gradients in one
backward, the same math. As in the JAX package the optimizer is Adam at
`optim.lr` whatever `optim.optimizer` says, the losses' settings come from
the `msspec`, `tf_loudnessratio`, `wm_detection`, `wm_mb` and `balancer`
groups (defaults where absent), and the widths from `audioseal` (two LSTM
layers, detector output 32).

Every draw comes from the solver's CPU generator, in this order: the
message, the mode (pad 0.2, mix 0.2, none 0.6), pad's side and its starts
and ends or mix's window, the effect, then the effect's own draws, so a
step on the card draws what the same step on the CPU draws.
`train_step(x, message, mask, effect_name)` takes the draws of a step
from the caller (a test injects the JAX package's). The JAX package draws
from numpy's and Python's global generators, and an effect's draws once
per compiled step (ROADMAP §3).

An effect that changes the length (`speed`) raises: the detector's output
no longer matches the mask, and the JAX step fails there too. The mp3 and
aac attacks go through the libav binding: where it cannot be built, a
config that gives either a weight above 0 raises at construction. `dataset.segment_duration` null
(the composed `solver/watermark/default`) raises `TypeError`, as in the
JAX package.
"""
import logging
import typing as tp

import numpy as np
import torch

from ..data import _native
from ..losses import SISNR, Balancer, MultiScaleMelSpectrogramLoss
from ..losses.loudnessloss import TFLoudnessRatio
from ..losses.wmloss import WMDetectionLoss, WMMbLoss
from ..metrics.miou import calculate_miou
from ..models.watermark import AudioSealDetector, AudioSealWM
from ..modules.watermark import mix, pad
from ..parallel import distrib
from ..utils import audio_effects, jax_weights
from ..utils.audio_effects import AudioEffects
from ..utils.utils import resolve_device
from . import builders
from .base import SolverRunMixin

logger = logging.getLogger(__name__)

MODES = ("pad", "mix", "none")
MODE_P = (0.2, 0.2, 0.6)


def random_message(generator: tp.Optional[torch.Generator], nbits: int,
                   batch_size: int) -> torch.Tensor:
    """[batch_size, nbits] random bits (int64), or [batch_size, 0]."""
    if nbits == 0:
        return torch.zeros(batch_size, 0, dtype=torch.long)
    return torch.randint(0, 2, (batch_size, nbits), generator=generator)


def _audio(batch) -> torch.Tensor:
    """The audio of a batch, `(wav, ...)` or `wav` (numpy or a tensor on
    any device), as f32."""
    wav = batch[0] if isinstance(batch, (tuple, list)) else batch
    return torch.as_tensor(wav, dtype=torch.float32)


def _l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


class WatermarkSolver(SolverRunMixin):
    """AudioSeal training from a solver config (`solver/watermark/*`):
    seeded torch init of the generator and detector from `seed`, on CUDA
    unless `device` names another. Batches are `(wav, ...)` or `wav`
    [B, 1, T] of `segment_duration` seconds, placed in `self.dataloaders`
    (or built from `datasource`)."""

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataloaders: tp.Dict[str, tp.Iterable] = (
            builders.get_audio_datasets(cfg, builders.DatasetType.AUDIO,
                                        self.device)
            if cfg.get("datasource") else {})
        self.epoch = 1
        self.sample_rate: int = cfg.get("sample_rate", 16000)
        if "aug_weights" in cfg and "audio_effects" in cfg:
            self.aug_weights = dict(cfg["aug_weights"])
            self.augmentations = audio_effects.get_audio_effects(cfg)
        else:
            self.augmentations = {
                "identity": AudioEffects.identity,
                "random_noise": AudioEffects.random_noise,
                "boost_audio": AudioEffects.boost_audio,
                "duck_audio": AudioEffects.duck_audio}
            self.aug_weights = {k: 0.5 for k in self.augmentations}
            self.aug_weights["identity"] = 1.0
        codec = [k for k in audio_effects.CODEC_EFFECTS
                 if k in self.augmentations and self.aug_weights.get(k, 1.0) > 0]
        if codec and not _native.av_available():
            raise RuntimeError(
                f"the {' and '.join(codec)} attacks need the libav binding, "
                f"which cannot be built here: give them weight 0")
        seed = cfg.get("seed", 2036)
        wm_cfg = dict(cfg.get("audioseal", {}) or {})
        self.nbits = wm_cfg.pop("nbits", 16)
        arch = dict(dimension=wm_cfg.pop("dimension", 32),
                    n_filters=wm_cfg.pop("n_filters", 4),
                    n_residual_layers=wm_cfg.pop("n_residual_layers", 1),
                    ratios=tuple(wm_cfg.pop("ratios", (8, 5, 4, 2))))
        segment = (cfg.get("dataset", {}) or {}).get("segment_duration", 1.0)
        self.segment_samples = int(self.sample_rate * segment)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.generator = AudioSealWM(nbits=self.nbits, **arch)
            self.detector = AudioSealDetector(nbits=self.nbits, **arch)
        # cuDNN's LSTM backward refuses evaluation mode; neither model has
        # dropout or batch norm, so training mode changes nothing else
        self.generator.to(self.device).train()
        self.detector.to(self.device).train()

        losses_cfg = dict(cfg.get("losses", {}) or {})
        self.loss_weights = {
            "l1": losses_cfg.get("l1", 0.1),
            "msspec": losses_cfg.get("msspec", 2.0),
            "sisnr": losses_cfg.get("sisnr", 0.0),
            "tf_loudnessratio": losses_cfg.get("tf_loudnessratio", 10.0)}
        self.wm_detection_weight = losses_cfg.get("wm_detection", 1.0)
        self.wm_mb_weight = losses_cfg.get("wm_mb", 1.0)
        self.percep_losses: tp.Dict[str, tp.Callable] = {
            "l1": _l1,
            "msspec": MultiScaleMelSpectrogramLoss(
                self.sample_rate, **cfg.get("msspec", {
                    "range_start": 6, "range_end": 9, "n_mels": 16})),
            "sisnr": SISNR(self.sample_rate, segment=min(segment, 0.5)),
            "tf_loudnessratio": TFLoudnessRatio(
                self.sample_rate, **cfg.get("tf_loudnessratio", {
                    "segment": 0.5, "n_bands": 4}))}
        self.detection_loss = WMDetectionLoss(**cfg.get(
            "wm_detection", {"p_weight": 1.0, "n_weight": 1.0}))
        self.decoding_loss = WMMbLoss(**cfg.get(
            "wm_mb", {"temperature": 0.1, "loss_type": "bce"}))
        self.balancer = Balancer(
            {k: w for k, w in self.loss_weights.items() if w > 0},
            **(cfg.get("balancer", {}) or {}))
        lr = float((cfg.get("optim", {}) or {}).get("lr", 5e-5))
        self.optimizer = torch.optim.Adam(
            list(self.generator.parameters())
            + list(self.detector.parameters()), lr=lr)

        self._rng = torch.Generator().manual_seed(seed)
        self.step = 0

    # ------------------------------------------------------------- steps
    def draw(self, x: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor,
                                                  str]:
        """The draws of a step on a CPU batch x [B, 1, T]: (message,
        mask [B, 1, T] on the CPU, effect name)."""
        g = self._rng
        message = random_message(g, self.nbits, x.shape[0])
        u = audio_effects.uniform(0.0, 1.0, g)
        mode = MODES[int(np.searchsorted(np.cumsum(MODE_P), u, side="right"))]
        if mode == "pad":
            central = audio_effects.uniform(0.0, 1.0, g) < 0.5
            mask = pad(x, central=central, generator=g)[1][:, 1:2]
        elif mode == "mix":
            mask = mix(x, x, window_size=0.5, generator=g)[1][:, 1:2]
        else:
            mask = torch.ones_like(x[:, :1])
        effects = audio_effects.select_audio_effects(
            self.augmentations, self.aug_weights, mode="weighted",
            max_length=1, generator=g)
        return message, mask, next(iter(effects))

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        x = _audio(batch)
        message, mask, effect_name = self.draw(x.cpu())
        metrics.update(self.train_step(x, message, mask, effect_name))
        return metrics

    def train_step(self, x: torch.Tensor, message: torch.Tensor,
                   mask: torch.Tensor, effect_name: str
                   ) -> tp.Dict[str, torch.Tensor]:
        """One step on audio x [B, 1, T] with the given draws: message
        [B, nbits] of 0/1, mask [B, 1, T] (1: watermarked; decided on the
        host), and the effect's name."""
        x = x.to(self.device)
        mask_cpu = torch.as_tensor(mask).cpu()
        full = bool((mask_cpu == 1).all())
        mask = mask_cpu.to(self.device, x.dtype)
        message = torch.as_tensor(message).to(self.device)
        y_wm = x + self.generator.get_watermark(x, message, self.sample_rate)
        y = y_wm.detach().requires_grad_(True)
        losses = {k: self.percep_losses[k](y, x) for k in self.balancer.weights}
        g_loss, balancer_metrics = self.balancer.backward(losses, y)
        loss_det, loss_mb = self._watermark_backward(
            x, y_wm, y.grad, message, mask, full, effect_name)
        builders.fill_missing_grads(self.optimizer)
        self.optimizer.step()
        self.step += 1
        metrics = {"d_loss": loss_det, "mb_loss": loss_mb,
                   "percep_loss": g_loss}
        metrics.update({k: v.detach() for k, v in losses.items()})
        metrics.update(balancer_metrics)
        return metrics

    def _watermark_backward(self, x, y_wm, percep_grad, message, mask,
                            full: bool, effect_name: str):
        """The detection and decoding losses on the attacked watermarked
        audio, and one backward of them with the balanced gradient of
        y_wm; returns (detection loss, decoding loss), detached."""
        attacked = y_wm * mask
        attacked = self.augmentations[effect_name](attacked,
                                                   generator=self._rng)
        if attacked.shape[-1] != x.shape[-1]:
            raise ValueError(
                f"the {effect_name!r} attack changed the length "
                f"{x.shape[-1]} -> {attacked.shape[-1]}: the detector's "
                f"output no longer matches the mask (the JAX step fails "
                f"here too)")
        positive = self.detector(attacked)
        negative = self.detector(x)
        loss_det = self.detection_loss(positive, negative, mask, full=full)
        loss_mb = self.decoding_loss(positive, negative, mask, message)
        wm_loss = (self.wm_detection_weight * loss_det
                   + self.wm_mb_weight * loss_mb)
        self.optimizer.zero_grad(set_to_none=True)
        torch.autograd.backward([y_wm, wm_loss], [percep_grad, None])
        return loss_det.detach(), loss_mb.detach()

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def evaluate(self) -> dict:
        """Over the 'evaluate' loader ({} without one): detection accuracy
        and its false negative and positive rates on watermarked against
        clean audio, the message's bit accuracy, the localisation mIoU of
        clips watermarked in their first half, and the SI-SNR of the
        watermarked audio. PESQ and STOI are external extensions: asking
        for them warns."""
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}
        sisnr = SISNR(sample_rate=self.sample_rate)
        totals: tp.Dict[str, float] = {}
        count = 0

        def add(key, value):
            totals[key] = totals.get(key, 0.0) + float(value)

        for batch in loader:
            x = _audio(batch).to(self.device)
            B, _, T = x.shape
            message = random_message(self._rng, self.nbits, B).to(self.device)
            y = x + self.generator.get_watermark(x, message, self.sample_rate)
            pos = self.detector(y).cpu()
            neg = self.detector(x).cpu()
            det_pos = (pos[:, 1] > pos[:, 0]).float().mean()
            det_neg = (neg[:, 1] > neg[:, 0]).float().mean()
            add("detection_acc", (det_pos + (1 - det_neg)) / 2)
            add("fnr", 1 - det_pos)
            add("fpr", det_neg)
            if self.nbits:
                bits = (pos[:, 2:] > 0).float().mean(dim=-1) > 0.5
                add("bit_acc", (bits == (message.cpu() > 0.5)).float().mean())
            half = torch.cat([y[..., :T // 2], x[..., T // 2:]], dim=-1)
            det_half = self.detector(half).cpu()
            pred = (det_half[:, 1] > det_half[:, 0]).float().numpy()
            truth = np.concatenate([np.ones((B, T // 2)),
                                    np.zeros((B, T - T // 2))], axis=1)
            add("miou", calculate_miou(pred, truth))
            add("sisnr_wm", -sisnr(y, x).mean())
            count += 1
        if ((self.cfg.get("evaluate", {}) or {}).get("metrics", {})
                or {}).get("pesq"):
            logger.warning("PESQ/STOI need external C extensions; skipping")
        return distrib.average_metrics(
            {k: v / max(count, 1) for k, v in totals.items()}, count)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {"generator": self.generator.state_dict(),
                "detector": self.detector.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "balancer": self.balancer.state_dict(), "step": self.step,
                "rng": self._rng.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.load_model_weights(state)
        self.optimizer.load_state_dict(state["optimizer"])
        balancer = state["balancer"]
        self.balancer.load_state_dict({
            "avg": {k: v.to(self.device) for k, v in balancer["avg"].items()},
            "count": None if balancer["count"] is None
            else balancer["count"].to(self.device)})
        self.step = state["step"]
        self._rng.set_state(state["rng"])

    def load_model_weights(self, state: dict) -> None:
        self.generator.load_state_dict(state["generator"])
        self.detector.load_state_dict(state["detector"])

    def load_jax_params(self, tree) -> None:
        """The JAX package's weights: a `WatermarkTrainState` tree's params
        or the {'generator', 'detector'} params themselves."""
        jax_weights.load_audioseal(self, tree.get("params", tree))

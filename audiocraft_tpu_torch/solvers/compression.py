"""EnCodec GAN training (counterpart of `audiocraft_tpu/solvers/compression.py`).

A training step follows the JAX package's `make_compression_train_step`:

1. the generator's forward in training mode: the codebooks take their EMA
   step, a codebook that is not `inited` its k-means, dead codes their
   replacements (draws from the solver's CPU generator);
2. with probability 1 / `adversarial.every`, one step of each adversary on
   the detached output and the real audio;
3. the balanced losses against the output, taken with the updated
   adversaries: each adversary runs once on the output (detached into a
   leaf, with its graph) and once on the real audio (without), and each
   loss's gradient with respect to the leaf is taken on its own;
4. one backward of the generator's output with the balanced gradient, and
   of the commitment penalty at weight 1;
5. global-norm clipping at `optim.max_norm` (0: none), then Adam(0.5, 0.9).

Auxiliary losses of weight 0 are computed on the output as information
only. A stage other than 'train' runs the valid step: every loss, no
update. The generator trains in training mode (cuDNN's LSTM backward
refuses evaluation mode). The checkpoint holds the generator under
upstream's keys (as `best_state`, with the codec's config as `xp.cfg`, so
that `models.loaders.load_compression_model` and a solver's
`compression_model_checkpoint` read it), its Adam, each adversary with its
Adam, the balancer's state, the step and the generator's state.
"""
import logging
import typing as tp
from types import SimpleNamespace

import torch

from ..adversarial import (AdversarialLoss, FeatureMatchingLoss,
                           MultiPeriodDiscriminator, MultiScaleDiscriminator,
                           MultiScaleSTFTDiscriminator, get_adv_criterion,
                           get_fake_criterion, get_real_criterion)
from ..losses import (SISNR, Balancer, MelSpectrogramL1Loss, MRSTFTLoss,
                      MultiScaleMelSpectrogramLoss)
from ..metrics import RelativeVolumeMel
from ..models import builders as model_builders
from ..parallel import distrib
from ..parallel.mesh import (batch_sharding, data_all_reduce,
                             data_average_grads, data_size)
from ..utils import jax_weights
from ..utils.samples.manager import SampleManager
from ..utils.utils import resolve_device, to_device
from . import builders
from .base import SolverRunMixin

logger = logging.getLogger(__name__)

DEFAULT_LOSSES = {"adv": 4.0, "feat": 4.0, "l1": 0.1, "msspec": 2.0,
                  "mel": 0.0, "sisnr": 0.0}


def _l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def _l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).square().mean()


def get_aux_losses(cfg: dict, sample_rate: int) -> tp.Dict[str, tp.Callable]:
    """l1, l2, mrstft, mel, msspec and sisnr, each from its config group."""
    out: tp.Dict[str, tp.Callable] = {"l1": _l1, "l2": _l2}
    out["mrstft"] = MRSTFTLoss(**cfg.get("mrstft", {}))
    out["mel"] = MelSpectrogramL1Loss(**{"sample_rate": sample_rate,
                                         **cfg.get("mel", {})})
    out["msspec"] = MultiScaleMelSpectrogramLoss(
        **{"sample_rate": sample_rate, **cfg.get("msspec", {})})
    out["sisnr"] = SISNR(**{"sample_rate": sample_rate, **cfg.get("sisnr", {})})
    return out


def get_adversarial_losses(cfg: dict, device=None, seed: int = 1
                           ) -> tp.Dict[str, AdversarialLoss]:
    """One `AdversarialLoss` per name in `adversarial.adversaries` (msstftd,
    msd, mpd, from their config groups; seeded torch init), each with its
    own Adam(0.5, 0.9) at `optim.lr`. As in the JAX package, the MS-STFT
    discriminator's `activation` settings are dropped: LeakyReLU(0.2)."""
    device = resolve_device(device)
    adv_cfg = cfg.get("adversarial", {}) or {}
    adv_loss_name = adv_cfg.get("adv_loss", "hinge")
    feat_loss_name = adv_cfg.get("feat_loss", "l1")
    lr = float((cfg.get("optim", {}) or {}).get("lr", 3e-4))
    out = {}
    for i, name in enumerate(adv_cfg.get("adversaries", ["msstftd"])):
        kw = dict(cfg.get(name, {}) or {})
        with torch.random.fork_rng(devices=[device] if device.type == "cuda"
                                   else []):
            torch.manual_seed(seed + i)
            if name == "msstftd":
                kw.pop("activation", None)
                kw.pop("activation_params", None)
                adversary = MultiScaleSTFTDiscriminator(**kw)
            elif name == "msd":
                adversary = MultiScaleDiscriminator(**kw)
            elif name == "mpd":
                adversary = MultiPeriodDiscriminator(**kw)
            else:
                raise ValueError(f"Unknown adversary: {name}")
        adversary = adversary.to(device)
        optimizer = torch.optim.Adam(adversary.parameters(), lr=lr,
                                     betas=(0.5, 0.9))
        out[name] = AdversarialLoss(
            adversary, optimizer, loss=get_adv_criterion(adv_loss_name),
            loss_real=get_real_criterion(adv_loss_name),
            loss_fake=get_fake_criterion(adv_loss_name),
            loss_feat=FeatureMatchingLoss() if feat_loss_name else None,
            normalize=adv_cfg.get("normalize", True))
    return out


def _debug_codec_cfg(sample_rate: int) -> dict:
    """The package config of `builders.get_debug_compression_model`."""
    return {"compression_model": "encodec", "encodec": {
        "sample_rate": sample_rate, "channels": 1,
        "seanet": {"dimension": 32, "n_filters": 4, "n_residual_layers": 1,
                   "ratios": list(model_builders.DEBUG_CODEC_RATIOS[sample_rate]),
                   "lstm": 0, "norm": "none"},
        "rvq": {"n_q": 4, "bins": 400, "kmeans_init": False}}}


class CompressionSolver(SolverRunMixin):
    """EnCodec training from a solver config (`solver/compression/*`): the
    codec of the `encodec` group (`compression_model: encodec`; seeded
    torch init from `seed`, k-means codebooks as the config says), else
    the debug codec at `sample_rate`; the losses of `losses` (weight 0:
    information), the balancer of `balancer`, the adversaries of
    `adversarial`; Adam(0.5, 0.9) at `optim.lr`, clipped at
    `optim.max_norm`. Runs on CUDA unless `device` names another. Batches
    are `(wav, ...)` or `wav` [B, C, T], placed in `self.dataloaders` or
    built from `datasource`."""

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataloaders: tp.Dict[str, tp.Iterable] = (
            builders.get_audio_datasets(cfg, builders.DatasetType.AUDIO,
                                        self.device)
            if cfg.get("datasource") else {})
        self.epoch = 1
        seed = cfg.get("seed", 2036)
        self.sample_rate: int = cfg.get("sample_rate", 32000)
        if cfg.get("compression_model") == "encodec":
            self.codec_cfg = {"compression_model": "encodec",
                              "encodec": dict(cfg["encodec"])}
            self.model = model_builders.get_compression_model(
                self.codec_cfg, self.device)
            self.model.reset_parameters(seed)
        else:
            self.codec_cfg = _debug_codec_cfg(self.sample_rate)
            self.model = model_builders.get_debug_compression_model(
                self.device, seed=0, sample_rate=self.sample_rate)
        self.model.train()

        weights = dict(cfg.get("losses", DEFAULT_LOSSES))
        self.aux_losses = get_aux_losses(cfg, self.sample_rate)
        self.adv_losses = get_adversarial_losses(cfg, self.device, seed + 1)
        self.balanced_names = [k for k, w in weights.items()
                               if k in self.aux_losses and w > 0]
        self.info_names = [k for k, w in weights.items()
                           if k in self.aux_losses and w == 0]
        bal_weights = {}
        for n in self.adv_losses:
            bal_weights[f"adv_{n}"] = weights.get("adv", 1.0)
            bal_weights[f"feat_{n}"] = weights.get("feat", 1.0)
        for k in self.balanced_names:
            bal_weights[k] = weights[k]
        self.balancer = Balancer(bal_weights, **(cfg.get("balancer", {}) or {}))

        optim_cfg = cfg.get("optim", {}) or {}
        lr = float(optim_cfg.get("lr", 3e-4))
        self.optimizer = builders.ClippedOptimizer(
            torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.5, 0.9)),
            [lambda step: lr], float(optim_cfg.get("max_norm", 0.0) or 0.0))
        self.disc_every = (cfg.get("adversarial", {}) or {}).get("every", 1)
        # the quantizer's and the adversaries' draws: on the CPU, so that
        # a step on the card draws what the same step on the CPU draws
        self._rng = torch.Generator().manual_seed(seed)
        self.step = 0

    # ------------------------------------------------------------- steps
    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        wav = batch[0] if isinstance(batch, (tuple, list)) else batch
        x = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        if self.current_stage != "train":
            metrics.update(self.valid_step(x))
        else:
            metrics.update(self.train_step(x))
        return metrics

    def train_step(self, x: torch.Tensor, mesh=None
                   ) -> tp.Dict[str, torch.Tensor]:
        """One GAN step on audio x [B, C, T] on the solver's device.

        With a `mesh` (`parallel/mesh.py`; the JAX package's
        `make_compression_train_step(..., mesh=)`) every rank passes the
        same global batch and runs its slice over ('dp', 'fsdp'), the
        generator and the adversaries replicated: the codebooks update on
        the whole batch's latents, the balancer takes the whole batch's
        gradient norms, every gradient is averaged over the data ranks
        before its optimizer's step, and so are the metrics; the step is
        the one-process step on the whole batch. Every rank draws the same
        numbers from the solver's generator, as one process would."""
        if mesh is not None:
            x = batch_sharding(mesh)(x)
        self.model.train()
        qres = self.model(x, generator=self._rng, mesh=mesh)
        y_pred = qres.x
        metrics = {"bandwidth": qres.bandwidth.float().mean()}
        penalty = qres.penalty
        if penalty is not None:
            metrics["penalty"] = penalty.detach()
        y_det = y_pred.detach()

        train_disc = bool(torch.rand((), generator=self._rng)
                          <= 1.0 / self.disc_every)
        d_total = torch.zeros((), device=x.device)
        for name, adversary in self.adv_losses.items():
            d_loss = (adversary.train_adv(y_det, x, mesh) if train_disc
                      else torch.zeros((), device=x.device))
            metrics[f"d_{name}"] = d_loss
            d_total = d_total + d_loss
        if self.adv_losses:
            metrics["d_loss"] = d_total

        y = y_det.clone().requires_grad_(True)
        losses: tp.Dict[str, torch.Tensor] = {}
        for name, adversary in self.adv_losses.items():
            losses[f"adv_{name}"], losses[f"feat_{name}"] = adversary(y, x)
        for k in self.balanced_names:
            losses[k] = self.aux_losses[k](y, x)
        g_loss, balancer_metrics = self.balancer.backward(losses, y, mesh)
        metrics.update({k: v.detach() for k, v in losses.items()})
        metrics.update(balancer_metrics)
        metrics["g_loss"] = g_loss

        self.optimizer.zero_grad()
        outputs, grads = [y_pred], [y.grad]
        if penalty is not None and penalty.requires_grad:
            outputs.append(penalty)
            grads.append(torch.ones_like(penalty))
        torch.autograd.backward(outputs, grads)
        builders.fill_missing_grads(self.optimizer.optimizer)
        if mesh is not None:
            data_average_grads(self.model.parameters(), mesh)
        self.optimizer.step()
        self.step += 1

        with torch.no_grad():
            for k in self.info_names:
                metrics[k] = self.aux_losses[k](y_det, x)
        if self.adv_losses:
            metrics["adv"] = sum(metrics[f"adv_{n}"] for n in self.adv_losses)
            metrics["feat"] = sum(metrics[f"feat_{n}"] for n in self.adv_losses)
        if mesh is not None:
            names = sorted(metrics)
            means = data_all_reduce(torch.stack(
                [metrics[k].detach().float() for k in names]), mesh)
            metrics = dict(zip(names, means / data_size(mesh)))
        return metrics

    @torch.no_grad()
    def valid_step(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        """Every loss of the codec in evaluation mode (no codebook update),
        against each adversary as it stands."""
        self.model.eval()
        try:
            qres = self.model(x)
        finally:
            self.model.train()
        y = qres.x
        metrics = {"bandwidth": qres.bandwidth.float().mean()}
        if qres.penalty is not None:
            metrics["penalty"] = qres.penalty
        for name, adversary in self.adv_losses.items():
            metrics[f"adv_{name}"], metrics[f"feat_{name}"] = adversary(y, x)
        for k, f in self.aux_losses.items():
            metrics[k] = f(y, x)
        return metrics

    # ------------------------------------------------------------ stages
    def evaluate(self) -> dict:
        """SI-SNR and the relative volume mel of the codec's reconstruction
        (encode, then decode) over the 'evaluate' loader; {} without one.
        ViSQOL is an external binary, not run: asking for it warns."""
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}
        sisnr = SISNR(sample_rate=self.model.sample_rate)
        rvm = RelativeVolumeMel(sample_rate=self.model.sample_rate)
        totals: tp.Dict[str, float] = {}
        count = 0
        self.model.eval()
        try:
            for batch in loader:
                wav = batch[0] if isinstance(batch, (tuple, list)) else batch
                x = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
                codes, scale = self.model.encode(x, device=self.device)
                y = self.model.decode(codes, scale,
                                      device=self.device)[..., :x.shape[-1]]
                totals["sisnr"] = totals.get("sisnr", 0.0) - float(sisnr(y, x))
                for k, v in rvm(y, x).items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        finally:
            self.model.train()
        if ((self.cfg.get("evaluate", {}) or {}).get("metrics", {})
                or {}).get("visqol"):
            logger.warning("ViSQOL is an external binary; skipping")
        return distrib.average_metrics(
            {k: v / max(count, 1) for k, v in totals.items()}, count)

    @torch.no_grad()
    def generate(self) -> dict:
        """The codec's reconstructions of one batch of the 'generate' loader
        (else 'evaluate', else 'valid'; {} without one), stored by the
        sample manager with the batch as their references, each reference
        named by its sample's id."""
        loader = (self.dataloaders.get("generate")
                  or self.dataloaders.get("evaluate")
                  or self.dataloaders.get("valid"))
        if loader is None:
            return {}
        manager = SampleManager(SimpleNamespace(folder=self._folder,
                                                cfg=self.cfg),
                                map_reference_to_sample_id=True)
        n = 0
        self.model.eval()
        try:
            for batch in loader:
                wav = batch[0] if isinstance(batch, (tuple, list)) else batch
                x = to_device(torch.as_tensor(wav, dtype=torch.float32),
                              self.device)
                codes, scale = self.model.encode(x, device=self.device)
                y = self.model.decode(codes, scale,
                                      device=self.device)[..., :x.shape[-1]]
                manager.add_samples(y, self.epoch, ground_truth_wavs=x)
                n += y.shape[0]
                break  # one batch of reconstructions per generate stage
        finally:
            self.model.train()
        logger.info("Stored %d codec reconstructions under %s", n,
                    manager.base_folder)
        return {"generated_samples": n}

    @staticmethod
    def model_from_checkpoint(checkpoint_path, device=None):
        """The trained codec of a checkpoint (or of its folder), for the
        solvers that take a `compression_model_checkpoint`."""
        from ..models import loaders
        return loaders.load_compression_model(str(checkpoint_path),
                                              device=device)

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        weights = self.model.state_dict()
        return {"model": weights, "best_state": weights,
                "xp.cfg": self.codec_cfg,
                "optimizer": self.optimizer.optimizer.state_dict(),
                "adversaries": {
                    name: {"model": a.adversary.state_dict(),
                           "optimizer": a.optimizer.state_dict()}
                    for name, a in self.adv_losses.items()},
                "balancer": self.balancer.state_dict(), "step": self.step,
                "rng": self._rng.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.optimizer.load_state_dict(state["optimizer"])
        for name, a in self.adv_losses.items():
            a.adversary.load_state_dict(state["adversaries"][name]["model"])
            a.optimizer.load_state_dict(state["adversaries"][name]["optimizer"])
        balancer = state["balancer"]
        self.balancer.load_state_dict({
            "avg": {k: v.to(self.device) for k, v in balancer["avg"].items()},
            "count": None if balancer["count"] is None
            else balancer["count"].to(self.device)})
        self.step = state["step"]
        self._rng.set_state(state["rng"])

    def load_model_weights(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])

    def load_jax_params(self, tree) -> None:
        """The JAX package's weights: a `CompressionTrainState` tree (its
        generator variables and each adversary's parameters), or a codec's
        variables {'params', 'quantizer'}."""
        jax_weights.load_encodec(self.model, tree.get("gen_vars", tree))
        for name, a in self.adv_losses.items():
            states = tree.get("adv_states", {})
            if name in states:
                jax_weights.load_adversary(a.adversary, states[name]["params"])

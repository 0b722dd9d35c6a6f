"""JASCO training: flow matching on the codec's latents (counterpart of
`audiocraft_tpu/solvers/jasco.py`).

A step takes the codec encoder's unquantized latents x1 [B, T, D] of the
batch and its tokenized conditions, draws t ~ U(0, 1) per row and
z0 ~ N(0, 1), and regresses the model's vector field at
z_t = t x1 + (1 - (1 - sigma_min) t) z0 onto x1 - (1 - sigma_min) z0 (MSE),
with an AdamW step at `optim.lr` (optax's defaults: weight decay 1e-4).
Two facts of the JAX solver are kept: it applies no attribute or
classifier-free-guidance dropout, though `conditioner/jasco_chords_drums`
names one (chords and `self_wav` at 0.5), and it calls the model
deterministically, so the U-Net transformer's layer dropout never runs.
One is not: the JAX solver always trains the debug model over the debug
codec, whatever its config names; here a config with `transformer_lm`
builds its model (`models.builders.get_jasco_model`) and the codec comes
from `compression_model_checkpoint` (ROADMAP §3). A stage other than
'train' gives the loss without an update, where the JAX solver's 'valid'
stage trains.
"""
import logging
import typing as tp
from types import SimpleNamespace

import numpy as np
import torch

from ..models import builders as model_builders
from ..models.flow_matching import FlowMatchingModel
from ..models.jasco import JASCO
from ..modules.conditioners import ConditioningAttributes, SymbolicCondition
from ..modules.jasco_conditioners import (DrumsConditioner,
                                          JascoConditioningProvider,
                                          bind_drums_codec)
from ..parallel import distrib
from ..utils import jax_weights
from ..utils.samples.manager import SampleManager
from ..utils.utils import randn, resolve_device
from . import builders
from .base import SolverRunMixin

logger = logging.getLogger(__name__)

EVAL_BUCKETS = {0.1: "t_low", 0.5: "t_mid", 0.9: "t_high"}
SIGMA_MIN = 1e-4


def flow_matching_loss(model: FlowMatchingModel, x1: torch.Tensor,
                       tokenized: tp.Dict[str, tp.Any],
                       generator: tp.Optional[torch.Generator] = None,
                       t: tp.Optional[torch.Tensor] = None,
                       z0: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conditional flow-matching MSE of latents x1 [B, T, D] (not
    normalised: the JAX step's latent mean 0 and std 1) under the tokenized
    conditions, the model run deterministically; t [B] and z0 are drawn
    from `generator` unless given."""
    model.eval()
    condition_tensors = model.compute_conditions(tokenized)
    if t is None:
        t = torch.rand((x1.shape[0],), generator=generator, device=x1.device)
    if z0 is None:
        z0 = randn(x1.shape, generator, x1.device)
    t_ = t[:, None, None]
    z_t = t_ * x1 + (1 - (1 - SIGMA_MIN) * t_) * z0
    u_t = x1 - (1 - SIGMA_MIN) * z0
    v_theta = model(z_t, t, condition_tensors)
    return (v_theta - u_t).square().mean()


class JascoSolver(SolverRunMixin):
    """JASCO training from a solver config dict: the flow-matching model of
    `transformer_lm` and `conditioners` (`models.builders.get_jasco_model`)
    or, without `transformer_lm`, the debug JASCO's, seeded from `seed`;
    the frozen codec of `compression_model_checkpoint` (a package path, or
    the 32 kHz debug codec for 'debug' or None), bound to a drum
    conditioner; AdamW at `optim.lr` (1e-4). Runs on CUDA unless `device`
    names another. Batches are `(wav, infos)` or `wav`, [B, C, T] at the
    codec's rate, in `self.dataloaders` (or built from `datasource`);
    an info's `self_wav` is the drum conditioner's waveform, and its
    `chords` and `melody` (`data.JascoInfo`) the symbolic conditions, null
    (index 0, zeros) where a batch has none, as in the JAX solver."""

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataloaders: tp.Dict[str, tp.Iterable] = (
            builders.get_audio_datasets(cfg, builders.DatasetType.MUSIC,
                                        self.device)
            if cfg.get("datasource") else {})
        self.epoch = 1
        seed = cfg.get("seed", 2036)
        if cfg.get("transformer_lm"):
            self.model = model_builders.get_jasco_model(cfg, device=self.device,
                                                        seed=seed)
        else:
            self.model = model_builders.get_debug_jasco_model(
                device=self.device, seed=seed).model
        self.compression_model = builders.compression_model_from_checkpoint(
            cfg.get("compression_model_checkpoint"), self.device)
        for cond in self.model.conditioners.values():
            if isinstance(cond, DrumsConditioner):
                bind_drums_codec(cond, self.compression_model)
        self.optimizer = torch.optim.AdamW(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=float((cfg.get("optim") or {}).get("lr", 1e-4)),
            weight_decay=1e-4)
        self._rng = torch.Generator(self.device).manual_seed(seed)

    @torch.no_grad()
    def get_latents(self, wav: torch.Tensor) -> torch.Tensor:
        """The codec encoder's unquantized latents of wav [B, C, T]:
        [B, frames, D]."""
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        return self.compression_model.encoder(wav).transpose(1, 2)

    def _tokenize_batch(self, wav, infos):
        """(latents, tokenized conditions) of a batch; rows without chords
        or melody get chord 0 and a zero salience over the latents' frames,
        rows without infos a null description."""
        latents = self.get_latents(wav)
        T = latents.shape[1]
        if infos is not None:
            attrs = [info.to_condition_attributes() for info in infos]
        else:
            attrs = [ConditioningAttributes(text={"description": None})
                     for _ in range(latents.shape[0])]
        conditioners = self.model.conditioners
        for a in attrs:
            if "chords" in conditioners and "chords" not in a.symbolic:
                a.symbolic["chords"] = SymbolicCondition(
                    frame_chords=np.zeros((T,), np.int32))
            if "melody" in conditioners and "melody" not in a.symbolic:
                a.symbolic["melody"] = SymbolicCondition(melody=np.zeros(
                    (conditioners["melody"].card, T), np.float32))
        provider = JascoConditioningProvider(conditioners, sequence_length=T)
        return latents, provider.tokenize(attrs)

    @staticmethod
    def _split(batch):
        if isinstance(batch, (tuple, list)):
            return batch[0], batch[1] if len(batch) > 1 else None
        return batch, None

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        """A train step in the 'train' stage; in another stage the loss
        without an update."""
        latents, tokenized = self._tokenize_batch(*self._split(batch))
        training = self.current_stage == "train"
        with torch.set_grad_enabled(training):
            loss = flow_matching_loss(self.model, latents, tokenized,
                                      self._rng)
        if training:
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            builders.fill_missing_grads(self.optimizer)
            self.optimizer.step()
        metrics["loss"] = loss.detach()
        return metrics

    @torch.no_grad()
    def evaluate(self) -> dict:
        """The vector field's MSE at t = 0.1, 0.5 and 0.9 (`t_low`, `t_mid`,
        `t_high`) averaged over the 'evaluate' loader's batches, and their
        mean as `loss` ({} without a loader)."""
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}
        totals: tp.Dict[str, float] = {}
        count = 0
        for batch in loader:
            latents, tokenized = self._tokenize_batch(*self._split(batch))
            for t_val, name in EVAL_BUCKETS.items():
                t = torch.full((latents.shape[0],), t_val,
                               dtype=latents.dtype, device=latents.device)
                mse = flow_matching_loss(self.model, latents, tokenized,
                                         self._rng, t=t)
                totals[name] = totals.get(name, 0.0) + float(mse)
            count += 1
        metrics = {k: v / max(count, 1) for k, v in totals.items()}
        metrics["loss"] = float(np.mean(list(metrics.values())))
        return distrib.average_metrics(metrics, count)

    @torch.no_grad()
    def generate(self) -> dict:
        """Samples for the descriptions of one batch of the 'generate'
        loader (else 'evaluate', else 'valid'; {} without one), generated
        by the model over the codec (`models.jasco.JASCO`) and stored by
        the sample manager with the batch as their references."""
        loader = (self.dataloaders.get("generate")
                  or self.dataloaders.get("evaluate")
                  or self.dataloaders.get("valid"))
        if loader is None:
            return {}
        manager = SampleManager(SimpleNamespace(folder=self._folder,
                                                cfg=self.cfg))
        segment = float((self.cfg.get("dataset", {}) or {}).get(
            "segment_duration") or 10.0)
        jasco = JASCO("solver-gen", self.compression_model, self.model,
                      max_duration=segment, device=self.device)
        n = 0
        try:
            for batch in loader:
                wav, infos = (batch if isinstance(batch, (tuple, list))
                              else (batch, None))
                descriptions = ([getattr(i, "description", None) or ""
                                 for i in infos] if infos is not None
                                else [""] * len(wav))
                gen = jasco.generate(descriptions)
                manager.add_samples(gen, self.epoch,
                                    conditioning=[{"description": d}
                                                  for d in descriptions],
                                    ground_truth_wavs=wav)
                n += gen.shape[0]
                break
        finally:
            self.model.train()
        logger.info("Generated %d JASCO samples under %s", n,
                    manager.base_folder)
        return {"generated_samples": n}

    # ------------------------------------------------------------ checkpoints
    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "rng": self._rng.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._rng.set_state(state["rng"])

    def load_model_weights(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])

    def load_jax_params(self, tree) -> None:
        jax_weights.load_flow_matching(self.model, tree)

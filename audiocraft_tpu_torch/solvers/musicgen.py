"""MusicGen LM training: cross-entropy over the delay pattern (counterpart of
`audiocraft_tpu/solvers/musicgen.py:40-388, 590-603`).

A train step runs the conditioners and the LM's `compute_predictions`
forward (under bf16 autocast when `transformer_lm.dtype` is bfloat16; the
parameters stay f32), takes the cross-entropy over the positions the pattern
predicts that are not padding, back-propagates, clips the gradients' global
norm and steps the optimizer. The conditioners run their eval forward in
training too, as the JAX package's provider calls them (a style
conditioner keeps its running statistics and codebooks). Two facts of the
JAX solver are kept as they are: it reads `lr_scheduler` from `optim`, where
the MusicGen config has none (its schedule sits under `schedule:`), so the
rate is constant; and it keeps no EMA of the weights whatever `optim.ema`
says. One is not: the JAX solver's 'valid' stage runs its train step, so
it trains on the validation data; here a stage other than 'train' only
evaluates.
"""
import contextlib
import logging
import typing as tp
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ..models import builders as model_builders
from ..models.lm import LMModel
from ..modules.conditioners import (AttributeDropout,
                                    ClassifierFreeGuidanceDropout,
                                    ConditioningAttributes)
from ..parallel import distrib
from ..parallel.mesh import batch_sharding, data_all_reduce
from ..utils import jax_weights, tracing
from ..utils.cache import CachedBatchLoader, CachedBatchWriter
from ..utils.samples.manager import SampleManager
from ..utils.utils import resolve_device, to_device
from . import builders
from .base import SolverRunMixin

logger = logging.getLogger(__name__)


def compute_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, mesh=None
                          ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """CE over the valid positions, per codebook. logits [B, K, T, card] (any
    float dtype; the softmax runs in f32), targets [B, K, T], mask [B, K, T].
    Returns (mean over codebooks, per-codebook CE [K]). Positions outside the
    mask are selected away (`torch.where`, not a product: their CE may be
    anything and must not reach the sum or its gradient); their targets,
    which may be the special token, are clamped into range first. With a
    `mesh` the rows are this rank's slice of the batch and the counts are
    the whole batch's: the result is this rank's share of the global CE,
    which the ranks' shares sum to."""
    B, K, T = targets.shape
    card = logits.shape[-1]
    ce_all = F.cross_entropy(logits.float().reshape(-1, card),
                             targets.clamp(0, card - 1).reshape(-1),
                             reduction="none").view(B, K, T)
    ce_sel = torch.where(mask, ce_all, torch.zeros_like(ce_all))
    counts = mask.sum(dim=(0, 2)).float()
    if mesh is not None:
        counts = data_all_reduce(counts, mesh)
    counts = counts.clamp_min(1.0)
    ce_per_codebook = ce_sel.sum(dim=(0, 2)) / counts
    return ce_per_codebook.mean(), ce_per_codebook


def mask_padding(codes: torch.Tensor, padding_mask: torch.Tensor,
                 special_token_id: int) -> torch.Tensor:
    """codes [B, K, T] with the padded frames (padding_mask [B, T] False)
    replaced by the special token."""
    return torch.where(padding_mask[:, None, :], codes,
                       torch.full_like(codes, special_token_id))


def apply_condition_dropout(attributes: tp.List[ConditioningAttributes],
                            cfg_dropout: tp.Optional[ClassifierFreeGuidanceDropout],
                            att_dropout: tp.Optional[AttributeDropout]
                            ) -> tp.List[ConditioningAttributes]:
    """Classifier-free-guidance dropout, then attribute dropout (host side,
    before tokenizing)."""
    if cfg_dropout is not None:
        attributes = cfg_dropout(attributes)
    if att_dropout is not None:
        attributes = att_dropout(attributes)
    return attributes


def make_optimizer(params, learning_rate: tp.Union[float, tp.Callable[[int], float]],
                   optimizer: str = "adamw", betas=(0.9, 0.95),
                   weight_decay: float = 0.1, eps: float = 1e-8,
                   max_norm: float = 1.0) -> builders.ClippedOptimizer:
    """AdamW (or Adam) with global-norm clipping; `learning_rate` is a rate
    or a schedule of the update count."""
    schedule = learning_rate if callable(learning_rate) else (
        lambda step: learning_rate)
    peak = float(schedule(0)) or 1.0  # LambdaLR scales the group's rate
    groups = [{"params": list(params), "lr": peak,
               "weight_decay": weight_decay}]
    opt = builders.make_torch_optimizer(groups, optimizer, peak, betas, eps,
                                        weight_decay)
    return builders.ClippedOptimizer(opt, [schedule], max_norm)


def _autocast(device: torch.device, dtype: tp.Optional[torch.dtype]):
    if dtype is None:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def _ce_metrics(ce: torch.Tensor, ce_q: torch.Tensor) -> dict:
    metrics = {"ce": ce.detach(), "ppl": torch.exp(ce.detach())}
    for k in range(ce_q.shape[0]):
        metrics[f"ce_q{k + 1}"] = ce_q[k].detach()
        metrics[f"ppl_q{k + 1}"] = torch.exp(ce_q[k].detach())
    return metrics


def train_step(model: LMModel, optimizer: builders.ClippedOptimizer,
               codes: torch.Tensor, tokenized: tp.Dict[str, tp.Any],
               dropout_seed: tp.Optional[int] = None,
               compute_dtype: tp.Optional[torch.dtype] = None,
               mesh=None) -> dict:
    """One update on codes [B, K, T] (padding already the special token).
    Returns 0-d device tensors: ce, ppl, grad_norm (before clipping), and
    ce_q{k}, ppl_q{k} per codebook; nothing here waits for the device.

    With a `mesh` (the model through `parallel.sharding.shard_lm`, the
    optimizer over its parameters) every rank passes the same global
    batch and runs its slice over ('dp', 'fsdp'); the loss is its share of
    the global CE, the gradients are summed over the data-like axes, and
    the metrics are the global batch's: the step computes the one-process
    step on the whole batch (the JAX package's `make_train_step(model,
    optimizer, mesh)`). Dropout draws its masks per rank's rows, so with
    dropout the two steps differ."""
    model.train()
    model.condition_provider.eval()
    rows = None if mesh is None else batch_sharding(mesh)
    on_card = codes.device.type == "cuda"
    with tracing.span("solver.forward", device=on_card), \
            _autocast(codes.device, compute_dtype):
        condition_tensors = model.compute_conditions(tokenized)
        if rows is not None:
            codes, condition_tensors = rows(codes), rows(condition_tensors)
        out = model.compute_predictions(codes, condition_tensors,
                                        dropout_seed=dropout_seed)
        mask = out.mask & (codes != model.special_token_id)
        ce, ce_q = compute_cross_entropy(out.logits, codes, mask, mesh)
    with tracing.span("solver.backward", device=on_card):
        optimizer.zero_grad()
        ce.backward()
    with tracing.span("solver.optimizer", device=on_card):
        grad_norm = optimizer.step()
    if mesh is not None:
        ce_q = data_all_reduce(ce_q.detach().clone(), mesh)
        ce = ce_q.mean()
    return {**_ce_metrics(ce, ce_q), "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(model: LMModel, codes: torch.Tensor,
              tokenized: tp.Dict[str, tp.Any],
              compute_dtype: tp.Optional[torch.dtype] = None) -> dict:
    """CE and perplexity without dropout or gradients: ce, ppl, ce_q{k}."""
    model.eval()
    with _autocast(codes.device, compute_dtype):
        condition_tensors = model.compute_conditions(tokenized)
        out = model.compute_predictions(codes, condition_tensors)
        mask = out.mask & (codes != model.special_token_id)
        ce, ce_q = compute_cross_entropy(out.logits, codes, mask)
    return {k: v for k, v in _ce_metrics(ce, ce_q).items()
            if not k.startswith("ppl_q")}


def _rng_state(rng: np.random.RandomState) -> dict:
    """A numpy RandomState's state as tensors and numbers (`torch.load`
    with `weights_only` reads it back)."""
    _, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": pos,
            "has_gauss": has_gauss, "cached_gaussian": cached}


def _set_rng_state(rng: np.random.RandomState, state: dict) -> None:
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32),
                   state["pos"], state["has_gauss"], state["cached_gaussian"]))


class MusicGenSolver(SolverRunMixin):
    """MusicGen LM training from a solver config dict: a frozen compression
    model (`compression_model_checkpoint`: a codec package's path, or the
    debug codec at the config's `sample_rate`, 32 or 16 kHz, for 'debug'
    or None; `builders.compression_model_from_checkpoint`), the LM (`get_lm_model`
    when the config has `transformer_lm`, else the debug LM), condition
    dropouts, and the optimizer. Runs on CUDA unless `device` names another.
    Loaders are built from `datasource` (`builders.get_audio_datasets`) or
    are iterables of batches placed in `self.dataloaders`; a batch is
    `(wav, infos)` or a precomputed dict with 'codes' and 'tokenized' (the
    batch cache of `cache.path` yields these). `run()` trains epochs
    with checkpoints (`solvers/base.py`); the checkpoint holds the LM, the
    optimizer and its schedule, the step, and the states of the solver's
    generators, so a resumed run takes the same steps as one that was not
    stopped."""
    DATASET_TYPE = "music"

    def __init__(self, cfg: dict, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dataset_type = builders.DatasetType(self.DATASET_TYPE)
        self.dataloaders: tp.Dict[str, tp.Iterable] = (
            builders.get_audio_datasets(cfg, dataset_type, self.device)
            if cfg.get("datasource") else {})
        seed = cfg.get("seed", 2036)

        self.compression_model = builders.compression_model_from_checkpoint(
            cfg.get("compression_model_checkpoint"), self.device,
            sample_rate=cfg.get("sample_rate", 32000))

        lm_cfg = cfg.get("transformer_lm") or {}
        if lm_cfg:
            self.model = model_builders.get_lm_model(cfg, device=self.device,
                                                     seed=seed)
        else:
            self.model = self._debug_lm(device=self.device, seed=seed)
        self.compute_dtype = (torch.bfloat16 if lm_cfg.get("dtype") == "bfloat16"
                              else None)

        cls_free = cfg.get("classifier_free_guidance", {}) or {}
        self.cfg_dropout = ClassifierFreeGuidanceDropout(
            p=cls_free.get("training_dropout", 0.0))
        self.att_dropout = AttributeDropout(p=cfg.get("attribute_dropout", {}))

        self.optimizer = self.new_optimizer()
        self._rng = torch.Generator().manual_seed(seed)
        self.epoch = 1

        # the batch cache: `cache.write` stores each train batch's codes,
        # tokenized conditions and padding mask; `cache.path` alone replays
        # them in place of the train loader, without the codec's encode
        self.cached_batch_writer: tp.Optional[CachedBatchWriter] = None
        self.cached_batch_loader: tp.Optional[CachedBatchLoader] = None
        cache_cfg = cfg.get("cache", {}) or {}
        if cache_cfg.get("path"):
            if cache_cfg.get("write"):
                self.cached_batch_writer = CachedBatchWriter(
                    Path(cache_cfg["path"]))
            else:
                self.cached_batch_loader = CachedBatchLoader(
                    Path(cache_cfg["path"]),
                    (cfg.get("dataset", {}) or {}).get("batch_size", 1),
                    num_workers=cache_cfg.get("num_workers", 4))
                self.dataloaders["original_train"] = \
                    self.dataloaders.get("train")
                self.dataloaders["train"] = self.cached_batch_loader

    _debug_lm = staticmethod(model_builders.get_debug_lm_model)

    def new_optimizer(self) -> builders.ClippedOptimizer:
        """The config's optimizer (groups, schedule, clipping) over the
        LM's parameters as they are now: a model that
        `parallel.sharding.shard_lm` re-stored needs a new one."""
        lm_cfg = self.cfg.get("transformer_lm") or {}
        optim_cfg = self.cfg.get("optim", {}) or {}
        total_updates = (optim_cfg.get("epochs", 1)
                         * optim_cfg.get("updates_per_epoch", 2000))
        overrides = {k: lm_cfg[k] for k in ("lr", "weight_decay")
                     if lm_cfg.get(k) is not None}
        params = builders.get_optim_parameter_groups(
            self.model, {"transformer": overrides})
        return builders.get_optimizer(params, optim_cfg, total_updates)

    def _next_dropout_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._rng))

    def _prepare_tokens_and_attributes(self, batch, training: bool = True):
        """(wav [B, C, T], infos) -> (codes [B, K, T'] with padding as the
        special token, tokenized conditions, padding mask [B, T'])."""
        wav, infos = batch
        codes, scale = self.compression_model.encode(
            to_device(torch.as_tensor(wav), self.device), device=self.device)
        assert scale is None, "Scaled compression model not supported with LM."
        attributes = [info.to_condition_attributes() for info in infos]
        if training:
            attributes = apply_condition_dropout(attributes, self.cfg_dropout,
                                                 self.att_dropout)
        tokenized = self.model.condition_provider.tokenize(attributes)
        lengths = np.array([info.n_frames for info in infos])
        frame_rate = self.compression_model.frame_rate
        valid_frames = np.ceil(lengths / (infos[0].sample_rate / frame_rate))
        T = codes.shape[-1]
        padding_mask = (torch.arange(T, device=self.device)[None, :]
                        < to_device(torch.from_numpy(valid_frames),
                                    self.device)[:, None])
        codes = mask_padding(codes, padding_mask, self.model.special_token_id)
        return codes, tokenized, padding_mask

    def _batch_codes(self, batch, training: bool = True):
        """(codes, tokenized, padding mask) of a (wav, infos) batch or of a
        precomputed dict (its padding mask, or None)."""
        with tracing.span("solver.batch"):
            if isinstance(batch, tuple) and len(batch) == 1 \
                    and isinstance(batch[0], dict):
                batch = batch[0]
            if isinstance(batch, dict) and "codes" in batch:
                padding = batch.get("padding_mask")
                return (torch.as_tensor(batch["codes"]).to(self.device),
                        batch["tokenized"],
                        None if padding is None
                        else torch.as_tensor(padding).to(self.device))
            codes, tokenized, padding = self._prepare_tokens_and_attributes(
                batch, training)
            if training and self.cached_batch_writer is not None:
                self.cached_batch_writer.save({"codes": codes,
                                               "tokenized": tokenized,
                                               "padding_mask": padding})
            return codes, tokenized, padding

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        """A train step in the 'train' stage; in another stage (valid) the
        CE without an update. Span `solver.step` (`utils.tracing`), the
        root of the step's `solver.batch` and `train_step`'s phases."""
        training = self.current_stage == "train"
        with tracing.span("solver.step", stage=self.current_stage, idx=idx):
            if training and idx == 0 and self.cached_batch_writer is not None:
                self.cached_batch_writer.start_epoch(self.epoch)
            codes, tokenized, _ = self._batch_codes(batch, training)
            if not training:
                metrics.update(eval_step(self.model, codes, tokenized,
                                         compute_dtype=self.compute_dtype))
                return metrics
            metrics.update(train_step(
                self.model, self.optimizer, codes, tokenized,
                dropout_seed=self._next_dropout_seed(),
                compute_dtype=self.compute_dtype))
        return metrics

    def run_epoch(self, split: str = "train", max_updates: int = 0) -> dict:
        return self._iter_split(split, max_updates)

    def evaluate(self) -> dict:
        """CE and perplexity averaged over the 'evaluate' loader's batches
        ({} without one), then the generative metrics that
        `evaluate.metrics` asks for."""
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}
        average: tp.Dict[str, float] = {}
        count = 0
        for batch in loader:
            codes, tokenized, _ = self._batch_codes(batch, training=False)
            step = eval_step(self.model, codes, tokenized,
                             compute_dtype=self.compute_dtype)
            count += 1
            for key, value in step.items():
                average[key] = average.get(key, 0.0) + float(value)
        metrics = {k: v / max(count, 1) for k, v in average.items()}
        gen_metrics, gen_weights = self.evaluate_audio_generation()
        metrics.update(gen_metrics)
        return distrib.average_metrics(metrics, count, weights=gen_weights)

    def evaluate_audio_generation(self) -> tp.Tuple[dict, dict]:
        """The generative metrics that `evaluate.metrics` asks for (FAD,
        KLD, CLAP text consistency, chroma cosine), over audio generated
        from the descriptions of the 'evaluate' loader's batches (at most
        `evaluate.max_generation_batches`). A metric is built only when
        asked for, on the solver's device; KLD and text consistency are
        skipped with a warning without their checkpoints, and FAD reports
        `fad_logmel` under its fallback. With `use_gt` a metric takes the
        reference through the codec instead of the generated audio (text
        consistency: the reference itself). Returns the metrics and their
        weights for `distrib.average_metrics`: a metric whose `compute`
        fails on this process (too few windows, an empty split) gets
        weight 0, so the key set stays the same on every process and the
        key drops out where no process had it."""
        evaluate_cfg = self.cfg.get("evaluate", {}) or {}
        asked = evaluate_cfg.get("metrics", {}) or {}
        m_cfg = self.cfg.get("metrics", {}) or {}
        fad = kldiv = textcons = chroma = None
        if asked.get("fad"):
            fad = builders.get_fad(m_cfg.get("fad", {}) or {}, self.device)
        if asked.get("kld"):
            kldiv = builders.get_kldiv(m_cfg.get("kld", {}) or {}, self.device)
            if kldiv is None:
                logger.warning("kld requested but no local PaSST checkpoint; "
                               "skipping")
        if asked.get("text_consistency"):
            textcons = builders.get_text_consistency(
                m_cfg.get("text_consistency", {}) or {}, self.device)
            if textcons is None:
                logger.warning("text_consistency requested but no local CLAP "
                               "checkpoint; skipping")
        if asked.get("chroma_cosine"):
            sub = dict(m_cfg.get("chroma_cosine", {}) or {})
            sub["chroma_base"] = dict(sub.get("chroma_base") or {})
            sub["chroma_base"].setdefault(
                "sample_rate", self.compression_model.sample_rate)
            chroma = builders.get_chroma_cosine_similarity(sub, self.device)
        if all(m is None for m in (fad, kldiv, textcons, chroma)):
            return {}, {}
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}, {}
        model = self._gen_model()
        sr = self.compression_model.sample_rate
        max_batches = evaluate_cfg.get("max_generation_batches")

        def use_gt(name: str) -> bool:
            return bool((m_cfg.get(name, {}) or {}).get("use_gt"))

        @torch.no_grad()
        def compressed_gt(ref: torch.Tensor) -> torch.Tensor:
            codes, scale = self.compression_model.encode(ref,
                                                         device=self.device)
            out = self.compression_model.decode(codes, scale,
                                                device=self.device)
            return out.float()[..., :ref.shape[-1]]

        for idx, (wav, infos) in enumerate(loader):
            if max_batches is not None and idx >= max_batches:
                break
            descriptions = [getattr(i, "description", None) or ""
                            for i in infos]
            ref = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
            gen = model.generate(descriptions).float()
            T = min(gen.shape[-1], ref.shape[-1])
            gen, ref = gen[..., :T], ref[..., :T]
            sizes = np.minimum(np.asarray([getattr(i, "n_frames", T)
                                           for i in infos]), T)
            rates = np.full((gen.shape[0],), sr)
            if fad is not None:
                fad.update(compressed_gt(ref) if use_gt("fad") else gen, ref,
                           sizes, rates)
            if kldiv is not None:
                kldiv.update(compressed_gt(ref) if use_gt("kld") else gen, ref,
                             sizes, rates)
            if textcons is not None:
                textcons.update(ref if use_gt("text_consistency") else gen,
                                descriptions, sizes, rates)
            if chroma is not None:
                chroma.update(compressed_gt(ref) if use_gt("chroma_cosine")
                              else gen, ref, sizes, rates)

        results: tp.Dict[str, float] = {}
        weights: tp.Dict[str, float] = {}

        def emit(keys: tp.List[str],
                 compute: tp.Callable[[], tp.Dict[str, float]]):
            try:
                values = compute()
            except (AssertionError, ValueError) as exc:
                logger.warning("generative metric %s incomplete on this "
                               "process: %s", "/".join(keys), exc)
                values = {k: 0.0 for k in keys}
                weights.update({k: 0.0 for k in keys})
            else:
                weights.update({k: 1.0 for k in keys})
            results.update({k: float(v) for k, v in values.items()})

        if fad is not None:
            key = "fad" if fad.embed_kind != "logmel-fallback" else "fad_logmel"
            emit([key], lambda: {key: fad.compute()})
        if kldiv is not None:
            emit(["kld", "kld_pq", "kld_qp", "kld_both"], kldiv.compute)
        if textcons is not None:
            emit(["text_consistency"],
                 lambda: {"text_consistency": textcons.compute()})
        if chroma is not None:
            emit(["chroma_cosine"],
                 lambda: {"chroma_cosine": chroma.compute()})
        return results, weights

    def _gen_model(self):
        """The generation API over the solver's LM and codec, with the
        `generate.lm` settings: `gen_duration` (default the segment, at
        most 10 s), sampling, top-k/p, temperature, CFG coefficient."""
        from ..models.lm_magnet import MagnetLMModel
        from ..models.magnet import MAGNeT
        from ..models.musicgen import MusicGen
        segment = float((self.cfg.get("dataset", {}) or {}).get(
            "segment_duration") or 10.0)
        gen_cfg = dict(((self.cfg.get("generate", {}) or {}).get("lm", {})
                        or {}))
        duration = float(gen_cfg.get("gen_duration") or min(segment, 10.0))
        sampling = {k: v for k, v in gen_cfg.items()
                    if k in ("use_sampling", "top_k", "top_p", "temperature")}
        if isinstance(self.model, MagnetLMModel):
            # MAGNeT's masked decoding (the JAX solver decodes its MAGNeT LM
            # autoregressively through the MusicGen wrapper; ROADMAP §3)
            model = MAGNeT("solver-gen", self.compression_model, self.model,
                           max_duration=segment, device=self.device)
            model.set_generation_params(duration=duration, **sampling)
            return model
        model = MusicGen("solver-gen", self.compression_model, self.model,
                         max_duration=segment, device=self.device)
        model.set_generation_params(
            duration=duration, extend_stride=min(18, segment / 2),
            cfg_coef=gen_cfg.get("cfg_coef", 3.0), **sampling)
        return model

    def generate(self) -> dict:
        """Samples for the descriptions of the 'generate' loader (else
        'evaluate', else 'valid'; {} without one), stored by the sample
        manager under the experiment's folder with the batch as their
        references: unprompted (`generate.lm.unprompted_samples`, default
        on) and continuing the batch's first `prompt_duration` seconds
        (`prompted_samples`), until `generate.lm.num_samples` (default one
        batch). The first four unprompted samples also go to the
        writers."""
        loader = (self.dataloaders.get("generate")
                  or self.dataloaders.get("evaluate")
                  or self.dataloaders.get("valid"))
        if loader is None:
            return {}
        manager = SampleManager(SimpleNamespace(folder=self._folder,
                                                cfg=self.cfg))
        gen_cfg = ((self.cfg.get("generate", {}) or {}).get("lm", {}) or {})
        model = self._gen_model()
        sample_rate = self.compression_model.sample_rate
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.epoch)
        done = 0
        for wav, infos in loader:
            descriptions = [getattr(i, "description", None) or ""
                            for i in infos]
            conditions = [{"description": d} for d in descriptions]
            if gen_cfg.get("unprompted_samples", True):
                gen = model.generate(descriptions)
                manager.add_samples(gen, self.epoch, conditioning=conditions,
                                    ground_truth_wavs=wav)
                for i, sample in enumerate(gen[:4]):
                    self.writers.write_audio(f"generate/sample_{done + i}",
                                             sample, sample_rate, self.epoch)
            if gen_cfg.get("prompted_samples", False):
                prompt_duration = float(gen_cfg.get("prompt_duration")
                                        or model.duration / 4)
                prompt = torch.as_tensor(wav)[..., :int(prompt_duration
                                                        * sample_rate)]
                gen = model.generate_continuation(prompt, sample_rate,
                                                  descriptions)
                manager.add_samples(gen, self.epoch, conditioning=conditions,
                                    prompt_wavs=prompt)
            done += len(infos)
            if done >= int(gen_cfg.get("num_samples", len(infos))):
                break
        logger.info("Generated %d samples under %s", done,
                    manager.base_folder)
        return {"generated_samples": done}

    # ------------------------------------------------------------ checkpoints
    def _rng_states(self) -> dict:
        return {"dropout": self._rng.get_state(),
                "cfg_dropout": _rng_state(self.cfg_dropout.rng),
                "att_dropout": _rng_state(self.att_dropout.rng)}

    def _set_rng_states(self, states: dict) -> None:
        self._rng.set_state(states["dropout"])
        _set_rng_state(self.cfg_dropout.rng, states["cfg_dropout"])
        _set_rng_state(self.att_dropout.rng, states["att_dropout"])

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.optimizer.state_dict(),
                "lr_scheduler": self.optimizer.scheduler.state_dict(),
                "step": self.optimizer.scheduler.last_epoch,
                "rng": self._rng_states()}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.optimizer.load_state_dict(state["optimizer"])
        self.optimizer.scheduler.load_state_dict(state["lr_scheduler"])
        self._set_rng_states(state["rng"])

    def load_model_weights(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])

    def load_jax_params(self, tree) -> None:
        jax_weights.load_lm(self.model, tree)

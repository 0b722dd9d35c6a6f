"""MAGNeT training: a masked-token cross-entropy on one codebook stage per
step (counterpart of `audiocraft_tpu/solvers/magnet.py`).

A step draws its stage, and per row a mask rate from the cosine schedule
(cos(u * pi / 2), u uniform); masks that share of the stage's steps, in
spans of `masking.span_len` whose count comes from the look-up table of
`calc_mean_maskrate_to_u_LUT` (or single steps when the span is 1); puts
the mask token there and in every later stage; and takes the CE of the
stage's logits at its masked, unpadded steps. Stages after the first attend
through `MagnetLMModel.stage_attn_bias`. The mask is drawn on the host from
a numpy RandomState seeded by the config, as in the JAX package. The JAX
solver draws the stage from Python's unseeded `random.randint`; here it
comes from the solver's seeded generator. `masked_step` takes a stage and a
mask as given, for the tests and for `evaluate`, which scores every stage
of each batch with masks from its own RandomState (seeded anew at each
call, so evaluation is deterministic and leaves the training draws as
they were).
"""
import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from ..models import builders as model_builders
from ..parallel import distrib
from .musicgen import (MusicGenSolver, _autocast, _rng_state, _set_rng_state)


def calc_mean_maskrate_to_u_LUT(T: int, L: int) -> np.ndarray:
    """[101]: for each mask percentage, the number u of span starts (spans
    of L over T steps) whose expected masked share reaches it. The share
    of u random starts is 1 - C(T - L, u) / C(T, u), built as a running
    product so that it does not overflow."""
    u2mean = [0.0]
    v = (T - L) / float(T)
    for u in range(1, T):
        u2mean.append(1 - v)
        v *= (T - L - u) / (T - u)
    return np.array([int(np.searchsorted(u2mean, percent / 100.0))
                     for percent in range(101)])


def non_spans_mask(rng: np.random.RandomState, mask_probs: np.ndarray,
                   B: int, T: int) -> np.ndarray:
    """[B, T] bool: round(T * p) random steps per row (at least one)."""
    num_masked = np.clip(np.round(T * mask_probs), 1, None)
    order = rng.rand(B, T).argsort(axis=-1)
    return order < num_masked[:, None]


def spans_mask(rng: np.random.RandomState, mask_probs: np.ndarray, B: int,
               T: int, span_len: int, lut: np.ndarray) -> np.ndarray:
    """[B, T] bool: per row, lut[round(100 p)] random span starts (at least
    one), each masking `span_len` steps from its start."""
    starts = np.clip(lut[np.round(100 * mask_probs).astype(np.int64)], 1, None)
    order = rng.rand(B, T).argsort(axis=-1)
    mask = order < starts[:, None]
    shifted = mask.copy()
    for _ in range(span_len - 1):
        shifted = np.concatenate([np.zeros((B, 1), bool), shifted[:, :-1]],
                                 axis=1)
        mask = mask | shifted
    return mask


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over the True steps of `mask` [B, T]; logits [B, T, card]
    (softmax in f32), targets [B, T]."""
    card = logits.shape[-1]
    ce = F.cross_entropy(logits.float().reshape(-1, card),
                         targets.clamp(0, card - 1).reshape(-1),
                         reduction="none").view(mask.shape)
    ce = torch.where(mask, ce, torch.zeros_like(ce))
    return ce.sum() / mask.sum().float().clamp_min(1.0)


class MagnetSolver(MusicGenSolver):
    """MAGNeT LM training (`solver/magnet/magnet_32khz`); without
    `transformer_lm` in the config, the debug MAGNeT LM."""
    DATASET_TYPE = "music"
    _debug_lm = staticmethod(model_builders.get_debug_magnet_lm_model)

    def __init__(self, cfg: dict, device=None):
        super().__init__(cfg, device=device)
        self.span_len = (cfg.get("masking", {}) or {}).get("span_len", 3)
        self._mask_rng = np.random.RandomState(cfg.get("seed", 2036))
        self._luts: tp.Dict[int, np.ndarray] = {}

    def _get_mask(self, rng: np.random.RandomState, mask_probs: np.ndarray,
                  B: int, T: int) -> np.ndarray:
        if self.span_len <= 1:
            return non_spans_mask(rng, mask_probs, B, T)
        if T not in self._luts:
            self._luts[T] = calc_mean_maskrate_to_u_LUT(T, self.span_len)
        return spans_mask(rng, mask_probs, B, T, self.span_len, self._luts[T])

    def _draw_mask(self, rng: np.random.RandomState, B: int, T: int
                   ) -> np.ndarray:
        probs = np.cos(rng.uniform(0, 1, size=(B,)) * math.pi * 0.5)
        return self._get_mask(rng, probs, B, T)

    def masked_step(self, codes: torch.Tensor, tokenized: dict,
                    padding_mask: tp.Optional[torch.Tensor], stage: int,
                    stage_mask: np.ndarray, training: bool = True) -> dict:
        """One update (or, with `training=False`, the CE alone) on codes
        [B, K, T] for `stage` with `stage_mask` [B, T] (bool): the masked
        steps of the stage and every step of later stages become the mask
        token; the CE is taken at the stage's masked steps inside
        `padding_mask` [B, T] (None: all)."""
        model = self.model
        B, K, T = codes.shape
        stage_mask = torch.as_tensor(stage_mask, device=codes.device)
        mask = torch.zeros(B, K, T, dtype=torch.bool, device=codes.device)
        mask[:, stage] = stage_mask
        mask[:, stage + 1:] = True
        inputs = torch.where(mask, torch.full_like(codes, model.special_token_id),
                             codes)
        loss_mask = stage_mask
        if padding_mask is not None:
            loss_mask = loss_mask & padding_mask.bool()
        S = len(model.pattern_provider.get_pattern(T).valid_layout)
        bias = model.stage_attn_bias(stage, S, device=codes.device)
        model.train(training)
        model.condition_provider.eval()
        with torch.set_grad_enabled(training), \
                _autocast(codes.device, self.compute_dtype):
            condition_tensors = model.compute_conditions(tokenized)
            out = model.compute_predictions(
                inputs, condition_tensors, attn_bias=bias,
                dropout_seed=self._next_dropout_seed() if training else None)
            ce = masked_cross_entropy(out.logits[:, stage], codes[:, stage],
                                      loss_mask)
        metrics = {"ce": ce.detach(), "ppl": torch.exp(ce.detach())}
        if training:
            self.optimizer.zero_grad()
            ce.backward()
            metrics["grad_norm"] = self.optimizer.step()
        return metrics

    def run_step(self, idx: int, batch, metrics: dict) -> dict:
        training = self.current_stage == "train"
        codes, tokenized, padding_mask = self._batch_codes(batch, training)
        B, K, T = codes.shape
        stage = int(torch.randint(0, K, (1,), generator=self._rng))
        stage_mask = self._draw_mask(self._mask_rng, B, T)
        metrics.update(self.masked_step(codes, tokenized, padding_mask, stage,
                                        stage_mask, training=training))
        return metrics

    def evaluate(self) -> dict:
        """CE averaged over every stage of every batch of the 'evaluate'
        loader ({} without one), and its perplexity."""
        loader = self.dataloaders.get("evaluate")
        if loader is None:
            return {}
        rng = np.random.RandomState(self.cfg.get("seed", 2036))
        ce_sum, n = 0.0, 0
        for batch in loader:
            codes, tokenized, padding_mask = self._batch_codes(
                batch, training=False)
            B, K, T = codes.shape
            for stage in range(K):
                m = self.masked_step(codes, tokenized, padding_mask, stage,
                                     self._draw_mask(rng, B, T),
                                     training=False)
                ce_sum += float(m["ce"])
                n += 1
        # average the CE over the processes first, then take its
        # perplexity: the mean of exp(ce) would differ from exp(mean ce)
        metrics = distrib.average_metrics({"ce": ce_sum / max(n, 1)}, n)
        if "ce" in metrics:
            metrics["ppl"] = math.exp(metrics["ce"])
        return metrics

    def _rng_states(self) -> dict:
        return {**super()._rng_states(), "mask": _rng_state(self._mask_rng)}

    def _set_rng_states(self, states: dict) -> None:
        super()._set_rng_states(states)
        _set_rng_state(self._mask_rng, states["mask"])


class AudioMagnetSolver(MagnetSolver):
    """MAGNeT over sound (`solver/magnet/audio_magnet_16khz`)."""
    DATASET_TYPE = "sound"

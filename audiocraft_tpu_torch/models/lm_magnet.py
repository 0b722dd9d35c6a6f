"""MAGNeT: the non-autoregressive masked-token LM over parallel code streams
(counterpart of `audiocraft_tpu/models/lm_magnet.py`).

Each stream (stage) is decoded in its own iterative loop: at every step the
least probable tokens or spans are masked again, one forward of the whole
sequence predicts them, and the sampled tokens replace the masked ones.
The mask count follows a cosine schedule; the CFG coefficient anneals from
`max_cfg_coef` to `min_cfg_coef` and the temperature to 0. Stages after the
first attend only to a window of +-`subcodes_context` steps
(`restricted_context_attn_bias`, an f32 bias of 0 or f32's minimum).

Two mask arrangements: `nonoverlap` masks whole chunks of `span_len`
steps (the sequence is cut to a multiple of the span) and keeps masking,
sampling and scoring on the device, with no host read inside a stage, as
the JAX package's one scan per stage; on the card a stage's step is
captured once into a CUDA graph and replayed (`_replay_decode_steps` of
`models/lm.py`, shared with the LM's decode). `stride1` masks the least
probable overlapping spans, found by a binary search over the span count
on the host after each step, as the JAX package does. Ties in the scores (every
score of the first step, and every `DONT_REMASK_ME_SCORE`) are broken by a
stable sort, as `jnp.argsort`.

MAGNeT's self-attention is non-causal and may carry a bias, so it runs the
plain attention (`ops/attention.dot_product_attention`, f32 logits); no
decode-attention kernel runs here, in either package.
"""
import math
import typing as tp

import numpy as np
import torch

from ..modules.conditioners import ConditioningAttributes
from ..utils.utils import (check_module_device, multinomial, resolve_device,
                           sample_top_k, sample_top_p)
from . import lm as lm_module
from .lm import ConditionTensors, LMModel

DONT_REMASK_ME_SCORE = -1e4


def _construct_spans_mask(span_starts: np.ndarray, T: int,
                          span_len: int) -> np.ndarray:
    """[T] bool: the spans of `span_len` steps starting at `span_starts`."""
    mask = np.zeros(T, dtype=bool)
    mask[span_starts] = True
    shifted = mask.copy()
    for _ in range(span_len - 1):
        shifted = np.concatenate(([False], shifted[:-1]))
        mask = mask | shifted
    return mask


def least_probable_span_masking(scores: np.ndarray, num_masked_trg: int,
                                span_len: int) -> np.ndarray:
    """[T] bool mask of the least probable stride-1 spans (scores [T], the
    higher the less probable), their count found by a binary search so that
    the masked steps come closest to `num_masked_trg`. numpy's default sort,
    as in the JAX package, so ties fall alike."""
    T = scores.shape[-1]
    windows = np.lib.stride_tricks.sliding_window_view(scores, span_len)
    spans_by_scores = np.argsort(-windows.sum(axis=-1))
    num_masked_trg = max(num_masked_trg, span_len)
    min_u = num_masked_trg // span_len
    max_u = num_masked_trg - span_len + 1
    mid = round(0.5 * (min_u + max_u))
    if mid == min_u or mid == max_u:
        return _construct_spans_mask(spans_by_scores[:mid], T, span_len)
    while min_u < mid < max_u:
        mask = _construct_spans_mask(spans_by_scores[:mid], T, span_len)
        if mask.sum() > num_masked_trg:
            max_u = mid
        else:
            min_u = mid
        mid = round(0.5 * (min_u + max_u))
    return mask


class MagnetLMModel(LMModel):
    """An `LMModel` decoded non-autoregressively (`generate`)."""

    def __init__(self, *args, subcodes_context: int = 5,
                 compression_model_framerate: int = 50,
                 segment_duration: int = 10, span_len: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.subcodes_context = subcodes_context
        self.compression_model_framerate = compression_model_framerate
        self.segment_duration = segment_duration
        self.span_len = span_len

    def restricted_context_attn_bias(self, seq_len: int,
                                     device=None) -> torch.Tensor:
        """f32 [T, T]: 0 where |i - j| <= subcodes_context, else f32's
        minimum."""
        pos = torch.arange(seq_len, device=device)
        valid = (pos[:, None] - pos[None, :]).abs() <= self.subcodes_context
        return torch.where(valid, 0.0, torch.finfo(torch.float32).min).to(
            torch.float32)

    def stage_attn_bias(self, stage: int, seq_len: int,
                        device=None) -> tp.Optional[torch.Tensor]:
        """The restricted bias for stages after the first; None (no bias)
        for the first."""
        if stage > 0 and self.subcodes_context > -1:
            return self.restricted_context_attn_bias(seq_len, device)
        return None

    def _sample_stage(self, gen_sequence: torch.Tensor,
                      condition_tensors: ConditionTensors, stage: int,
                      attn_bias: tp.Optional[torch.Tensor],
                      cfg_coef: torch.Tensor, temp: torch.Tensor,
                      use_sampling: bool, top_k: int, top_p: float,
                      generator: tp.Optional[torch.Generator]
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """One forward of the whole sequence (with the null rows under
        CFG), the stage's tokens sampled: (tokens [B, T], their
        probabilities [B, T]). `cfg_coef` and `temp` (already floored at
        0.01) are f32 tensors of one element on the model's device."""
        B = gen_sequence.shape[0]
        seq = (torch.cat([gen_sequence, gen_sequence]) if condition_tensors
               else gen_sequence)
        logits = self(seq, condition_tensors, attn_bias=attn_bias)
        if condition_tensors:
            cond, uncond = logits[:B], logits[B:]
            logits = uncond + (cond - uncond) * cfg_coef
        logits = logits[:, stage]                            # [B, T, card]
        probs = torch.softmax(logits.float() / temp, dim=-1)
        if not use_sampling:
            sampled = logits.argmax(dim=-1, keepdim=True)
        elif top_p > 0.0:
            sampled = sample_top_p(probs, top_p, generator)
        elif top_k > 0:
            sampled = sample_top_k(probs, top_k, generator)
        else:
            sampled = multinomial(probs, generator)
        return sampled[..., 0], probs.gather(-1, sampled)[..., 0]

    @torch.no_grad()
    def generate(self, prompt: tp.Optional[torch.Tensor] = None,
                 conditions: tp.Sequence[ConditioningAttributes] = (),
                 condition_tensors: tp.Optional[ConditionTensors] = None,
                 num_samples: tp.Optional[int] = None, max_gen_len: int = 256,
                 use_sampling: bool = True, temp: float = 3.0, top_k: int = 0,
                 top_p: float = 0.9, max_cfg_coef: float = 10.0,
                 min_cfg_coef: float = 1.0,
                 decoding_steps: tp.Sequence[int] = (20, 10, 10, 10),
                 anneal_temp: bool = True, span_scoring: str = "max",
                 span_arrangement: str = "nonoverlap",
                 callback: tp.Optional[tp.Callable[[int, int], None]] = None,
                 generator: tp.Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
        """Codes [B, K, T] with the prompt [B, K, T_prompt] kept: T is
        `max_gen_len`, cut to a multiple of `span_len` under `nonoverlap`.
        `condition_tensors`, when given, holds the conditional and the null
        rows; `callback(steps done, total steps)` runs after each stage.
        The model must be on `device` (CUDA unless the caller names
        another). On the card a `nonoverlap` stage runs its first step
        eagerly, then replays one CUDA graph of the step."""
        if span_arrangement not in ("nonoverlap", "stride1"):
            raise ValueError(f"unknown span arrangement {span_arrangement!r}")
        if span_scoring not in ("max", "prod"):
            raise ValueError(f"unknown span scoring {span_scoring!r}")
        device = resolve_device(device)
        check_module_device(self, device)
        conditions = list(conditions)
        if num_samples is None:
            num_samples = (prompt.shape[0] if prompt is not None
                           else len(conditions) if conditions else 1)
        if condition_tensors is None:
            condition_tensors = self.prepare_cfg_conditions(conditions)
        K, mask_id = self.n_q, self.special_token_id
        if prompt is None:
            prompt = torch.zeros(num_samples, K, 0, dtype=torch.long)
        B, _, prompt_length = prompt.shape
        assert prompt_length < max_gen_len
        prompt = prompt.to(device)
        T = max_gen_len
        chunk_masking = self.span_len > 1 and span_arrangement == "nonoverlap"
        if chunk_masking:
            T = self.span_len * (T // self.span_len)
        gen_sequence = torch.full((B, K, T), mask_id, dtype=torch.long,
                                  device=device)
        gen_sequence[..., :prompt_length] = prompt
        sample = dict(condition_tensors=condition_tensors,
                      use_sampling=use_sampling, top_k=top_k, top_p=top_p,
                      generator=generator)
        schedule = dict(max_cfg_coef=max_cfg_coef, min_cfg_coef=min_cfg_coef,
                        temp=temp, anneal_temp=anneal_temp)
        lps = span_arrangement == "stride1" and self.span_len > 1
        total, done = sum(decoding_steps), 0
        for stage, n_steps in zip(range(self.n_q), decoding_steps):
            bias = self.stage_attn_bias(stage, T, device)
            if lps:
                self._stride1_stage(gen_sequence, prompt, stage, n_steps, bias,
                                    schedule, sample)
            else:
                self._device_stage(gen_sequence, prompt, stage, n_steps, bias,
                                   schedule, sample,
                                   self.span_len if chunk_masking else 1,
                                   span_scoring)
            done += n_steps
            if callback is not None:
                callback(done, total)
        return gen_sequence

    def _device_stage(self, gen_sequence, prompt, stage, n_steps, bias,
                      schedule, sample, span, span_scoring) -> None:
        """One stage with masking and scoring on the device: each step
        masks the highest-scored chunks of `span` steps (tokens, with a
        span of 1), samples, and scores the chunks it sampled; the others
        keep `DONT_REMASK_ME_SCORE`. The step reads its mask count, CFG
        coefficient and temperature at a device step index and updates its
        state in place, so the card replays it as one CUDA graph."""
        B, _, T = gen_sequence.shape
        device, mask_id = gen_sequence.device, self.special_token_id
        prompt_length = prompt.shape[-1]
        n_scored = T // span
        n_prompt = prompt_length // span
        mask_ps = np.cos(np.linspace(0, 1, n_steps) * np.pi * 0.5)
        steps_left = np.arange(n_steps - 1, -1, -1)
        temps = (schedule["temp"] * steps_left / n_steps
                 if schedule["anneal_temp"]
                 else np.full(n_steps, schedule["temp"])).astype(np.float32)
        table = {name: torch.from_numpy(values).to(device) for name, values in {
            "masked": np.maximum((mask_ps * (n_scored - n_prompt)).astype(
                np.int32), 1),
            "cfg": (mask_ps * schedule["max_cfg_coef"]
                    + (1 - mask_ps) * schedule["min_cfg_coef"]).astype(
                np.float32),
            "temp": np.maximum(temps, np.float32(1e-2))}.items()}
        i = torch.zeros(1, dtype=torch.long, device=device)
        ranks = torch.arange(n_scored, device=device).expand(B, n_scored)
        scores = torch.zeros(B, n_scored, device=device)
        scores[:, :n_prompt] = DONT_REMASK_ME_SCORE
        stage_seq = torch.full((B, T), mask_id, dtype=torch.long,
                               device=device)

        def step() -> None:
            order = torch.argsort(-scores, dim=-1, stable=True)
            selected = torch.zeros(B, n_scored, dtype=torch.bool,
                                   device=device).scatter_(
                1, order, ranks < table["masked"].index_select(0, i))
            token_mask = (selected.repeat_interleave(span, dim=-1)
                          if span > 1 else selected)
            stage_seq.masked_fill_(token_mask, mask_id)
            stage_seq[:, :prompt_length] = prompt[:, stage]
            gen_sequence[:, stage] = stage_seq
            sampled, probs = self._sample_stage(
                gen_sequence, stage=stage, attn_bias=bias,
                cfg_coef=table["cfg"].index_select(0, i),
                temp=table["temp"].index_select(0, i), **sample)
            masked = stage_seq == mask_id
            stage_seq.copy_(torch.where(masked, sampled, stage_seq))
            gen_sequence[:, stage] = stage_seq
            if span == 1:
                new, kept = -torch.log(probs.clamp_min(1e-20)), masked
            elif span_scoring == "max":
                new = 1.0 - probs.reshape(B, n_scored, span).amax(dim=-1)
                kept = selected
            else:
                new = (-torch.log(probs.clamp_min(1e-20))).reshape(
                    B, n_scored, span).sum(dim=-1)
                kept = selected
            scores.copy_(new.masked_fill(~kept, DONT_REMASK_ME_SCORE))
            i.add_(1)

        if device.type == "cuda":
            lm_module._replay_decode_steps(step, n_steps, device,
                                           sample["generator"])
        else:
            for _ in range(n_steps):
                step()

    def _stride1_stage(self, gen_sequence, prompt, stage, n_steps, bias,
                       schedule, sample) -> None:
        """One stage with the least probable stride-1 spans masked: the
        scores come to the host after each step for the binary search."""
        B, _, T = gen_sequence.shape
        device, mask_id = gen_sequence.device, self.special_token_id
        prompt_length = prompt.shape[-1]
        stage_seq = np.full((B, T), mask_id, dtype=np.int64)
        prompt_np = prompt[:, stage].cpu().numpy()
        scores = np.zeros((B, T), np.float32)
        scores[:, :prompt_length] = DONT_REMASK_ME_SCORE
        num_to_gen = T - prompt_length
        timesteps = np.linspace(0, 1, n_steps)
        for timestep, steps_left in zip(timesteps, reversed(range(n_steps))):
            mask_p = math.cos(timestep * math.pi * 0.5)
            num_masked = max(int(mask_p * num_to_gen), 1)
            mask = np.stack([least_probable_span_masking(
                scores[i], num_masked, self.span_len) for i in range(B)])
            stage_seq[mask] = mask_id
            stage_seq[:, :prompt_length] = prompt_np
            gen_sequence[:, stage] = torch.from_numpy(stage_seq).to(device)
            cfg_coef = (float(mask_p) * schedule["max_cfg_coef"]
                        + (1 - float(mask_p)) * schedule["min_cfg_coef"])
            t = (schedule["temp"] * (steps_left / n_steps)
                 if schedule["anneal_temp"] else schedule["temp"])
            sampled, probs = self._sample_stage(
                gen_sequence, stage=stage, attn_bias=bias,
                cfg_coef=torch.tensor([round(cfg_coef, 6)], device=device),
                temp=torch.tensor([max(round(t, 6), 1e-2)], device=device),
                **sample)
            sampled, probs = sampled.cpu().numpy(), probs.cpu().numpy()
            masked = stage_seq == mask_id
            stage_seq = np.where(masked, sampled, stage_seq)
            gen_sequence[:, stage] = torch.from_numpy(stage_seq).to(device)
            scores = -np.log(np.maximum(probs, 1e-20))
            scores = np.where(~masked, DONT_REMASK_ME_SCORE, scores)

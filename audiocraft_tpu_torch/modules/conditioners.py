"""Text conditioning: attributes, tokenizers, conditioners, provider, fuser,
and the classifier-free-guidance and attribute dropouts (the parts of
`audiocraft_tpu/modules/conditioners.py` that text-to-music needs).

Tokenizing is host-side numpy; `ConditioningProvider.forward` is the only
device step and returns `(embedding [B, T, D], mask [B, T])` per attribute.
The T5 conditioner tokenizes with the hash-trick whitespace tokenizer, as the
JAX package does when no sentencepiece vocabulary is on disk.
"""
import dataclasses
import re
import typing as tp
from collections import defaultdict
from copy import deepcopy

import numpy as np
import torch
import torch.nn as nn

from ..utils.utils import hash_trick, length_to_mask
from .t5 import T5Encoder, T5EncoderConfig

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class ConditioningAttributes:
    """Per-sample conditions. Only text conditions are consumed; `wav` holds
    the waveform conditions a dataset attaches (None here: waveform
    conditioning is not ported, ROADMAP slice C)."""
    text: tp.Dict[str, tp.Optional[str]] = dataclasses.field(default_factory=dict)
    wav: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)


class WhiteSpaceTokenizer:
    """Hash-trick whitespace tokenizer: lowercase, strip ?:!.,; and hash
    each word into `n_bins`; an empty or missing text is one pad token with
    length 0."""
    PUNCTUATION = "?:!.,;"

    def __init__(self, n_bins: int, pad_idx: int = 0):
        self.n_bins = n_bins
        self.pad_idx = pad_idx

    def __call__(self, texts: tp.List[tp.Optional[str]]
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
        output, lengths = [], []
        for text in texts:
            if text is None:
                output.append([self.pad_idx])
                lengths.append(0)
                continue
            text = re.sub(f"[{re.escape(self.PUNCTUATION)}]", "", text.lower())
            words = text.split()
            lengths.append(len(words))
            output.append([hash_trick(w, self.n_bins) for w in words]
                          or [self.pad_idx])
        mask = length_to_mask(np.array(lengths))
        padded = np.full((len(output), mask.shape[1]), self.pad_idx,
                         dtype=np.int32)
        for i, toks in enumerate(output):
            padded[i, :len(toks)] = toks[:mask.shape[1]]
        return padded, mask


class NoopTokenizer:
    """One token per whole text: the hash of the string into `n_bins`; a
    missing text is the pad token with length 0. Returns tokens [B, 1] and
    the mask [B, 1]."""

    def __init__(self, n_bins: int, pad_idx: int = 0):
        self.n_bins = n_bins
        self.pad_idx = pad_idx

    def __call__(self, texts: tp.List[tp.Optional[str]]
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
        tokens = [self.pad_idx if text is None
                  else hash_trick(text, self.n_bins) for text in texts]
        lengths = [0 if text is None else 1 for text in texts]
        return (np.array(tokens, dtype=np.int32)[:, None],
                length_to_mask(np.array(lengths)))


TOKENIZERS = {"whitespace": WhiteSpaceTokenizer, "noop": NoopTokenizer}


class BaseConditioner(nn.Module):
    """Host `tokenize` + device `forward`, with an output projection."""

    def __init__(self, dim: int, output_dim: int, device=None, dtype=None):
        super().__init__()
        self.output_proj = nn.Linear(dim, output_dim, device=device, dtype=dtype)

    def _to_device(self, inputs) -> ConditionType:
        tokens, mask = inputs
        device = self.output_proj.weight.device
        return (torch.as_tensor(tokens, dtype=torch.long, device=device),
                torch.as_tensor(mask, dtype=torch.int32, device=device))

    def _masked(self, embeds: torch.Tensor, mask: torch.Tensor) -> ConditionType:
        return embeds * mask[..., None].to(embeds.dtype), mask


class LUTConditioner(BaseConditioner):
    """Lookup-table text conditioner over the whitespace tokenizer (a token
    per word) or the noop one (a token per text)."""

    def __init__(self, n_bins: int, dim: int, output_dim: int,
                 pad_idx: int = 0, tokenizer: str = "whitespace",
                 device=None, dtype=None):
        super().__init__(dim, output_dim, device, dtype)
        if tokenizer not in TOKENIZERS:
            raise ValueError(f"unrecognized tokenizer {tokenizer!r}")
        self.embed = nn.Embedding(n_bins, dim, device=device, dtype=dtype)
        self.tokenizer = TOKENIZERS[tokenizer](n_bins, pad_idx=pad_idx)

    def tokenize(self, x: tp.List[tp.Optional[str]]):
        return self.tokenizer(x)

    def forward(self, inputs) -> ConditionType:
        tokens, mask = self._to_device(inputs)
        return self._masked(self.output_proj(self.embed(tokens)), mask)


class T5Conditioner(BaseConditioner):
    """T5-encoder text conditioner. `config` overrides the named preset
    (small encoders for tests). With `finetune=False` the encoder runs under
    `torch.no_grad()` and its weights do not require grad, so no optimizer
    takes them (the JAX package's `stop_gradient`); the output projection
    trains either way."""
    N_BINS = 32128

    def __init__(self, model_name: str = "t5-base", output_dim: int = 1024,
                 config: tp.Optional[T5EncoderConfig] = None,
                 finetune: bool = False, device=None, dtype=None):
        cfg = config or T5EncoderConfig.for_model(model_name)
        super().__init__(cfg.d_model, output_dim, device, dtype)
        self.t5 = T5Encoder(cfg, device=device, dtype=dtype)
        self.finetune = finetune
        self.t5.requires_grad_(finetune)

    def tokenize(self, x: tp.List[tp.Optional[str]]):
        return WhiteSpaceTokenizer(n_bins=self.N_BINS)(
            [xi if xi else None for xi in x])

    def forward(self, inputs) -> ConditionType:
        tokens, mask = self._to_device(inputs)
        with torch.set_grad_enabled(self.finetune and torch.is_grad_enabled()):
            embeds = self.t5(tokens, mask)
        return self._masked(self.output_proj(embeds), mask)


def dropout_condition(sample: ConditioningAttributes, condition_type: str,
                      condition: str) -> ConditioningAttributes:
    """Null one attribute of `sample` in place: a text becomes None. A
    waveform condition can only be dropped while it is None (waveform
    conditioning is not ported)."""
    if condition_type not in ("text", "wav"):
        raise ValueError(f"unexpected condition type: {condition_type}")
    attributes = getattr(sample, condition_type)
    if condition not in attributes:
        raise ValueError(f"unexpected condition {condition}.{condition_type}")
    if condition_type == "wav" and attributes[condition] is not None:
        raise NotImplementedError("waveform conditions are not ported "
                                  "(ROADMAP, slice C)")
    attributes[condition] = None
    return sample


class AttributeDropout:
    """Independent dropout per attribute: `p` maps a condition type to
    {condition: probability}; each listed condition is dropped from the whole
    batch with its probability (one host draw each, numpy RNG). Inactive in
    eval mode (`training = False`)."""

    def __init__(self, p: tp.Dict[str, tp.Dict[str, float]], seed: int = 1234):
        self.p = {kind: dict(probs) for kind, probs in p.items()}
        self.rng = np.random.RandomState(seed)
        self.training = True

    def __call__(self, samples: tp.List[ConditioningAttributes]
                 ) -> tp.List[ConditioningAttributes]:
        if not self.training:
            return samples
        samples = deepcopy(samples)
        for kind, probs in self.p.items():
            for condition, p in probs.items():
                if self.rng.rand() < p:
                    for sample in samples:
                        dropout_condition(sample, kind, condition)
        return samples


class ClassifierFreeGuidanceDropout:
    """All-or-nothing condition dropout; p=1 gives the null conditions."""

    def __init__(self, p: float, seed: int = 1234):
        self.p = p
        self.rng = np.random.RandomState(seed)
        self.training = True

    def __call__(self, samples: tp.List[ConditioningAttributes]
                 ) -> tp.List[ConditioningAttributes]:
        if not self.training and self.p < 1.0:
            return samples
        if not self.rng.rand() < self.p:
            return samples
        samples = deepcopy(samples)
        for sample in samples:
            for kind in ("wav", "text"):
                for condition in list(getattr(sample, kind)):
                    dropout_condition(sample, kind, condition)
        return samples


class ConditioningProvider(nn.Module):
    """Aggregates conditioners: host `tokenize` + device `forward`."""

    def __init__(self, conditioners: tp.Dict[str, BaseConditioner]):
        super().__init__()
        self.conditioners = nn.ModuleDict(conditioners)

    @property
    def text_conditions(self):
        return list(self.conditioners.keys())

    def tokenize(self, inputs: tp.List[ConditioningAttributes]
                 ) -> tp.Dict[str, tp.Any]:
        assert all(isinstance(x, ConditioningAttributes) for x in inputs)
        text = defaultdict(list)
        for sample in inputs:
            for condition in self.text_conditions:
                text[condition].append(sample.text.get(condition))
        return {name: self.conditioners[name].tokenize(batch)
                for name, batch in text.items()}

    def forward(self, tokenized: tp.Dict[str, tp.Any]
                ) -> tp.Dict[str, ConditionType]:
        return {name: self.conditioners[name](inputs)
                for name, inputs in tokenized.items()}


class ConditionFuser:
    """Routes conditions into the model; this slice fuses by cross-attention
    only (a condition routed elsewhere raises)."""
    FUSING_METHODS = ["sum", "prepend", "cross", "ignore", "input_interpolate"]

    def __init__(self, fuse2cond: tp.Dict[str, tp.List[str]]):
        assert all(k in self.FUSING_METHODS for k in fuse2cond), \
            f"Got invalid fuse method, allowed methods: {self.FUSING_METHODS}"
        self.fuse2cond = {k: list(v) for k, v in fuse2cond.items()}
        self.cond2fuse = {c: m for m, conds in fuse2cond.items() for c in conds}
        unported = {c: m for c, m in self.cond2fuse.items()
                    if m not in ("cross", "ignore")}
        if unported:
            raise NotImplementedError(f"fusing {unported} is not ported")

    def cross_source(self, conditions: tp.Dict[str, ConditionType]
                     ) -> tp.Optional[torch.Tensor]:
        """The cross-attention source: the cross conditions concatenated on
        time, or None."""
        assert set(conditions).issubset(self.cond2fuse), \
            (f"given conditions contain unknown attributes for fuser, "
             f"expected {self.cond2fuse.keys()}, got {conditions.keys()}")
        conds = [cond for name, (cond, _) in conditions.items()
                 if self.cond2fuse[name] == "cross"]
        return torch.cat(conds, dim=1) if conds else None

    def __call__(self, input: torch.Tensor,
                 conditions: tp.Dict[str, ConditionType]
                 ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        cross = self.cross_source(conditions)
        return input, None if cross is None else cross.to(input.dtype)

"""Conditioning: attributes, tokenizers, text and waveform conditioners,
the provider, the fuser, and the classifier-free-guidance and attribute
dropouts (counterpart of `audiocraft_tpu/modules/conditioners.py`).

Tokenizing is host-side for text; waveform conditions stay torch tensors on
the device they arrive on (the stem separator runs there at tokenize
time). `ConditioningProvider.forward` returns `(embedding [B, T, D], mask
[B, T])` per attribute, text attributes first, then waveforms. The T5
conditioner tokenizes with the hash-trick whitespace tokenizer, as the JAX
package does when no sentencepiece vocabulary is on disk. The melody
conditioner's embedding cache (`cache_path`) is not ported (ROADMAP, slice
H).
"""
import dataclasses
import math
import re
import typing as tp
from collections import defaultdict
from copy import deepcopy

import numpy as np
import torch
import torch.nn as nn

from ..utils.utils import hash_trick, length_to_mask
from .chroma import ChromaExtractor
from .t5 import T5Encoder, T5EncoderConfig

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]


class WavCondition(tp.NamedTuple):
    """A waveform condition: wav [B, C, T] (f32, on any device), its valid
    lengths [B], and per row the sample rate, source path and seek time."""
    wav: torch.Tensor
    length: torch.Tensor
    sample_rate: tp.List[int]
    path: tp.List[tp.Optional[str]] = []
    seek_time: tp.List[tp.Optional[float]] = []


class JointEmbedCondition(tp.NamedTuple):
    """A joint text-audio condition (CLAP): wav [B, C, T] (f32, any device;
    embedded on the host side of the conditioner), a text per row, the
    valid lengths [B], and per row the sample rate, source path and seek
    time."""
    wav: torch.Tensor
    text: tp.List[tp.Optional[str]]
    length: torch.Tensor
    sample_rate: tp.List[int]
    path: tp.List[tp.Optional[str]] = []
    seek_time: tp.List[tp.Optional[float]] = []


class SymbolicCondition(tp.NamedTuple):
    """A symbolic condition (JASCO): per-frame chord indices [T], or a
    melody salience matrix [n_classes, T]."""
    frame_chords: tp.Optional[np.ndarray] = None
    melody: tp.Optional[np.ndarray] = None


@dataclasses.dataclass
class ConditioningAttributes:
    """Per-sample conditions: texts, waveforms (`WavCondition`, or None
    where a dataset has no waveform for the attribute), joint text-audio
    conditions and symbolic conditions."""
    text: tp.Dict[str, tp.Optional[str]] = dataclasses.field(default_factory=dict)
    wav: tp.Dict[str, tp.Optional[WavCondition]] = dataclasses.field(
        default_factory=dict)
    joint_embed: tp.Dict[str, JointEmbedCondition] = dataclasses.field(
        default_factory=dict)
    symbolic: tp.Dict[str, SymbolicCondition] = dataclasses.field(
        default_factory=dict)


def nullify_wav(cond: WavCondition) -> WavCondition:
    """The null waveform condition: one zero sample per row, length 0."""
    B = cond.wav.shape[0]
    return WavCondition(wav=torch.zeros_like(cond.wav[..., :1]),
                        length=torch.zeros(B, dtype=torch.long),
                        sample_rate=list(cond.sample_rate), path=[None] * B,
                        seek_time=[None] * B)


def nullify_joint_embed(embed: JointEmbedCondition) -> JointEmbedCondition:
    """The null joint condition: one zero sample per row, no text, length
    0, seek time 0."""
    wav = torch.as_tensor(embed.wav)
    B = wav.shape[0]
    return JointEmbedCondition(
        wav=torch.zeros_like(wav[..., :1]), text=[None] * len(embed.text),
        length=torch.zeros(B, dtype=torch.long),
        sample_rate=list(embed.sample_rate), path=[None] * B,
        seek_time=[0] * B)


def nullify_chords(sym_cond: SymbolicCondition,
                   null_chord_idx: int = 194) -> SymbolicCondition:
    """Every frame the null chord."""
    return SymbolicCondition(frame_chords=np.full_like(
        np.asarray(sym_cond.frame_chords), null_chord_idx))


def nullify_melody(sym_cond: SymbolicCondition) -> SymbolicCondition:
    """An all-zero salience matrix."""
    return SymbolicCondition(melody=np.zeros_like(np.asarray(sym_cond.melody)))


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


class TextConditioner(BaseConditioner):
    """A conditioner of text attributes."""


class LUTConditioner(TextConditioner):
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


class T5Conditioner(TextConditioner):
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




class WaveformConditioner(BaseConditioner):
    """A conditioner of waveform attributes: `tokenize` takes the collated
    `WavCondition` of the batch."""

    def tokenize(self, x: WavCondition):
        return x


class StemSeparated:
    """A waveform conditioner that reads stems of an HTDemucs separator:
    the one set by `set_separator`, else the checkpoint that
    `modules.demucs.get_stem_separator` finds, else none. The separator
    sits outside the module tree: its weights are not the conditioner's,
    and it is not moved with it."""

    def set_separator(self, separator) -> None:
        """Use `separator` (an HTDemucs), or with None the checkpoint
        `get_stem_separator` finds."""
        self.__dict__["separator"] = separator

    def _separator(self):
        if self.__dict__.get("separator") is not None:
            return self.__dict__["separator"]
        from .demucs import get_stem_separator
        return get_stem_separator(self.output_proj.weight.device)


class ChromaStemConditioner(StemSeparated, WaveformConditioner):
    """Melody conditioning: the chroma of the melodic stems of a waveform
    (one-hot per frame), projected to `output_dim`; rows of length 0 (the
    null condition) give zeros and a zero mask.

    The stems (vocals + other) come from an HTDemucs separator at tokenize
    time: the one set by `set_separator`, else the checkpoint that
    `modules.demucs.get_stem_separator` finds; without either the chroma
    is the full mix's, as in the JAX package. With `match_len_on_eval` the
    chroma is tiled or cut to `chroma_len`, the frames of `duration`
    seconds. A null waveform (one sample) gives one zero frame."""

    def __init__(self, output_dim: int, sample_rate: int = 32000,
                 n_chroma: int = 12, radix2_exp: int = 12,
                 duration: float = 30.0, match_len_on_eval: bool = True,
                 eval_wavs: tp.Optional[str] = None, n_eval_wavs: int = 0,
                 cache_path: tp.Optional[str] = None,
                 dim: tp.Optional[int] = None, device=None, dtype=None):
        if dim is not None and dim != n_chroma:
            raise ValueError(f"the chroma conditioner's input is its "
                             f"{n_chroma} classes, got dim={dim}")
        if cache_path is not None:
            raise NotImplementedError("the chroma embedding cache (cache_path) "
                                      "is not ported (ROADMAP, slice H)")
        if eval_wavs is not None:
            raise NotImplementedError("eval_wavs is not ported")
        super().__init__(n_chroma, output_dim, device, dtype)
        self.sample_rate = sample_rate
        self.n_chroma = n_chroma
        self.radix2_exp = radix2_exp
        self.duration = duration
        self.match_len_on_eval = match_len_on_eval
        self.chroma = ChromaExtractor(sample_rate, n_chroma, radix2_exp,
                                      argmax=True, device=device)
        self.set_separator(None)

    @property
    def winhop(self) -> int:
        return self.chroma.winhop

    @property
    def chroma_len(self) -> int:
        """Chroma frames of `duration` seconds (centre-padded STFT)."""
        return 1 + int(self.sample_rate * self.duration) // self.winhop

    def tokenize(self, x: WavCondition):
        """With a separator, the chroma of each live row's melodic stems
        ({'chroma': [B, frames, n_chroma], 'length': [B]}); else `x`."""
        if x.wav.shape[-1] > 1:
            separator = self._separator()
            if separator is not None:
                return self._tokenize_separated(x, separator)
        return x

    def _tokenize_separated(self, x: WavCondition, separator) -> dict:
        """Rows sharing a sample rate go through the separator together;
        each row's chroma is cut or zero-padded to the frames of the
        batch's duration; null rows stay zero."""
        from ..data.audio_utils import convert_audio
        from .demucs import separate_melody
        device = self.output_proj.weight.device

        def row_sr(i):
            return (x.sample_rate[i] if i < len(x.sample_rate)
                    and x.sample_rate[i] else self.sample_rate)

        n_frames = 1 + int(x.wav.shape[-1] * self.sample_rate
                           / row_sr(0)) // self.winhop
        B = x.wav.shape[0]
        out = torch.zeros(B, n_frames, self.n_chroma, device=device)
        by_sr: tp.Dict[int, tp.List[int]] = {}
        for i in range(B):
            if int(x.length[i]) > 1:
                by_sr.setdefault(int(row_sr(i)), []).append(i)
        for sr, rows in by_sr.items():
            wavs = x.wav[torch.as_tensor(rows, device=x.wav.device)].float()
            mel = separate_melody(separator, wavs, sr).to(device)
            if sr != self.sample_rate:
                mel = convert_audio(mel, sr, self.sample_rate, 1)
            chroma = self.chroma(mel)[:, :n_frames]
            out[torch.as_tensor(rows, device=device), :chroma.shape[1]] = chroma
        return {"chroma": out, "length": x.length}

    def _match_len(self, chroma: torch.Tensor) -> torch.Tensor:
        """Tile or cut [B, T, n_chroma] to `chroma_len` frames."""
        target = self.chroma_len
        T = chroma.shape[1]
        if T < target:
            chroma = chroma.repeat(1, int(math.ceil(target / T)), 1)
        return chroma[:, :target]

    def _get_wav_embedding(self, x: WavCondition) -> torch.Tensor:
        device = self.output_proj.weight.device
        wav = x.wav.to(device).float()
        if wav.shape[-1] == 1:
            return torch.zeros(wav.shape[0], 1, self.n_chroma, device=device)
        chroma = self.chroma(wav)
        return self._match_len(chroma) if self.match_len_on_eval else chroma

    def forward(self, x) -> ConditionType:
        device = self.output_proj.weight.device
        if isinstance(x, dict):
            chroma = x["chroma"].to(device)
            if self.match_len_on_eval:
                chroma = self._match_len(chroma)
            lengths = x["length"]
        else:
            chroma = self._get_wav_embedding(x)
            lengths = x.length
        embeds = self.output_proj(chroma.to(self.output_proj.weight.dtype))
        valid = torch.as_tensor(lengths).reshape(-1, 1).to(device) > 0
        mask = valid.expand(embeds.shape[:2]).to(torch.int32)
        return self._masked(embeds, mask)


class FeatureExtractor(WaveformConditioner):
    """The style feature extractor: an excerpt of `length` seconds of each
    waveform (zero-padded when shorter) is encoded by a frozen feature
    model, and the features are embedded to `dim`: EnCodec codes
    (`model_name='encodec'`) through one embedding table per stream,
    summed; MERT hidden states (`'mert'`, after a resample to MERT's 24 kHz
    mono) through a Linear `embed`.

    The frozen model sits outside the module tree (it is not the
    conditioner's weights, and it is not moved with it): a codec bound by
    `bind_feat_extractor`, or for MERT the one bound there, else the local
    checkpoint `modules.mert.get_mert` finds. The excerpt's start is drawn
    from the conditioner's own CPU generator (`set_seed`), once per batch;
    the JAX package draws it from an unseeded numpy RandomState, so the two
    agree only for a waveform no longer than the excerpt or with
    `use_middle_of_segment`. A row is valid when its length exceeds one
    sample; invalid rows (the null condition) are multiplied by 0."""

    def __init__(self, output_dim: int, model_name: str = "encodec",
                 sample_rate: int = 32000, encodec_n_q: int = 4,
                 length: float = 3.0, dim: int = 512,
                 compute_mask: bool = True,
                 use_middle_of_segment: bool = False,
                 ds_rate_compression: int = 640, num_codebooks_lm: int = 4,
                 feat_cardinality: int = 2048, mert_hidden: int = 768,
                 seed: int = 0, device=None, dtype=None):
        if model_name not in ("encodec", "mert"):
            raise ValueError(f"unknown feature model {model_name!r}")
        super().__init__(dim, output_dim, device, dtype)
        self.model_name = model_name
        self.sample_rate = sample_rate
        self.encodec_n_q = encodec_n_q
        self.encodec_n_q_used = encodec_n_q
        self.length = length
        self.dim = dim
        self.compute_mask = compute_mask
        self.use_middle_of_segment = use_middle_of_segment
        self.ds_rate_compression = ds_rate_compression
        self.num_codebooks_lm = num_codebooks_lm
        if model_name == "mert":
            self.embed = nn.Linear(mert_hidden, dim, device=device, dtype=dtype)
        else:
            self.embed = nn.ModuleList([
                nn.Embedding(feat_cardinality, dim, device=device, dtype=dtype)
                for _ in range(encodec_n_q)])
        self.__dict__["feat_extractor"] = None
        self.generator = torch.Generator().manual_seed(seed)

    def set_seed(self, seed: int) -> None:
        """Reseed the generator of the excerpts' starts."""
        self.generator.manual_seed(seed)

    def _excerpt(self, wav: torch.Tensor) -> torch.Tensor:
        length = int(self.length * self.sample_rate)
        T = wav.shape[-1]
        if T <= length:
            return torch.nn.functional.pad(wav, (0, length - T))
        if self.use_middle_of_segment:
            start = (T - length) // 2
        else:
            start = int(torch.randint(0, T - length, (1,),
                                      generator=self.generator))
        return wav[..., start:start + length]

    def _mert(self):
        if self.feat_extractor is not None:
            return self.feat_extractor
        from .mert import get_mert
        mert = get_mert(self.output_proj.weight.device)
        if mert is None:
            raise FileNotFoundError(
                "the style conditioner's 'mert' features need a local MERT "
                "checkpoint: set $MERT_CHECKPOINT or put the "
                "m-a-p/MERT-v1-95M snapshot under $AUDIOCRAFT_CACHE_DIR/mert, "
                "or bind a model with bind_feat_extractor")
        return mert

    @torch.no_grad()
    def tokenize(self, x: WavCondition) -> dict:
        """The excerpt's features on the conditioner's device ({'codes':
        [B, n_q, frames]} or {'mert': [B, frames, hidden]}) and
        {'valid': [B, 1]}. An all-null batch (one sample) skips the model."""
        device = self.output_proj.weight.device
        valid = (torch.as_tensor(x.length).reshape(-1, 1) > 1).to(
            device=device, dtype=torch.float32)
        wav = x.wav.to(device).float()
        B = wav.shape[0]
        if self.model_name == "mert":
            mert = self._mert()
            if wav.shape[-1] <= 1:
                return {"mert": torch.zeros(B, 1, mert.hidden, device=device),
                        "valid": valid}
            from ..data.audio_utils import convert_audio
            sr = (x.sample_rate[0] if x.sample_rate and x.sample_rate[0]
                  else self.sample_rate)
            wav = convert_audio(self._excerpt(wav), sr, mert.sample_rate, 1)
            param = next(mert.parameters())
            feats = mert(wav[:, 0].to(param.device, param.dtype))
            return {"mert": feats.float().to(device), "valid": valid}
        codec = self.feat_extractor
        assert codec is not None, \
            "bind a codec first: bind_feat_extractor(conditioner, codec)"
        if wav.shape[-1] <= 1:
            return {"codes": torch.zeros(B, self.encodec_n_q, 1,
                                         dtype=torch.long, device=device),
                    "valid": valid}
        codes, _ = codec.encode(self._excerpt(wav), device=device)
        return {"codes": codes[:, :self.encodec_n_q_used], "valid": valid}

    def _feat_embeds(self, tokenized: dict) -> torch.Tensor:
        """[B, frames, dim]; codes use the first n_q stream tables."""
        if "mert" in tokenized:
            return self.embed(tokenized["mert"].to(self.embed.weight.dtype))
        codes = tokenized["codes"]
        return sum(self.embed[k](codes[:, k]) for k in range(codes.shape[1]))

    @staticmethod
    def _valid(embeds: torch.Tensor, tokenized: dict) -> ConditionType:
        valid = tokenized["valid"].to(embeds.dtype)              # [B, 1]
        mask = valid.expand(embeds.shape[:2])
        return embeds * valid[..., None], mask

    def forward(self, tokenized: dict) -> ConditionType:
        return self._valid(self._feat_embeds(tokenized), tokenized)


class StyleConditioner(FeatureExtractor):
    """MusicGen-Style's conditioner: feature extractor -> non-causal
    transformer (`transformer_scale`) -> affine-free batch norm with its
    running statistics -> RVQ bottleneck through its first `eval_q` streams
    -> every `ds_factor`-th step -> output projection. Weights keep
    upstream's names (`embed`, `transformer.layers.{i}...`,
    `batch_norm.running_mean`, `rvq.vq.layers.{q}._codebook.embed`,
    `output_proj`).

    In training mode (`style.train()`, called directly: a solver runs the
    provider's conditioners in eval mode, as the JAX package does) the batch
    norm normalises by the batch's statistics (f32, biased variance) and
    updates its running ones (momentum 0.1, unbiased variance), and the RVQ
    runs its training forward over a random number of streams in
    [1, n_q_out] (`q_dropout`; `n_q` fixes it), updating its codebooks by
    EMA with dead codes below `rvq_threshold_ema_dead_code` replaced by
    rows of the batch. Both draws come from the conditioner's generator
    (`set_seed`); the JAX package passes a fixed key to every training
    call, so it draws the same at each step."""
    TR_ARGS = {
        "xsmall": {"d_model": 256, "num_heads": 8, "num_layers": 4},
        "large": {"d_model": 1024, "num_heads": 16, "num_layers": 24},
        "default": {"d_model": 512, "num_heads": 8, "num_layers": 8},
        "none": {"d_model": 512},
    }

    def __init__(self, output_dim: int, transformer_scale: str = "default",
                 ds_factor: int = 15, encodec_n_q: int = 4, n_q_out: int = 6,
                 eval_q: int = 3, q_dropout: bool = True, bins: int = 1024,
                 varying_lengths: tp.Sequence[float] = (1.5, 4.5),
                 batch_norm: bool = True,
                 rvq_threshold_ema_dead_code: float = 0.1,
                 dim: tp.Optional[int] = None, device=None, dtype=None,
                 **kwargs):
        from ..modules.transformer import StreamingTransformer
        from ..quantization import ResidualVectorQuantizer
        tr_args = dict(self.TR_ARGS[transformer_scale])
        d_model = tr_args["d_model"]
        if dim is not None and dim != d_model:
            raise ValueError(f"the '{transformer_scale}' style transformer is "
                             f"{d_model} wide, got dim={dim}")
        super().__init__(output_dim, dim=d_model, encodec_n_q=encodec_n_q,
                         device=device, dtype=dtype, **kwargs)
        self.ds_factor = ds_factor
        self.n_q_out = n_q_out
        self.eval_q = eval_q
        self.transformer = None
        if transformer_scale != "none":
            self.transformer = StreamingTransformer(
                dim_feedforward=4 * d_model, activation="gelu",
                norm_first=True, causal=False, bias_ff=False, bias_attn=False,
                device=device, dtype=dtype, **tr_args)
        self.batch_norm = (nn.BatchNorm1d(d_model, affine=False, device=device)
                           if batch_norm else None)
        self.rvq = None
        if n_q_out > 0:
            self.rvq = ResidualVectorQuantizer(
                d_model, n_q_out, bins, q_dropout=q_dropout,
                threshold_ema_dead_code=rvq_threshold_ema_dead_code,
                device=device)
            with torch.no_grad():   # kaiming-uniform codebooks, as at init
                bound = (6.0 / d_model) ** 0.5
                for layer in self.rvq.vq.layers:
                    layer._codebook.embed.uniform_(-bound, bound)
                    layer._codebook.embed_avg.copy_(layer._codebook.embed)

    def forward(self, tokenized: dict,
                n_q: tp.Optional[int] = None) -> ConditionType:
        z = self._feat_embeds(tokenized)                         # [B, T, dim]
        if self.transformer is not None:
            z = self.transformer(z)
        if self.batch_norm is not None:
            z = self._normalize(z)
        if self.rvq is not None and self.training:
            self.rvq.set_num_codebooks(self.n_q_out)
            z = self.rvq(z.transpose(1, 2), frame_rate=1, n_q=n_q,
                         generator=self.generator).x.transpose(1, 2)
        elif self.rvq is not None:
            self.rvq.set_num_codebooks(self.eval_q)
            codes = self.rvq.encode(z.transpose(1, 2))
            z = self.rvq.decode(codes, dtype=torch.float32).transpose(1, 2)
        z = z[:, ::self.ds_factor].to(self.output_proj.weight.dtype)
        return self._valid(self.output_proj(z), tokenized)


    def _normalize(self, z: torch.Tensor) -> torch.Tensor:
        """The affine-free batch norm over [B, T, dim]: the batch's
        statistics in training, taken in f32 or wider (updating the running
        ones), else the running ones."""
        bn = self.batch_norm
        if not self.training:
            mean, var = bn.running_mean, bn.running_var
        else:
            zf = z.to(torch.promote_types(z.dtype, torch.float32))
            mean = zf.mean(dim=(0, 1))
            var = zf.var(dim=(0, 1), unbiased=False)
            with torch.no_grad():
                n = zf.shape[0] * zf.shape[1]
                unbiased = var * n / max(n - 1, 1)
                bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
                bn.running_var.copy_(0.9 * bn.running_var + 0.1 * unbiased)
                bn.num_batches_tracked += 1
        return (z - mean.to(z.dtype)) / torch.sqrt(var + 1e-5).to(z.dtype)


def set_style_params(conditioner: StyleConditioner, *, eval_q: int = 3,
                     excerpt_length: float = 3.0,
                     ds_factor: tp.Optional[int] = None,
                     encodec_n_q: tp.Optional[int] = None) -> None:
    """The style bottleneck's knobs after construction: the RVQ streams
    used at eval (`eval_q <= n_q_out`), the excerpt's seconds, the
    downsampling, and the codec streams embedded (`encodec_n_q` may only
    shrink: the first tables are used)."""
    assert eval_q <= conditioner.n_q_out
    assert encodec_n_q is None or encodec_n_q <= conditioner.encodec_n_q, \
        "encodec_n_q can only be reduced after init"
    conditioner.eval_q = eval_q
    conditioner.length = excerpt_length
    if ds_factor is not None:
        conditioner.ds_factor = ds_factor
    if encodec_n_q is not None:
        conditioner.encodec_n_q_used = encodec_n_q


def bind_feat_extractor(conditioner: FeatureExtractor, model) -> None:
    """Set the frozen feature model of `conditioner`: a codec for
    'encodec', a `MERTModel` for 'mert'."""
    conditioner.__dict__["feat_extractor"] = model


class JointEmbeddingConditioner(BaseConditioner):
    """A joint text-audio embedding as one condition step: the host side
    (`tokenize`) embeds the text or the waveform into the joint space
    (`_get_embed`, the subclass's); the device side optionally quantizes
    the embedding through an RVQ bottleneck of `n_q` x `bins` (no k-means;
    its codebooks `quantizer.vq.layers.{q}` start kaiming-uniform) and
    projects it to `output_dim`. A row with a zero validity gives zeros and
    a zero mask."""

    def __init__(self, dim: int, output_dim: int, quantize: bool = False,
                 n_q: int = 12, bins: int = 1024, device=None, dtype=None):
        from ..quantization import ResidualVectorQuantizer
        super().__init__(dim, output_dim, device, dtype)
        self.dim = dim
        self.quantize = quantize
        self.quantizer = None
        if quantize:
            self.quantizer = ResidualVectorQuantizer(dim, n_q=n_q, bins=bins,
                                                     kmeans_init=False,
                                                     device=device)
            with torch.no_grad():
                bound = (6.0 / dim) ** 0.5
                for layer in self.quantizer.vq.layers:
                    layer._codebook.embed.uniform_(-bound, bound)
                    layer._codebook.embed_avg.copy_(layer._codebook.embed)

    def _get_embed(self, x: JointEmbedCondition
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(embed [B, dim], valid [B, 1] f32); the subclass's."""
        raise NotImplementedError

    def tokenize(self, x: JointEmbedCondition) -> dict:
        device = self.output_proj.weight.device
        embed, valid = self._get_embed(x)
        assert embed.dim() == 2, embed.shape
        return {"embed": embed.to(device, torch.float32),
                "valid": torch.as_tensor(valid).to(device, torch.float32
                                                   ).reshape(-1, 1)}

    def forward(self, tokenized: dict) -> ConditionType:
        embed = tokenized["embed"]                              # [B, dim]
        if self.quantizer is not None:
            codes = self.quantizer.encode(embed[:, :, None])
            embed = self.quantizer.decode(codes)[:, :, 0]
        out = self.output_proj(embed[:, None, :].to(self.output_proj.weight.dtype))
        valid = tokenized["valid"].to(out.dtype)                 # [B, 1]
        return out * valid[..., None], valid.expand(out.shape[:2])


# CLAP embedders by (checkpoint, device): the towers are heavy and shared
# by every conditioner that names the same checkpoint
_CLAP_EMBEDDERS: tp.Dict[tp.Tuple[str, str], tp.Any] = {}


class CLAPEmbeddingConditioner(JointEmbeddingConditioner):
    """The CLAP joint-embedding conditioner over `modules.clap`. At eval
    (and in training with probability `text_p`) it embeds the text; in
    training otherwise the audio, in windows of `max_audio_length` seconds
    every `audio_stride` seconds, the windows' embeddings averaged. A
    null row (no text at eval, or a waveform of one sample or rate 0) gets
    a zero validity. With `normalize` the embedding is L2-normalised again.

    Training mode here is the host side's (`set_joint_embed_train`, whose
    numpy generator draws the text-or-audio choice), not the module's: the
    JAX package keeps it so, and no solver sets it, so LM training embeds
    the text. The towers sit outside the module tree (not the
    conditioner's weights): the checkpoint of `checkpoint` (a path or
    `//reference/...`), else the one `find_clap_checkpoint` finds, loaded
    on the conditioner's device on the first embed. `model_arch`,
    `sample_rate` and `batch_size` are accepted as the configs give them
    and not used, as in the JAX package: the widths come from the
    checkpoint, and audio is taken to CLAP's 48 kHz from its own rate."""

    def __init__(self, output_dim: int, checkpoint: str = "",
                 model_arch: str = "HTSAT-base", enable_fusion: bool = False,
                 sample_rate: int = 48000, max_audio_length: int = 10,
                 audio_stride: int = 1, dim: int = 512, normalize: bool = True,
                 text_p: float = 0.0, batch_size: tp.Optional[int] = None,
                 quantize: bool = False, n_q: int = 12, bins: int = 1024,
                 device=None, dtype=None):
        assert not enable_fusion, "fusion CLAP variants are not supported"
        super().__init__(dim, output_dim, quantize, n_q, bins, device, dtype)
        self.checkpoint = checkpoint
        self.max_audio_length = max_audio_length
        self.audio_stride = audio_stride
        self.normalize = normalize
        self.text_p = text_p
        self.embed_training = False
        self.host_rng = np.random.RandomState(0)

    def _embedder(self):
        from pathlib import Path

        from ..environment import resolve_reference_path
        from .clap import CLAPEmbedder, find_clap_checkpoint
        path = str(resolve_reference_path(self.checkpoint)) \
            if self.checkpoint else ""
        resolved = Path(path) if path and Path(path).exists() \
            else find_clap_checkpoint()
        if resolved is None:
            raise RuntimeError(
                f"CLAPEmbeddingConditioner: no CLAP checkpoint at "
                f"{self.checkpoint!r} and none found via CLAP_CHECKPOINT / "
                "AUDIOCRAFT_CACHE_DIR (put a laion-CLAP or Hugging Face "
                "ClapModel state dict there).")
        device = self.output_proj.weight.device
        key = (str(resolved), str(device))
        if key not in _CLAP_EMBEDDERS:
            _CLAP_EMBEDDERS[key] = CLAPEmbedder.from_checkpoint(resolved,
                                                                device)
        return _CLAP_EMBEDDERS[key]

    def _get_embed(self, x: JointEmbedCondition
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        emb = self._embedder()
        use_text = (not self.embed_training
                    or float(self.host_rng.uniform()) < self.text_p)
        texts = [t if t is not None else "" for t in x.text]
        B = len(texts)
        valid = torch.ones(B, 1)
        if use_text:
            embed = emb.embed_text(texts)
            for i, t in enumerate(texts):
                if t == "":
                    valid[i] = 0.0
        else:
            wav = torch.as_tensor(x.wav, dtype=torch.float32)   # [B, C, T]
            rates = [int(r) for r in np.asarray(x.sample_rate).reshape(-1)]
            outs: tp.List[tp.Optional[torch.Tensor]] = []
            for i in range(B):
                sr, w = rates[i], wav[i]
                if w.shape[-1] <= 1 or sr <= 0:   # the null condition
                    valid[i] = 0.0
                    outs.append(None)
                    continue
                win = int(self.max_audio_length * sr)
                stride = max(int(self.audio_stride * sr), 1)
                T = w.shape[-1]
                chunks = w[None] if T <= win else torch.stack(
                    [w[:, s:s + win] for s in range(0, T - win + 1, stride)])
                outs.append(emb.embed_audio(chunks, sr).mean(dim=0))
            dim = next((o.shape[-1] for o in outs if o is not None),
                       self.dim or 512)
            embed = torch.stack([o if o is not None else torch.zeros(
                dim, device=emb.device) for o in outs])
        if self.normalize:
            embed = embed / embed.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        return embed, valid


def set_joint_embed_train(conditioner: JointEmbeddingConditioner,
                          training: bool, seed: int = 0) -> None:
    """The host side's training mode of a joint conditioner, and its numpy
    generator of the text-or-audio draws, reseeded with `seed`."""
    conditioner.embed_training = bool(training)
    conditioner.host_rng = np.random.RandomState(seed)


def dropout_condition(sample: ConditioningAttributes, condition_type: str,
                      condition: str) -> ConditioningAttributes:
    """Null one attribute of `sample` in place: a text becomes None, a
    waveform or joint condition its null condition (a missing waveform
    stays None), chords the null chord and a melody zeros."""
    if condition_type not in ("text", "wav", "joint_embed", "symbolic"):
        raise ValueError(f"unexpected condition type: {condition_type}")
    attributes = getattr(sample, condition_type)
    if condition not in attributes:
        raise ValueError(f"unexpected condition {condition}.{condition_type}")
    if condition_type == "text":
        attributes[condition] = None
    elif condition_type == "joint_embed":
        attributes[condition] = nullify_joint_embed(attributes[condition])
    elif condition_type == "symbolic":
        sym = attributes[condition]
        attributes[condition] = (nullify_chords(sym)
                                 if sym.frame_chords is not None
                                 else nullify_melody(sym))
    elif attributes[condition] is not None:
        attributes[condition] = nullify_wav(attributes[condition])
    return sample


class AttributeDropout:
    """Independent dropout per attribute: `p` maps a condition type to
    {condition: probability}; each listed condition is dropped from the whole
    batch with its probability (one host draw each, numpy RNG). Inactive in
    eval mode (`training = False`) unless `active_on_eval`."""

    def __init__(self, p: tp.Dict[str, tp.Dict[str, float]], seed: int = 1234,
                 active_on_eval: bool = False):
        self.p = {kind: dict(probs) for kind, probs in p.items()}
        self.rng = np.random.RandomState(seed)
        self.training = True
        self.active_on_eval = active_on_eval

    def __call__(self, samples: tp.List[ConditioningAttributes]
                 ) -> tp.List[ConditioningAttributes]:
        if not self.training and not self.active_on_eval:
            return samples
        samples = deepcopy(samples)
        for kind, probs in self.p.items():
            for condition, p in probs.items():
                if self.rng.rand() < p:
                    for sample in samples:
                        dropout_condition(sample, kind, condition)
        return samples


class ClassifierFreeGuidanceDropout:
    """All-or-nothing dropout of the conditions of `cond_types`; p=1 gives
    the null conditions. Joint conditions are not among the default types,
    as in the JAX package: the null rows of CFG keep them."""

    def __init__(self, p: float, seed: int = 1234):
        self.p = p
        self.rng = np.random.RandomState(seed)
        self.training = True

    def __call__(self, samples: tp.List[ConditioningAttributes],
                 cond_types: tp.Sequence[str] = ("wav", "text")
                 ) -> tp.List[ConditioningAttributes]:
        if not self.training and self.p < 1.0:
            return samples
        if not self.rng.rand() < self.p:
            return samples
        samples = deepcopy(samples)
        for sample in samples:
            for kind in cond_types:
                for condition in list(getattr(sample, kind)):
                    dropout_condition(sample, kind, condition)
        return samples


def drop_description_condition(conditions: tp.List[ConditioningAttributes]
                               ) -> tp.List[ConditioningAttributes]:
    """The conditions with the description dropped and the waveform kept:
    the middle rows of double CFG."""
    for condition in conditions:
        assert "description" in condition.text and "self_wav" in condition.wav, \
            "double CFG needs a description and a waveform condition 'self_wav'"
    return AttributeDropout(p={"text": {"description": 1.0},
                               "wav": {"self_wav": 0.0}},
                            active_on_eval=True)(conditions)


class ConditioningProvider(nn.Module):
    """Aggregates conditioners: `tokenize` (texts, then waveforms) and the
    device `forward`."""

    def __init__(self, conditioners: tp.Dict[str, BaseConditioner]):
        super().__init__()
        self.conditioners = nn.ModuleDict(conditioners)

    @property
    def text_conditions(self) -> tp.List[str]:
        return [k for k, v in self.conditioners.items()
                if isinstance(v, TextConditioner)]

    @property
    def wav_conditions(self) -> tp.List[str]:
        return [k for k, v in self.conditioners.items()
                if isinstance(v, WaveformConditioner)]

    @property
    def joint_embed_conditions(self) -> tp.List[str]:
        return [k for k, v in self.conditioners.items()
                if isinstance(v, JointEmbeddingConditioner)]

    def tokenize(self, inputs: tp.List[ConditioningAttributes]
                 ) -> tp.Dict[str, tp.Any]:
        assert all(isinstance(x, ConditioningAttributes) for x in inputs)
        text: tp.Dict[str, list] = defaultdict(list)
        for sample in inputs:
            for condition in self.text_conditions:
                text[condition].append(sample.text.get(condition))
        out = {name: self.conditioners[name].tokenize(batch)
               for name, batch in text.items()}
        for name, batch in self._collate_wavs(inputs).items():
            out[name] = self.conditioners[name].tokenize(batch)
        for name, batch in self._collate_joint_embeds(inputs).items():
            out[name] = self.conditioners[name].tokenize(batch)
        return out

    def _collate_joint_embeds(self, samples: tp.List[ConditioningAttributes]
                              ) -> tp.Dict[str, JointEmbedCondition]:
        """Per joint attribute, on the CPU: every sample's wav mixed to mono
        and zero-padded to the longest ([B, 1, T]), with its texts, lengths,
        rates, paths and seek times; a sample without the attribute gives
        the null condition (one zero sample, no text, rate 0)."""
        out: tp.Dict[str, JointEmbedCondition] = {}
        null = JointEmbedCondition(
            wav=torch.zeros(1, 1, 1), text=[None], length=torch.zeros(1),
            sample_rate=[0], path=[None], seek_time=[None])
        for name in self.joint_embed_conditions:
            wavs, texts, lengths, rates, paths, seeks = [], [], [], [], [], []
            for sample in samples:
                cond = sample.joint_embed.get(name, null)
                wav = torch.as_tensor(cond.wav, dtype=torch.float32).cpu()
                wavs.append(wav.mean(dim=1).reshape(-1))
                texts.extend(cond.text)
                lengths.append(torch.as_tensor(cond.length).reshape(-1).cpu())
                rates.extend(cond.sample_rate)
                paths.extend(cond.path)
                seeks.extend(cond.seek_time)
            max_len = max(w.shape[-1] for w in wavs)
            stacked = torch.stack([torch.nn.functional.pad(
                w, (0, max_len - w.shape[-1])) for w in wavs])
            out[name] = JointEmbedCondition(stacked[:, None], texts,
                                            torch.cat(lengths), rates, paths,
                                            seeks)
        return out

    def _collate_wavs(self, samples: tp.List[ConditioningAttributes]
                      ) -> tp.Dict[str, WavCondition]:
        """Per waveform attribute: every sample's wav [1, C, T] mixed to
        mono and zero-padded to the longest, on the conditioner's device,
        with the lengths, rates, paths and seek times."""
        out: tp.Dict[str, WavCondition] = {}
        for name in self.wav_conditions:
            device = self.conditioners[name].output_proj.weight.device
            wavs, lengths, rates, paths, seeks = [], [], [], [], []
            for sample in samples:
                cond = sample.wav[name]
                wav = torch.as_tensor(cond.wav, dtype=torch.float32)
                assert wav.dim() == 3, f"Expecting wav to be [1, C, T], got {wav.shape}"
                assert wav.shape[0] == 1, "Expecting single-item batch"
                wavs.append(wav.to(device).mean(dim=1).reshape(-1))
                lengths.append(torch.as_tensor(cond.length).reshape(-1).cpu())
                rates.extend(cond.sample_rate)
                paths.extend(cond.path)
                seeks.extend(cond.seek_time)
            max_len = max(w.shape[-1] for w in wavs)
            stacked = torch.stack([torch.nn.functional.pad(
                w, (0, max_len - w.shape[-1])) for w in wavs])
            out[name] = WavCondition(stacked[:, None], torch.cat(lengths),
                                     rates, paths, seeks)
        return out

    def forward(self, tokenized: tp.Dict[str, tp.Any]
                ) -> tp.Dict[str, ConditionType]:
        return {name: self.conditioners[name](inputs)
                for name, inputs in tokenized.items()}


class ConditionFuser:
    """Routes each condition into the model: added to the input (`sum`;
    `input_interpolate` after a nearest resample of its time axis), put
    before it (`prepend`, at the first step only, in the order of the
    conditions), concatenated into the cross-attention source (`cross`) or
    dropped (`ignore`)."""
    FUSING_METHODS = ["sum", "prepend", "cross", "ignore", "input_interpolate"]

    def __init__(self, fuse2cond: tp.Dict[str, tp.List[str]]):
        assert all(k in self.FUSING_METHODS for k in fuse2cond), \
            f"Got invalid fuse method, allowed methods: {self.FUSING_METHODS}"
        self.fuse2cond = {k: list(v) for k, v in fuse2cond.items()}
        self.cond2fuse = {c: m for m, conds in fuse2cond.items() for c in conds}

    @property
    def has_prepend(self) -> bool:
        return bool(self.fuse2cond.get("prepend"))

    def _check(self, conditions: tp.Dict[str, ConditionType]) -> None:
        assert set(conditions).issubset(self.cond2fuse), \
            (f"given conditions contain unknown attributes for fuser, "
             f"expected {self.cond2fuse.keys()}, got {conditions.keys()}")

    def prepend_length(self, conditions: tp.Dict[str, ConditionType]) -> int:
        """The steps the prepended conditions put before the input."""
        self._check(conditions)
        return sum(cond.shape[1] for name, (cond, _) in conditions.items()
                   if self.cond2fuse[name] == "prepend")

    def cross_source(self, conditions: tp.Dict[str, ConditionType]
                     ) -> tp.Optional[torch.Tensor]:
        """The cross-attention source: the cross conditions concatenated on
        time, or None."""
        self._check(conditions)
        conds = [cond for name, (cond, _) in conditions.items()
                 if self.cond2fuse[name] == "cross"]
        return torch.cat(conds, dim=1) if conds else None

    def __call__(self, input: torch.Tensor,
                 conditions: tp.Dict[str, ConditionType],
                 first_step: bool = True
                 ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """input [B, T, D] -> (the fused input, the cross source or None)."""
        self._check(conditions)
        for name, (cond, _) in conditions.items():
            op = self.cond2fuse[name]
            cond = cond.to(input.dtype)
            if op == "sum":
                input = input + cond
            elif op == "input_interpolate":
                T_in = input.shape[1]
                idx = torch.arange(T_in, device=cond.device) * cond.shape[1] // T_in
                input = input + cond.index_select(1, idx)
            elif op == "prepend" and first_step:
                input = torch.cat([cond, input], dim=1)
        cross = self.cross_source(conditions)
        return input, None if cross is None else cross.to(input.dtype)

"""JASCO's conditioners: melody salience, chord embeddings and drum latents,
and the provider that pads temporal conditions to the generated length
(counterpart of `audiocraft_tpu/modules/jasco_conditioners.py`).

The drum conditioner separates the drum stem with HTDemucs (the separator
set by `set_separator`, else the checkpoint `modules.demucs.
get_stem_separator` finds; without either the waveform is taken as the
stem, as in the JAX package), encodes it with the frozen codec bound by
`bind_drums_codec`, keeps the coarsest codebook, decodes it back to
latents, and blurs them over `blurring_factor` frames. Each conditioner
keeps upstream's `output_proj` (unused by the chords, as upstream).
"""
import typing as tp
from collections import defaultdict

import torch
import torch.nn as nn

from ..data.audio_utils import convert_audio, convert_audio_channels
from .conditioners import (BaseConditioner, ConditionType, StemSeparated,
                           SymbolicCondition, TextConditioner, WavCondition,
                           WaveformConditioner)


class MelodyConditioner(BaseConditioner):
    """A salience matrix [B, card, T] -> its projection [B, T, out_dim]."""

    def __init__(self, card: int, out_dim: int, device=None, dtype=None):
        super().__init__(card, out_dim, device, dtype)
        self.card = card

    def tokenize(self, x: SymbolicCondition) -> SymbolicCondition:
        return x

    def forward(self, x: SymbolicCondition) -> ConditionType:
        melody = torch.as_tensor(x.melody, dtype=self.output_proj.weight.dtype,
                                 device=self.output_proj.weight.device)
        embeds = self.output_proj(melody.transpose(1, 2))
        return embeds, torch.ones_like(embeds[..., 0])


class ChordsEmbConditioner(BaseConditioner):
    """Chord indices [B, T] -> embeddings [B, T, out_dim] over `card`
    chords and the null chord (index `card`)."""

    def __init__(self, card: int, out_dim: int, device=None, dtype=None):
        super().__init__(out_dim, out_dim, device, dtype)
        self.card = card
        self.emb = nn.Embedding(card + 1, out_dim, device=device, dtype=dtype)

    def tokenize(self, x: SymbolicCondition) -> SymbolicCondition:
        return x

    def forward(self, x: SymbolicCondition) -> ConditionType:
        chords = torch.as_tensor(x.frame_chords, dtype=torch.long,
                                 device=self.emb.weight.device)
        embeds = self.emb(chords)
        return embeds, torch.ones_like(embeds[..., 0])


class DrumsConditioner(StemSeparated, WaveformConditioner):
    """Drum-stem codec latents [B, T, latent_dim], blurred over
    `blurring_factor` frames, projected to `output_dim`; rows of length at
    most one sample (the null condition) give zeros and a zero mask."""

    def __init__(self, output_dim: int, sample_rate: int = 32000,
                 blurring_factor: int = 3,
                 compression_model_latent_dim: int = 128,
                 compression_model_framerate: float = 50,
                 segment_duration: float = 10.0, device=None, dtype=None):
        super().__init__(compression_model_latent_dim, output_dim, device,
                         dtype)
        self.sample_rate = sample_rate
        self.blurring_factor = blurring_factor
        self.compression_model_latent_dim = compression_model_latent_dim
        self.seq_len = int(segment_duration * compression_model_framerate)
        self.set_separator(None)
        self.__dict__["codec"] = None

    def _temporal_blur(self, z: torch.Tensor) -> torch.Tensor:
        """Mean over groups of `blurring_factor` frames, repeated; a partial
        last group is completed with the reversed tail."""
        B, T, C = z.shape
        bf = self.blurring_factor
        if T % bf:
            z = torch.cat([z, z[:, T - (bf - T % bf):].flip(1)], dim=1)
        zb = z.reshape(B, -1, bf, C).mean(dim=2)
        return zb.repeat_interleave(bf, dim=1)[:, :T]

    def _drums_stem(self, wav: torch.Tensor, sample_rate: int) -> torch.Tensor:
        separator = self._separator()
        if separator is None:
            return wav
        from .demucs import separate_stems
        return separate_stems(separator, wav, sample_rate, ("drums",))

    @torch.no_grad()
    def tokenize(self, x):
        """A `WavCondition` -> {'latents': [B, T, latent_dim], 'valid':
        [B, 1]} when a codec is bound; anything else passes through."""
        codec = self.__dict__["codec"]
        if not isinstance(x, WavCondition) or codec is None:
            return x
        device = self.output_proj.weight.device
        wav = torch.as_tensor(x.wav, dtype=torch.float32).to(device)
        B = wav.shape[0]
        valid = (torch.as_tensor(x.length).reshape(-1, 1) > 1).to(
            device=device, dtype=torch.float32)
        if wav.shape[-1] <= 1:
            return {"latents": torch.zeros(
                B, self.seq_len, self.compression_model_latent_dim,
                device=device), "valid": valid}
        rates = [s for s in (x.sample_rate or []) if s]
        if any(s != rates[0] for s in rates):
            raise ValueError(f"all sample rates in a drums batch must be "
                             f"equal, got {rates}")
        sr = rates[0] if rates else self.sample_rate
        drums = self._drums_stem(wav, sr)
        if sr != self.sample_rate or drums.shape[1] != 1:
            drums = convert_audio(drums, sr, self.sample_rate, 1)
        codes, _ = codec.encode(drums, device=device)
        latents = codec.decode_latent(codes[:, :1])     # coarsest codebook
        return {"latents": latents.float(), "valid": valid}

    def forward(self, x) -> ConditionType:
        """x: the dict of `tokenize`, or latents [B, T, latent_dim]."""
        valid = None
        if isinstance(x, dict):
            valid, x = x["valid"], x["latents"]
        if isinstance(x, WavCondition):
            raise RuntimeError(
                "DrumsConditioner got a raw WavCondition: bind the codec "
                "with bind_drums_codec(conditioner, codec) so tokenize() "
                "computes the drum latents, or pass latents")
        weight = self.output_proj.weight
        z = self._temporal_blur(torch.as_tensor(x).to(weight.device,
                                                      weight.dtype))
        embeds = self.output_proj(z)
        mask = torch.ones_like(embeds[..., 0])
        if valid is not None:
            valid = valid.to(embeds.dtype)
            embeds, mask = embeds * valid[..., None], mask * valid
        return embeds, mask


def bind_drums_codec(conditioner: DrumsConditioner, codec) -> DrumsConditioner:
    """Set the frozen compression model the drum latents come from."""
    conditioner.__dict__["codec"] = codec
    return conditioner


class JascoConditioningProvider:
    """Tokenizes JASCO's conditions for `conditioners`: texts; waveforms
    (rows mixed or repeated to the batch's channels, zero-padded to the
    longest, their drum latents cut or zero-padded to `sequence_length`);
    chords padded with the null chord `chords_card`, and melody salience
    with zeros, to `sequence_length` frames."""

    def __init__(self, conditioners: tp.Mapping[str, BaseConditioner],
                 chords_card: int = 194, sequence_length: int = 500,
                 melody_dim: int = 53):
        self.conditioners = conditioners
        self.null_chord = chords_card
        self.sequence_length = sequence_length
        self.melody_dim = melody_dim

    @property
    def text_conditions(self) -> tp.List[str]:
        return [k for k, v in self.conditioners.items()
                if isinstance(v, TextConditioner)]

    def tokenize(self, inputs) -> tp.Dict[str, tp.Any]:
        output: tp.Dict[str, tp.Any] = {}
        text: tp.Dict[str, list] = defaultdict(list)
        for sample in inputs:
            for condition in self.text_conditions:
                text[condition].append(sample.text.get(condition))
        for name, batch in text.items():
            output[name] = self.conditioners[name].tokenize(batch)

        wavs: tp.Dict[str, tp.List[WavCondition]] = defaultdict(list)
        for sample in inputs:
            for name, cond in sample.wav.items():
                if name in self.conditioners:
                    wavs[name].append(cond)
        for name, conds in wavs.items():
            output[name] = self._tokenize_wavs(name, conds)

        symbolic: tp.Dict[str, list] = defaultdict(list)
        for sample in inputs:
            for name, sym in sample.symbolic.items():
                if name in self.conditioners:
                    symbolic[name].append(sym)
        for name, syms in symbolic.items():
            output[name] = self._pad_symbolic(syms)
        return output

    def _tokenize_wavs(self, name: str, conds: tp.List[WavCondition]):
        device = self.conditioners[name].output_proj.weight.device
        T = max(int(c.wav.shape[-1]) for c in conds)
        channels = max(int(c.wav.shape[-2]) for c in conds)
        rows, lengths, rates, paths = [], [], [], []
        for c in conds:
            w = torch.as_tensor(c.wav, dtype=torch.float32).to(device)
            if w.shape[-2] != channels:
                w = convert_audio_channels(w, channels)
            rows.append(torch.nn.functional.pad(w, (0, T - w.shape[-1])))
            lengths.append(int(torch.as_tensor(c.length).reshape(-1)[0]))
            rates.append(c.sample_rate[0] if c.sample_rate else None)
            paths.append(c.path[0] if c.path else None)
        tok = self.conditioners[name].tokenize(WavCondition(
            torch.cat(rows), torch.tensor(lengths), rates, paths))
        if isinstance(tok, dict) and "latents" in tok:
            lat = tok["latents"][:, :self.sequence_length]
            lat = torch.nn.functional.pad(
                lat, (0, 0, 0, self.sequence_length - lat.shape[1]))
            tok = dict(tok, latents=lat)
        return tok

    def _pad_symbolic(self, syms: tp.List[SymbolicCondition]
                      ) -> SymbolicCondition:
        L = self.sequence_length
        if syms[0].frame_chords is not None:
            padded = torch.full((len(syms), L), self.null_chord,
                                dtype=torch.int32)
            for i, s in enumerate(syms):
                c = torch.as_tensor(s.frame_chords).reshape(-1)[:L]
                padded[i, :len(c)] = c
            return SymbolicCondition(frame_chords=padded)
        padded = torch.zeros(len(syms), self.melody_dim, L)
        for i, s in enumerate(syms):
            m = torch.as_tensor(s.melody, dtype=torch.float32)[:, :L]
            padded[i, :, :m.shape[-1]] = m
        return SymbolicCondition(melody=padded)

"""JASCO: text, chords, drums and melody to music by flow matching over
codec latents (counterpart of `audiocraft_tpu/models/jasco.py`).

Chords are (symbol, start second) pairs mapped to indices by the mapping
in `assets/chord_to_index_mapping.pkl`; a missing chord sequence, drum
waveform or melody gives the null condition. The latents are unnormalised
by the codec's latent statistics and decoded by the codec's decoder alone.
"""
import pickle
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..modules.conditioners import (ConditioningAttributes, SymbolicCondition,
                                    WavCondition)
from ..modules.jasco_conditioners import (DrumsConditioner,
                                          JascoConditioningProvider,
                                          bind_drums_codec)
from ..utils.utils import resolve_device
from . import flow_matching as fm
from .encodec import CompressionModel
from .flow_matching import FlowMatchingModel

CHORD_MAPPING_PATH = (Path(__file__).resolve().parents[2] / "assets"
                      / "chord_to_index_mapping.pkl")


class _PlainUnpickler(pickle.Unpickler):
    """Reads pickles of plain containers and scalars only."""

    def find_class(self, module: str, name: str):
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def load_chords_mapping(path: tp.Union[str, Path]) -> tp.Dict[str, int]:
    """The chord symbol -> index mapping pickled at `path`."""
    with open(path, "rb") as f:
        return _PlainUnpickler(f).load()


class JASCO:
    """A flow-matching model and the codec whose latents it generates, on
    one device (CUDA unless `device` names another); the initial noise
    comes from `self.generator`, seeded 0."""

    def __init__(self, name: str, compression_model: CompressionModel,
                 model: FlowMatchingModel,
                 chords_mapping_path: tp.Optional[tp.Union[str, Path]] = None,
                 latent_mean: float = 0.0, latent_std: float = 1.0,
                 max_duration: float = 10.0, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.compression_model = compression_model.to(self.device).eval()
        self.model = model.to(self.device).eval()
        for cond in self.model.conditioners.values():
            if isinstance(cond, DrumsConditioner):
                bind_drums_codec(cond, self.compression_model)
        self.latent_mean = latent_mean
        self.latent_std = latent_std
        self.max_duration = max_duration
        self.duration = max_duration
        self.generation_params: dict = {}
        self.generator = torch.Generator(self.device).manual_seed(0)
        self.chords_mapping = None
        if chords_mapping_path and Path(chords_mapping_path).exists():
            self.chords_mapping = load_chords_mapping(chords_mapping_path)
        self.set_generation_params()

    @property
    def frame_rate(self) -> float:
        return self.compression_model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.compression_model.sample_rate

    def set_generation_params(self, cfg_coef_all: float = 5.0,
                              cfg_coef_txt: float = 0.0, euler: bool = False,
                              euler_steps: int = 50, duration: float = 10.0,
                              **kwargs):
        """CFG weights of the all-conditions and text-only terms, the
        solver (Dormand-Prince, or `euler_steps` Euler steps), the
        duration, and any further `flow_matching.generate` argument."""
        self.duration = duration
        self.generation_params = {
            "cfg_coef_all": cfg_coef_all, "cfg_coef_txt": cfg_coef_txt,
            "euler": euler, "euler_steps": euler_steps, **kwargs}

    @staticmethod
    def get_pretrained(name: str = "facebook/jasco-chords-drums-400M",
                       device=None) -> "JASCO":
        """The `debug` model (tiny, seeded random weights over the debug
        codec) or a local export package (`state_dict.bin` and
        `compression_state_dict.bin`); nothing is downloaded."""
        from . import builders, loaders
        if name == "debug":
            return builders.get_debug_jasco_model(device=device)
        codec = loaders.load_compression_model(name, device=device)
        model, cfg = loaders.load_jasco_model(name, device=device)
        dataset = cfg.get("dataset")
        return JASCO(
            name, codec, model,
            chords_mapping_path=cfg.get("chords_mapping_path",
                                        CHORD_MAPPING_PATH),
            latent_mean=float(cfg.get("compression_model_latent_mean", 0.0)),
            latent_std=float(cfg.get("compression_model_latent_std", 1.0)),
            max_duration=float(dataset.get("segment_duration", 10.0)
                               if isinstance(dataset, dict) else 10.0),
            device=device)

    def _prepare_chords(self, chords: tp.List[tp.Tuple[str, float]],
                        seq_len: int) -> np.ndarray:
        """(symbol, start second) pairs -> per-frame chord indices; frames
        before the first chord and unknown symbols take the null chord."""
        assert self.chords_mapping is not None, \
            "chords mapping file required for symbolic chord conditioning"
        null_idx = len(self.chords_mapping)
        out = np.full((seq_len,), null_idx, np.int32)
        for symbol, start in chords:
            out[int(start * self.frame_rate):] = self.chords_mapping.get(
                symbol, null_idx)
        return out

    def _tokenize(self, conditions: tp.List[ConditioningAttributes]):
        return JascoConditioningProvider(
            self.model.conditioners,
            sequence_length=int(self.duration * self.frame_rate)
        ).tokenize(conditions)

    def _drums_condition(self, drums_wav) -> WavCondition:
        """The drum waveform [C, T] or [1, C, T] cut or zero-padded to the
        duration; none gives the null condition."""
        if drums_wav is None:
            return WavCondition(torch.zeros(1, 1, 1, device=self.device),
                                torch.tensor([0]), [self.sample_rate], [None])
        w = torch.as_tensor(drums_wav, dtype=torch.float32).to(self.device)
        if w.dim() == 2:
            w = w[None]
        expected = int(self.duration * self.sample_rate)
        w = torch.nn.functional.pad(w[..., :expected],
                                    (0, max(expected - w.shape[-1], 0)))
        return WavCondition(w, torch.tensor([w.shape[-1]]),
                            [self.sample_rate], [None])

    @torch.no_grad()
    def generate(self, descriptions: tp.List[str],
                 chords: tp.Optional[tp.List[tp.Tuple[str, float]]] = None,
                 melody_salience_matrix: tp.Optional[np.ndarray] = None,
                 drums_wav=None, progress: bool = False,
                 return_tokens: bool = False):
        """Texts with optional chords, melody salience [53, T] and a drum
        waveform (shared by every text) -> audio [B, C, T] (and the
        latents [B, T', D] with `return_tokens`)."""
        seq_len = int(self.duration * self.frame_rate)
        conditioners = self.model.conditioners
        attributes = []
        for desc in descriptions:
            attrs = ConditioningAttributes(text={"description": desc})
            if "chords" in conditioners:
                frame_chords = (self._prepare_chords(chords, seq_len)
                                if chords is not None else
                                np.full((seq_len,), conditioners["chords"].card,
                                        np.int32))
                attrs.symbolic["chords"] = SymbolicCondition(
                    frame_chords=frame_chords)
            if melody_salience_matrix is not None and "melody" in conditioners:
                attrs.symbolic["melody"] = SymbolicCondition(
                    melody=np.asarray(melody_salience_matrix))
            if "self_wav" in conditioners:
                attrs.wav["self_wav"] = self._drums_condition(drums_wav)
            attributes.append(attrs)
        latents = fm.generate(self.model, self._tokenize,
                              conditions=attributes,
                              num_samples=len(descriptions),
                              max_gen_len=seq_len, generator=self.generator,
                              **self.generation_params)
        latents = latents * self.latent_std + self.latent_mean
        decoder = self.compression_model.decoder
        weight = next(decoder.parameters())
        wav = decoder(latents.transpose(1, 2).to(weight.dtype))
        return (wav, latents) if return_tokens else wav

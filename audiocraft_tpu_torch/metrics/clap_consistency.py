"""CLAP text consistency (counterpart of
`audiocraft_tpu/metrics/clap_consistency.py`): the cosine similarity of
CLAP's audio embedding of the generated audio and its text embedding of the
description, over the port's CLAP towers (`modules/clap.py`)."""
import logging
import typing as tp
from pathlib import Path

import numpy as np

from ..utils.utils import host_f32, no_tf32, resolve_device

logger = logging.getLogger(__name__)


class TextConsistencyMetric:
    """Text consistency between audio and its description."""

    def update(self, audio, text: tp.List[str], sizes, sample_rates):
        raise NotImplementedError()

    def compute(self) -> float:
        raise NotImplementedError()


class CLAPTextConsistencyMetric(TextConsistencyMetric):
    """The mean cosine similarity of CLAP audio and text embeddings.

    Without `embed_audio_fn` / `embed_text_fn`, a `CLAPEmbedder` on `device`
    from `model_path`, else `$CLAP_CHECKPOINT` or the cache dir, with the
    RoBERTa tokenizer files beside it or in `$CLAP_TOKENIZER`. Without a
    checkpoint or without tokenizer files, `embed_audio_fn` is None and the
    metric is unavailable. `model_arch` is read from the checkpoint's
    shapes; fusion models are refused."""

    def __init__(self, model_path: tp.Optional[str] = None,
                 model_arch: str = "HTSAT-tiny", enable_fusion: bool = False,
                 embed_audio_fn: tp.Optional[tp.Callable] = None,
                 embed_text_fn: tp.Optional[tp.Callable] = None, device=None):
        assert not enable_fusion, "fusion CLAP variants are not supported"
        self.embedder = None
        if embed_audio_fn is None:
            self.embedder = self._probe_native_embedder(model_path, device)
            if self.embedder is not None:
                embed_audio_fn, embed_text_fn = (self._embed_audio,
                                                 self._embed_text)
        self.embed_audio_fn = embed_audio_fn
        self.embed_text_fn = embed_text_fn
        self.cosine_sum = 0.0
        self.weight = 0.0
        if embed_audio_fn is None:
            logger.warning(
                "No local CLAP checkpoint (set CLAP_CHECKPOINT or drop "
                "clap.pt in AUDIOCRAFT_CACHE_DIR); pass embed_audio_fn/"
                "embed_text_fn to enable the metric.")

    @staticmethod
    def _probe_native_embedder(model_path: tp.Optional[str], device=None):
        """The `CLAPEmbedder` of a local checkpoint with its tokenizer, or
        None."""
        from ..modules.clap import CLAPEmbedder, find_clap_checkpoint
        ckpt = (Path(model_path) if model_path and Path(model_path).exists()
                else find_clap_checkpoint())
        if ckpt is None:
            return None
        logger.info("CLAP text consistency using checkpoint %s", ckpt)
        emb = CLAPEmbedder.from_checkpoint(ckpt, resolve_device(device))
        if emb.tokenizer is None:
            # both towers are needed: report unavailable up front rather
            # than raise in the first update
            logger.warning(
                "CLAP checkpoint %s found but no RoBERTa tokenizer files "
                "(vocab.json + merges.txt) nearby; text consistency "
                "disabled.", ckpt)
            return None
        return emb

    def _embed_audio(self, wav, sample_rate: int):
        with no_tf32():
            return self.embedder.embed_audio(host_f32(wav), sample_rate)

    def _embed_text(self, texts: tp.List[str]):
        with no_tf32():
            return self.embedder.embed_text(texts)

    def update(self, audio, text: tp.List[str], sizes, sample_rates):
        if self.embed_audio_fn is None or self.embed_text_fn is None:
            raise RuntimeError(
                "CLAPTextConsistencyMetric requires local CLAP embeddings; "
                "pass embed_audio_fn/embed_text_fn.")
        sr = int(np.asarray(sample_rates).reshape(-1)[0])
        a = host_f32(self.embed_audio_fn(audio, sr))
        t = host_f32(self.embed_text_fn(list(text)))
        cos = np.sum(a * t, axis=-1) / (
            np.linalg.norm(a, axis=-1) * np.linalg.norm(t, axis=-1) + 1e-8)
        self.cosine_sum += float(cos.sum())
        self.weight += len(text)

    def compute(self) -> float:
        assert self.weight > 0
        return self.cosine_sum / self.weight

"""Frechet Audio Distance (counterpart of `audiocraft_tpu/metrics/fad.py`).

The distance is taken between Gaussians fitted to embeddings of the
generated and of the reference audio: VGGish's (`metrics/vggish.py`) when a
local checkpoint is found, else a labelled log-mel fallback that supports
relative comparisons only.
"""
import logging
import typing as tp
import warnings
from pathlib import Path

import numpy as np
import torch

from ..ops.stft import mel_spectrogram
from ..utils.utils import host_f32, resolve_device

logger = logging.getLogger(__name__)


def frechet_distance(mu_x: np.ndarray, sigma_x: np.ndarray,
                     mu_y: np.ndarray, sigma_y: np.ndarray,
                     eps: float = 1e-6) -> float:
    """|mu_x - mu_y|^2 + Tr(Sx + Sy - 2 (Sx Sy)^0.5), in float64 on the host.

    With few samples the covariances are rank-deficient and the square root
    of their product is numerically singular: when its reconstruction error
    ||S^2 - P|| / ||P|| is 1e-3 or more (or it is not finite), the product
    is taken again with eps * I added to both covariances. The result is
    clamped at 0."""
    from scipy import linalg
    diff = mu_x - mu_y

    def _sqrtm(prod):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", linalg.LinAlgWarning)
            s = linalg.sqrtm(prod)
        ok = bool(np.all(np.isfinite(s)))
        if ok:
            denom = max(float(np.linalg.norm(prod)), 1e-12)
            ok = float(np.linalg.norm(s @ s - prod)) / denom < 1e-3
        return s, ok

    covmean, ok = _sqrtm(sigma_x @ sigma_y)
    if not ok:
        offset = eps * np.eye(sigma_x.shape[0])
        covmean, _ = _sqrtm((sigma_x + offset) @ (sigma_y + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    fd = float(diff @ diff + np.trace(sigma_x) + np.trace(sigma_y)
               - 2 * np.trace(covmean))
    return max(fd, 0.0)


def logmel_embeddings(wav, sample_rate: int,
                      frame_len: float = 0.96) -> np.ndarray:
    """The fallback embedding: [B, C, T] -> [N, 64], the mean log-mel (64
    bands, n_fft 1024, hop 512) of each whole window of `frame_len`
    seconds, on the CPU."""
    mono = torch.from_numpy(host_f32(wav).mean(axis=1))
    mel = mel_spectrogram(mono, sample_rate, n_fft=1024, hop_length=512,
                          n_mels=64).numpy()
    mel = np.log(mel + 1e-5)                           # [B, 64, F]
    win = max(int(frame_len * sample_rate / 512), 1)
    out = [mel[b, :, s:s + win].mean(axis=-1)
           for b in range(mel.shape[0])
           for s in range(0, mel.shape[-1] - win + 1, win)]
    return np.stack(out) if out else np.zeros((0, 64))


class FrechetAudioDistanceMetric:
    """FAD over the embeddings accumulated by `update`.

    `embed_fn(wav [B, C, T], sample_rate) -> [N, D]`. Without one, VGGish
    on `device` from `model_path`, else `$VGGISH_CHECKPOINT` or the cache
    dir (`embed_kind` 'vggish'); without a checkpoint, the log-mel fallback
    (`embed_kind` 'logmel-fallback'). `bin_path`, `format`, `batch_size`
    and `log_folder` are the upstream TF subprocess's and are not used."""

    def __init__(self, bin_path: tp.Optional[str] = None,
                 model_path: tp.Optional[str] = None,
                 format: str = "wav", batch_size: tp.Optional[int] = None,
                 log_folder: tp.Optional[str] = None,
                 embed_fn: tp.Optional[tp.Callable] = None, device=None):
        self.model_path = model_path
        self.embed_kind = "custom"
        if embed_fn is None:
            from .vggish import (VGGishEmbedder, find_vggish_checkpoint,
                                 load_vggish_params)
            ckpt = (Path(model_path) if model_path and Path(model_path).exists()
                    else find_vggish_checkpoint())
            if ckpt is not None:
                embed_fn = VGGishEmbedder(load_vggish_params(ckpt),
                                          device=resolve_device(device))
                self.embed_kind = "vggish"
                logger.info("FAD using VGGish embeddings from %s", ckpt)
            else:
                embed_fn = logmel_embeddings
                self.embed_kind = "logmel-fallback"
                logger.warning(
                    "No VGGish checkpoint found (set VGGISH_CHECKPOINT or "
                    "drop vggish.pth in AUDIOCRAFT_CACHE_DIR): FAD will use "
                    "the log-mel fallback embedding (relative comparisons "
                    "only, not comparable to published VGGish-FAD numbers).")
        self.embed_fn = embed_fn
        self._pred_embs: tp.List[np.ndarray] = []
        self._ref_embs: tp.List[np.ndarray] = []

    def update(self, preds, targets, sizes, sample_rates, stems=None):
        """Embed each item of preds and targets [B, C, T] (tensors on any
        device, or arrays), cut to its size, as host numpy."""
        sr = int(np.asarray(sample_rates).reshape(-1)[0])
        sizes = np.asarray(sizes).reshape(-1)
        for i in range(preds.shape[0]):
            n = int(sizes[i])
            self._pred_embs.append(self.embed_fn(
                host_f32(preds[i:i + 1, :, :n]), sr))
            self._ref_embs.append(self.embed_fn(
                host_f32(targets[i:i + 1, :, :n]), sr))

    def compute(self) -> float:
        assert self._pred_embs and self._ref_embs, \
            "no embeddings accumulated (empty evaluate shard?)"
        preds = np.concatenate(self._pred_embs)
        refs = np.concatenate(self._ref_embs)
        assert len(preds) > 1 and len(refs) > 1, "need >1 embedding windows"
        return frechet_distance(preds.mean(0), np.cov(preds, rowvar=False),
                                refs.mean(0), np.cov(refs, rowvar=False))

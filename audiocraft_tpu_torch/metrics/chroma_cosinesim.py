"""Chroma cosine similarity between reference and generated audio
(counterpart of `audiocraft_tpu/metrics/chroma_cosinesim.py`)."""
import numpy as np
import torch

from ..data.audio_utils import convert_audio
from ..modules.chroma import ChromaExtractor
from ..utils.utils import resolve_device


class ChromaCosineSimilarityMetric:
    """The cosine similarity of the two waveforms' chromas, frame by frame,
    summed over each item's ceil(size * chroma_rate / rate / winhop) frames
    and averaged over all of them. The chromas run on `device`."""

    def __init__(self, sample_rate: int, n_chroma: int, radix2_exp: int,
                 argmax: bool, eps: float = 1e-8, device=None):
        self.chroma_sample_rate = sample_rate
        self.n_chroma = n_chroma
        self.eps = eps
        self.device = resolve_device(device)
        self.extractor = ChromaExtractor(sample_rate=sample_rate,
                                         n_chroma=n_chroma,
                                         radix2_exp=radix2_exp, argmax=argmax,
                                         device=self.device)
        self.cosine_sum = 0.0
        self.weight = 0.0

    def update(self, preds, targets, sizes, sample_rates):
        if preds.shape[-1] == 0:
            return
        assert preds.shape == targets.shape
        rates = np.asarray(sample_rates).reshape(-1)
        sr = int(rates[0])

        def chroma(wav):
            wav = torch.as_tensor(wav).to(self.device)
            return self.extractor(convert_audio(
                wav, sr, self.chroma_sample_rate, 1))

        gt_chroma, gen_chroma = chroma(targets), chroma(preds)
        chroma_lens = np.ceil(np.asarray(sizes).reshape(-1)
                              * self.chroma_sample_rate / rates
                              / self.extractor.winhop)
        for i in range(gt_chroma.shape[0]):
            L = int(chroma_lens[i])
            a, b = gt_chroma[i, :L], gen_chroma[i, :L]
            cos = (a * b).sum(dim=1) / (a.norm(dim=1) * b.norm(dim=1)
                                        + self.eps)
            self.cosine_sum += float(cos.sum())
            self.weight += L

    def compute(self) -> float:
        assert self.weight > 0, \
            "Unable to compute with total number of comparisons <= 0"
        return self.cosine_sum / self.weight

"""PESQ, the perceptual evaluation of speech quality (counterpart of
`audiocraft_tpu/metrics/pesq.py`), through the `pesq` package where it is
installed; without it `update` raises."""
import logging

import torch

from ..ops.resample import resample_frac
from ..utils.utils import host_f32

logger = logging.getLogger(__name__)

try:
    import pesq as pesq_lib  # type: ignore
    _HAS_PESQ = True
except ImportError:
    pesq_lib = None
    _HAS_PESQ = False


class PesqMetric:
    """The mean PESQ (wide band, 16 kHz) over the items `pesq` accepts."""

    def __init__(self, sample_rate: int):
        self.sr = sample_rate
        self.pesq_sum = 0.0
        self.weight = 0.0
        if not _HAS_PESQ:
            logger.warning("pesq package not installed; PesqMetric disabled.")

    def update(self, preds, targets):
        if not _HAS_PESQ:
            raise RuntimeError("the pesq package is not installed")
        preds, targets = host_f32(preds), host_f32(targets)
        if self.sr != 16000:
            preds = resample_frac(torch.from_numpy(preds), self.sr,
                                  16000).numpy()
            targets = resample_frac(torch.from_numpy(targets), self.sr,
                                    16000).numpy()
        for ii in range(preds.shape[0]):
            try:
                self.pesq_sum += pesq_lib.pesq(16000, targets[ii].reshape(-1),
                                               preds[ii].reshape(-1))
                self.weight += 1
            except Exception:  # pesq refuses silent or too-short signals
                pass

    def compute(self) -> float:
        return self.pesq_sum / max(self.weight, 1.0)

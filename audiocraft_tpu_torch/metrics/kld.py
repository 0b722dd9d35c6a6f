"""KL divergence between classifier label distributions (counterpart of
`audiocraft_tpu/metrics/kld.py`): `KLDivergenceMetric` over a pluggable
classifier, and `PasstKLDivergenceMetric` over PaSST (`metrics/passt.py`)."""
import logging
import typing as tp

import numpy as np

from ..utils.utils import host_f32

logger = logging.getLogger(__name__)


class KLDivergenceMetric:
    """Per-sample KL(p_target || p_pred) and KL(p_pred || p_target) over the
    classifier's probabilities, averaged over the samples."""

    def __init__(self):
        self.kld_pq_sum = 0.0
        self.kld_qp_sum = 0.0
        self.weight = 0.0

    def _get_label_distribution(self, x, sizes, sample_rates
                                ) -> tp.Optional[np.ndarray]:
        """[B, n_classes] probabilities; implemented by subclasses."""
        raise NotImplementedError()

    @staticmethod
    def _kl_divergence(pred_probs: np.ndarray, target_probs: np.ndarray,
                       epsilon: float = 1e-6) -> tp.Tuple[float, float]:
        kl_pq = np.sum(target_probs * (np.log(target_probs + epsilon)
                                       - np.log(pred_probs + epsilon)), axis=-1)
        kl_qp = np.sum(pred_probs * (np.log(pred_probs + epsilon)
                                     - np.log(target_probs + epsilon)), axis=-1)
        return float(kl_pq.sum()), float(kl_qp.sum())

    def update(self, preds, targets, sizes, sample_rates):
        assert preds.shape == targets.shape
        assert preds.shape[0] > 0, "Cannot update the loss with empty tensors"
        preds_probs = self._get_label_distribution(preds, sizes, sample_rates)
        targets_probs = self._get_label_distribution(targets, sizes,
                                                     sample_rates)
        if preds_probs is not None and targets_probs is not None:
            kl_pq, kl_qp = self._kl_divergence(preds_probs, targets_probs)
            self.kld_pq_sum += kl_pq
            self.kld_qp_sum += kl_qp
            self.weight += preds.shape[0]

    def compute(self) -> dict:
        assert self.weight > 0, \
            "Unable to compute with total number of comparisons <= 0"
        kld_pq = self.kld_pq_sum / self.weight
        kld_qp = self.kld_qp_sum / self.weight
        return {"kld": kld_pq, "kld_pq": kld_pq, "kld_qp": kld_qp,
                "kld_both": kld_pq + kld_qp}


class PasstKLDivergenceMetric(KLDivergenceMetric):
    """KLD over PaSST's AudioSet classes. Without `classifier_fn(wav [B, C,
    T], sample_rate) -> [B, n_classes]`, the PaSST classifier on `device`
    from `$PASST_CHECKPOINT` or the cache dir, segmenting at 20 or 30 s when
    `pretrained_length` says so and at 10 s otherwise; `classifier_fn` is
    None when there is no checkpoint."""

    def __init__(self, pretrained_length: tp.Optional[float] = None,
                 classifier_fn: tp.Optional[tp.Callable] = None, device=None):
        super().__init__()
        self.pretrained_length = pretrained_length
        if classifier_fn is None:
            classifier_fn = self._probe_native_classifier(pretrained_length,
                                                          device)
        self.classifier_fn = classifier_fn
        if classifier_fn is None:
            logger.warning(
                "No local PaSST checkpoint (set PASST_CHECKPOINT or drop "
                "passt.pt in AUDIOCRAFT_CACHE_DIR); pass classifier_fn to "
                "enable PasstKLDivergenceMetric.")

    @staticmethod
    def _probe_native_classifier(pretrained_length: tp.Optional[float],
                                 device=None) -> tp.Optional[tp.Callable]:
        from ..utils.utils import resolve_device
        from .passt import (PasstClassifier, find_passt_checkpoint,
                            load_passt_params)
        ckpt = find_passt_checkpoint()
        if ckpt is None:
            return None
        max_duration = (pretrained_length if pretrained_length in (20, 30)
                        else 10.0)
        logger.info("KLD using the PaSST classifier from %s", ckpt)
        return PasstClassifier(load_passt_params(ckpt),
                               max_duration=float(max_duration),
                               device=resolve_device(device))

    def _get_label_distribution(self, x, sizes, sample_rates):
        if self.classifier_fn is None:
            raise RuntimeError(
                "PasstKLDivergenceMetric requires a local PaSST classifier; "
                "pass classifier_fn=... or set PASST_CHECKPOINT.")
        sr = int(np.asarray(sample_rates).reshape(-1)[0])
        x = host_f32(x)
        if sizes is None:
            return np.asarray(self.classifier_fn(x, sr))
        # each item cut to its size: a zero-padded tail would add the
        # probabilities of silence to both distributions
        sizes = np.asarray(sizes).reshape(-1).astype(int)
        return np.stack([np.asarray(self.classifier_fn(
            x[i:i + 1, :, :int(np.clip(sizes[i], 1, x.shape[-1]))], sr))[0]
            for i in range(x.shape[0])])

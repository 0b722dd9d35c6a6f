"""Metrics (counterpart of `audiocraft_tpu/metrics/`): the relative volume
mel distortion of codec evaluation and the watermark localisation mIoU.
The generative metrics are not ported (ROADMAP, slice H)."""
# flake8: noqa
from .miou import calculate_miou
from .rvm import RelativeVolumeMel

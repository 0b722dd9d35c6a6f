"""Metrics (counterpart of `audiocraft_tpu/metrics/`): the relative volume
mel distortion of codec evaluation. The generative metrics are not ported
(ROADMAP, slice H)."""
# flake8: noqa
from .rvm import RelativeVolumeMel

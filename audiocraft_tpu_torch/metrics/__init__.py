"""Metrics (counterpart of `audiocraft_tpu/metrics/`): the generative
metrics of the evaluate stage (FAD over VGGish, KLD over PaSST, CLAP text
consistency, chroma cosine similarity), the codec metrics (relative volume
mel, PESQ, ViSQOL) and the watermark localisation mIoU."""
# flake8: noqa
from .chroma_cosinesim import ChromaCosineSimilarityMetric
from .fad import FrechetAudioDistanceMetric, frechet_distance
from .kld import KLDivergenceMetric, PasstKLDivergenceMetric
from .clap_consistency import CLAPTextConsistencyMetric, TextConsistencyMetric
from .rvm import RelativeVolumeMel
from .miou import calculate_miou
from .pesq import PesqMetric
from .visqol import ViSQOL

from .base import BaseQuantizer, DummyQuantizer, QuantizedResult
from .core_vq import (ResidualVectorQuantization, kmeans, quantize_codes,
                      rvq_decode)
from .vq import ResidualVectorQuantizer

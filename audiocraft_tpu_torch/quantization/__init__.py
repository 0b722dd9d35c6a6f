from .core_vq import ResidualVectorQuantization, quantize_codes, rvq_decode
from .vq import ResidualVectorQuantizer

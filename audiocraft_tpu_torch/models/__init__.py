"""Models: the LM, EnCodec and the MusicGen wrapper."""
from .encodec import CompressionModel, EncodecModel
from .lm import GenParams, LMModel
from .musicgen import MusicGen
